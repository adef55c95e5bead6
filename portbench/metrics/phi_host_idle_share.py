"""The card idle while the host runs φ's own code: the traced slice's idle
gaps named by a ``phi.*``, ``lm.*`` or ``moe.*`` span (the innermost host
range at the gap's middle) over the slice's length (torch.profiler), in
%.  None where the program opens no such spans."""

PREFIXES = ("phi.", "lm.", "moe.")


def read(obs):
    tr = obs["trace"]
    if tr is None or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    named = [(n, s) for n, s in tr["idle_gaps"] if n.startswith(PREFIXES)]
    if not named and not tr.get("phi_device_s"):
        return None
    return 100.0 * sum(s for _, s in named) / tr["window_s"]
