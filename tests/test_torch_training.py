"""Two-sided tests of the port's training path against the reference.

The same numpy-seeded inputs go through ``repro`` (JAX, on the 1-device
smoke mesh where a mesh is needed) and ``repro_torch`` on the CPU: AdamW,
gradient compression (and its all-reduce at 2 gloo ranks), the synthetic
LM batches, checkpoints (either package's on-disk layout), the straggler
monitor and the retry policy, the LM's loss and gradients at the
reference's smoke cuts, ``train_step`` with gradient accumulation, and
``launch/train.py`` end to end.

Tolerances: AdamW 1e-6 (the same float32 operations, summed in another
order for the global norm); loss 1e-5 and gradients rtol 1e-4, atol 1e-6
(float32 products summed in another order by XLA and by torch); params
after train_step 1e-5; int8 payloads and synthetic batches identical.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import LMShape
from repro.data.lm_data import LMDataConfig as RefDataConfig
from repro.data.lm_data import SyntheticLM as RefSyntheticLM
from repro.distributed.sharding import base_rules
from repro.launch.mesh import make_smoke_mesh
from repro.launch.steps import _lm_bundle
from repro.launch.train import smoke_config as ref_smoke_config
from repro.models.transformer import LM as RefLM
from repro.training import compression as ref_comp
from repro.training import optimizer as ref_opt
from repro.training.checkpoint import CheckpointManager as RefCheckpoint
from repro.training.fault_tolerance import RetryPolicy as RefRetry
from repro.training.fault_tolerance import StragglerMonitor as RefStraggler
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.steps import train_step
from repro_torch.launch.train import smoke_config
from repro_torch.models.transformer import (LM, params_from_jax,
                                            params_to_jax_tree)
from repro_torch.training import compression, optimizer
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import RetryPolicy, StragglerMonitor
from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop
from repro_torch.training.tree import flatten_with_paths
from test_torch_distributed import _run_ranks
from test_torch_lm import same_config

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return make_smoke_mesh()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * grad_scale)
              .astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("grad_scale,cfg", [
    (0.01, ref_opt.AdamWConfig(lr=1e-2, warmup_steps=2)),     # no clip
    (100.0, ref_opt.AdamWConfig(grad_clip=1.0)),               # clipped
    (1.0, ref_opt.AdamWConfig(lr=0.1, weight_decay=0.0, b2=0.999,
                              warmup_steps=1)),
])
def test_adamw_matches_reference_over_three_steps(grad_scale, cfg):
    """Params, m and v after each of 3 steps, the global norm and the
    learning rate within 1e-6 of the reference's."""
    params, grads = _opt_inputs(int(grad_scale * 10) + 1, grad_scale)
    port_cfg = optimizer.AdamWConfig(**dataclasses.asdict(cfg))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    ro = ref_opt.init_opt_state(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = optimizer.init_opt_state(tp)
    for g in grads:
        rp, ro, rm = ref_opt.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, ro, rp, cfg)
        tp, to, tm = optimizer.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, to, tp, port_cfg)
        assert int(to["step"]) == int(ro["step"])
        for key in params:
            for got, want in ((tp[key], rp[key]), (to["m"][key], ro["m"][key]),
                              (to["v"][key], ro["v"][key])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(rm[name]),
                                       rtol=1e-6)
    if grad_scale > 10:              # the clip bit: the norm is far past 1
        assert float(tm["grad_norm"]) > 100 * cfg.grad_clip


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 1000])
def test_lr_schedule_and_global_norm_match_reference(step):
    cfg = ref_opt.AdamWConfig()
    got = optimizer.lr_schedule(optimizer.AdamWConfig(),
                                torch.tensor(step, dtype=torch.int32))
    want = ref_opt.lr_schedule(cfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    _, grads = _opt_inputs(step, 3.0)
    tree = {"a": grads[0], "b": {"c": grads[1]["w"]}}
    np.testing.assert_allclose(
        float(optimizer.global_norm(jax.tree.map(torch.from_numpy, tree))),
        float(ref_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


def test_adamw_converges_quadratic():
    cfg = optimizer.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = optimizer.init_opt_state(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        params, opt, _ = optimizer.adamw_update(
            {"x": 2 * (params["x"] - target)}, opt, params, cfg)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_casts_back_to_the_parameter_dtype():
    """A bf16 parameter is updated in float32 and rounded back; its
    moments stay float32."""
    p = {"w": torch.linspace(-1, 1, 16).to(torch.bfloat16)}
    opt = optimizer.init_opt_state(p)
    g = {"w": torch.ones(16, dtype=torch.bfloat16)}
    want = (p["w"].float() - 3e-4 * 2 / 100 * (1.0 + 0.1 * p["w"].float()))
    optimizer.adamw_update(g, opt, p, optimizer.AdamWConfig())
    assert p["w"].dtype == torch.bfloat16
    assert opt["m"]["w"].dtype == torch.float32
    torch.testing.assert_close(p["w"], want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _comp_grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "layer": {"b": (rng.standard_normal(33) * 1e-3)
                      .astype(np.float32),
                      "half": np.full(8, 0.5, np.float32)}}


def test_compress_matches_reference_bytewise():
    """Two rounds with error feedback: the int8 payloads identical (ties
    at .5 round to even on both sides), scales within one float32 ulp, the
    feedback and the decompressed grads within 1e-6."""
    g = _comp_grads(0)
    g["layer"]["half"][:] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127, 63.5,
                                      -127], np.float32)
    r_e = ref_comp.init_error_feedback(jax.tree.map(jnp.asarray, g))
    t_e = compression.init_error_feedback(jax.tree.map(torch.from_numpy, g))
    for rnd in range(2):
        grads = g if rnd == 0 else _comp_grads(1)
        rq, rs, r_e = ref_comp.compress(jax.tree.map(jnp.asarray, grads),
                                        r_e)
        tq, ts, t_e = compression.compress(
            jax.tree.map(torch.from_numpy, grads), t_e)
        flat = flatten_with_paths
        for key, want in flat(_np(rq)).items():
            got = flat(tq)[key]
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
            s_got, s_want = float(flat(ts)[key]), float(flat(_np(rs))[key])
            assert abs(s_got - s_want) <= np.spacing(np.float32(s_want))
            np.testing.assert_allclose(flat(t_e)[key].numpy(),
                                       flat(_np(r_e))[key], rtol=0,
                                       atol=1e-6)
        dq = flat(compression.decompress(tq, ts))
        for key, want in flat(_np(ref_comp.decompress(rq, rs))).items():
            np.testing.assert_allclose(dq[key].numpy(), want, rtol=1e-6,
                                       atol=1e-9)
    assert compression.compression_ratio(jax.tree.map(torch.from_numpy, g)) \
        == ref_comp.compression_ratio(jax.tree.map(jnp.asarray, g))


def test_compressed_psum_matches_reference_at_two_gloo_ranks(tmp_path):
    """compressed_psum over 2 gloo ranks, each with its own grads of one
    common largest |value| (so the ranks share each leaf's scale): every
    rank gets the reference's formula -- the int32 sum of the reference's
    int8 payloads times the scale over 2 -- which is then also the mean of
    the reference's decompressed payloads."""
    rng = np.random.default_rng(5)
    grads = [{"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
             for _ in range(2)]
    for g in grads:                           # one largest |value| a leaf
        g["w"][0, 0], g["b"][0] = 4.0, -3.0
    np.savez(tmp_path / "grads.npz",
             **{f"{r}_{k}": v for r, g in enumerate(grads)
                for k, v in g.items()})
    _run_ranks(tmp_path, 2, """
        import numpy as np
        import torch
        from repro_torch.training.compression import (compressed_psum,
                                                      init_error_feedback)
        data = np.load(out / "grads.npz")
        g = {k: torch.from_numpy(data[f"{rank}_{k}"]) for k in ("w", "b")}
        synced, new_e = compressed_psum(g, init_error_feedback(g))
        np.savez(out / f"rank{rank}.npz",
                 **{k: v.numpy() for k, v in synced.items()},
                 **{"e_" + k: v.numpy() for k, v in new_e.items()})
    """)
    ref = [ref_comp.compress(jax.tree.map(jnp.asarray, g),
                             ref_comp.init_error_feedback(
                                 jax.tree.map(jnp.asarray, g)))
           for g in grads]
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        q, s, e = ref[rank]
        for key in ("w", "b"):
            total = sum(np.asarray(r[0][key], np.int32) for r in ref)
            want = total.astype(np.float32) * np.float32(s[key]) / 2
            np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-7)
            mean = sum(np.asarray(ref_comp.decompress(r[0], r[1])[key])
                       for r in ref) / 2
            np.testing.assert_allclose(got[key], mean, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["e_" + key], np.asarray(e[key]),
                                       rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# synthetic LM data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (512, 16, 8, 0, 1), (128_256, 64, 8, 3, 2), (256, 1, 4, 7, 4),
])
def test_synthetic_lm_batches_are_the_references(vocab, seq, batch, seed,
                                                 shards):
    port = SyntheticLM(LMDataConfig(vocab, seq, batch, seed, shards))
    ref = RefSyntheticLM(RefDataConfig(vocab, seq, batch, seed, shards))
    for step in (0, 1, 17):
        for shard in range(shards):
            got, want = port.batch(step, shard), ref.batch(step, shard)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype == np.int32
                assert got[key].tobytes() == want[key].tobytes()
    got = list(port.batches(2, start=3))
    assert got[1]["tokens"].tobytes() == ref.batch(4)["tokens"].tobytes()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 2, 5).to(torch.bfloat16),
                  "d": torch.randn(3, 4, generator=torch.Generator()
                                   .manual_seed(0))},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = _state()
    ckpt.save(10, state, meta={"arch": "test"})
    like = jax.tree.map(torch.zeros_like, state)
    restored, v = ckpt.restore(like)
    assert v == 10
    for key, t in flatten_with_paths(state).items():
        got = flatten_with_paths(restored)[key]
        assert got.dtype == t.dtype and torch.equal(got, t)
    assert ckpt.meta()["meta"]["arch"] == "test"
    root = json.loads((tmp_path / "manifest.json").read_text())
    assert root == {"latest": 10, "history": [10]}
    assert sorted(np.load(tmp_path / "step_10" / "arrays.npz").files) == \
        ["a", "b/c", "b/d", "step"]


def test_checkpoint_gc_keeps_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for v in (1, 2, 3, 4):
        ckpt.save(v, {"a": torch.zeros(2)})
    assert sorted(ckpt.versions()) == [3, 4]
    assert ckpt.latest_version() == 4
    assert json.loads((tmp_path / "manifest.json").read_text())[
        "history"] == [3, 4]
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore({"other": torch.zeros(2)})


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    """A plain dict tree (a tuple of dicts, bf16, int32 and float32 leaves)
    saved by the reference restores in the port, values and dtypes; and
    the port's checkpoint restores in the reference (float leaves)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    state = ({"w": jnp.asarray(w), "h": jnp.asarray(w, jnp.bfloat16)},
             {"m": {"w": jnp.asarray(w * 2)},
              "step": jnp.asarray(3, jnp.int32)})
    RefCheckpoint(str(tmp_path / "ref")).save(5, state, meta={"by": "ref"})
    like = ({"w": torch.zeros(4, 3), "h": torch.zeros(4, 3,
                                                       dtype=torch.bfloat16)},
            {"m": {"w": torch.zeros(4, 3)},
             "step": torch.zeros((), dtype=torch.int32)})
    ckpt = CheckpointManager(str(tmp_path / "ref"))
    got, v = ckpt.restore(like)
    assert v == 5 and ckpt.meta()["meta"] == {"by": "ref"}
    np.testing.assert_array_equal(got[0]["w"].numpy(), w)
    assert got[0]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got[0]["h"].float().numpy(),
        np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(got[1]["m"]["w"].numpy(), w * 2)
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 3
    # and the other way
    CheckpointManager(str(tmp_path / "port")).save(
        2, {"w": torch.from_numpy(w), "s": torch.tensor(9)})
    back, v = RefCheckpoint(str(tmp_path / "port")).restore(
        {"w": jnp.zeros((4, 3)), "s": jnp.zeros((), jnp.int32)})
    assert v == 2 and int(back["s"]) == 9
    np.testing.assert_array_equal(np.asarray(back["w"]), w)


def _quadratic_loss(p, batch):
    x = batch["tokens"].float()
    return torch.mean((x @ p["w"] - batch["labels"].float()) ** 2)


def test_checkpoint_restart_resumes_training(tmp_path):
    """Kill-and-restart: the restarted loop resumes from the manifest's
    version with the saved params and optimizer state, and ends where an
    uninterrupted run ends."""
    data = SyntheticLM(LMDataConfig(vocab_size=16, seq_len=8, global_batch=4))
    cfg1 = TrainLoopConfig(n_steps=4, ckpt_every=2, log_every=100,
                           ckpt_dir=str(tmp_path / "a"))
    run_train_loop(_quadratic_loss, {"w": torch.zeros(8, 8,
                                                      requires_grad=True)},
                   data.batches(10), cfg1)
    ck = CheckpointManager(str(tmp_path / "a"))
    assert ck.latest_version() == 4
    # "restart": fresh params; the loop resumes at step 4 and runs to 6
    cfg2 = dataclasses.replace(cfg1, n_steps=6)
    resumed = run_train_loop(
        _quadratic_loss, {"w": torch.zeros(8, 8, requires_grad=True)},
        data.batches(2, start=4), cfg2)
    assert ck.latest_version() == 6
    assert resumed["history"][0]["step"] >= 4
    straight = run_train_loop(
        _quadratic_loss, {"w": torch.zeros(8, 8, requires_grad=True)},
        data.batches(6), dataclasses.replace(cfg2, ckpt_dir=None))
    torch.testing.assert_close(resumed["params"]["w"],
                               straight["params"]["w"], rtol=0, atol=0)
    assert int(resumed["opt_state"]["step"]) == 6


def test_elastic_restart_places_the_state_on_a_device_mesh(tmp_path):
    """Restore onto a (data, model) DeviceMesh of one gloo rank, with the
    placements the launch rules give: DTensors holding the saved values."""
    CheckpointManager(str(tmp_path / "ck")).save(
        3, {"w": torch.arange(16.0).reshape(4, 4)})
    _run_ranks(tmp_path, 1, """
        import json
        import torch
        from repro_torch.distributed.sharding import base_rules
        from repro_torch.training.checkpoint import CheckpointManager
        from repro_torch.training.fault_tolerance import elastic_restart
        mesh, rules, state, v = elastic_restart(
            CheckpointManager(str(out / "ck")), {"w": torch.zeros(4, 4)},
            base_rules, {"w": ("batch", None)}, 1, device_type="cpu")
        w = state["w"]
        (out / "elastic.json").write_text(json.dumps({
            "version": v, "kind": type(w).__name__,
            "placements": [repr(p) for p in w.placements],
            "values": w.full_tensor().tolist()}))
    """)
    got = json.loads((tmp_path / "elastic.json").read_text())
    assert got["version"] == 3 and got["kind"] == "DTensor"
    assert got["placements"] == ["Shard(dim=0)", "Replicate()"]   # batch
    assert got["values"] == torch.arange(16.0).reshape(4, 4).tolist()


# ---------------------------------------------------------------------------
# stragglers and retries
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_what_the_reference_flags():
    rng = np.random.default_rng(4)
    port, ref = StragglerMonitor(n_hosts=8), RefStraggler(n_hosts=8)
    for step in range(12):
        times = rng.uniform(0.9, 1.1, 8)
        if step >= 3:
            times[5] = 2.5
        assert port.record(times) == ref.record(times)
        np.testing.assert_array_equal(port.ewma, ref.ewma)
    assert port.record(times) == [5]


def test_retry_policy_restarts():
    for policy in (RetryPolicy, RefRetry):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("node failure")
            return "ok"

        failures = []
        assert policy(max_restarts=5, backoff_s=0.0).run(
            flaky, failures.append) == "ok"
        assert len(failures) == 2
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        RetryPolicy(max_restarts=2, backoff_s=0.0).run(
            lambda: 1 / 0, lambda e: None)


# ---------------------------------------------------------------------------
# the LM: loss, gradients, train_step
# ---------------------------------------------------------------------------

# the reference's smoke cuts (launch/train.py); the MoE archs at capacity
# factor 4.0, where no expert overflows (the reference's overflowing
# dispatch corrupts a slot, ROADMAP Queue C)
SMOKE = {"llama3-8b": {}, "deepseek-moe-16b": dict(capacity_factor=4.0),
         "deepseek-v2-236b": dict(capacity_factor=4.0)}


def _smoke_pair(arch, seed=3, **over):
    over = dict(SMOKE[arch], **over)
    ref = RefLM(dataclasses.replace(ref_smoke_config(arch), **over))
    params = ref.init(jax.random.key(seed))
    port = params_from_jax(LM(dataclasses.replace(smoke_config(arch), **over),
                              device="cpu"), _np(params))
    return ref, params, port


def _tokens(seed, b, s, vocab=512):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def test_smoke_configs_match_the_reference():
    for arch in SMOKE:
        assert same_config(smoke_config(arch), ref_smoke_config(arch))


@pytest.mark.parametrize("arch", list(SMOKE))
def test_loss_and_gradients_match_jax_value_and_grad(arch, mesh):
    """LM.loss_fn and torch autograd against jax.value_and_grad of the
    reference's loss_fn, float32, after params_from_jax: loss, ce and aux
    within 1e-5, every gradient leaf within rtol 1e-4, atol 1e-6, in the
    reference's tree (params_to_jax_tree of the gradients)."""
    ref, params, port = _smoke_pair(arch)
    toks, labs = _tokens(0, 2, 24)
    with jax.set_mesh(mesh):
        (r_loss, r_met), r_grads = jax.value_and_grad(
            ref.loss_fn, has_aux=True)(params, jnp.asarray(toks),
                                       jnp.asarray(labs), base_rules(mesh))
    loss, met = port.loss_fn(torch.from_numpy(toks), torch.from_numpy(labs))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), **LOSS)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(met[key]), float(r_met[key]), **LOSS)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    got = flatten_with_paths(params_to_jax_tree(port, dict(zip(names,
                                                               grads))))
    want = flatten_with_paths(_np(r_grads))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, err_msg=key, **GRAD)


@pytest.mark.parametrize("fused", [False, True])
def test_norm_and_rotary_gradients_match_jax(fused):
    """rms_norm (plain and fused) and apply_rotary differentiate as the
    reference's do (no in-place write on a saved tensor): gradients of
    <w, rotary(norm(x, scale))> against jax.grad, float32."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32) * 2
    scale = rng.standard_normal(32).astype(np.float32)
    w = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(7, dtype=np.float32)

    def ref_f(x, scale):
        cos, sin = ref_layers.rotary_cos_sin(jnp.asarray(pos), 32, 10_000.0)
        y = ref_layers.apply_rotary(ref_layers.rms_norm(x, scale, 1e-5,
                                                        fused=fused),
                                    cos, sin)
        return jnp.sum(y * w)

    rg = jax.grad(ref_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, scale))
    cos, sin = layers.rotary_cos_sin(torch.from_numpy(pos), 32, 10_000.0)
    y = layers.apply_rotary(layers.rms_norm(tx, ts, 1e-5, fused=fused),
                            cos, sin)
    (y * torch.from_numpy(w)).sum().backward()
    for got, want in ((tx.grad, rg[0]), (ts.grad, rg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_moe_ffn_gradients_match_jax(mesh):
    """moe_ffn's output and aux loss differentiate as the reference's
    (capacity factor 4.0: no expert overflows): gradients of
    <w, out> + aux with respect to x and every weight, router included."""
    from repro.configs.base import TransformerConfig as RefCfg
    from repro.models import moe as ref_moe
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.models import moe
    kw = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
              d_ff=128, moe_d_ff=32, vocab_size=256, n_routed_experts=8,
              n_shared_experts=2, top_k=2, dtype="float32",
              capacity_factor=4.0)
    params = ref_moe.init_moe_params(jax.random.key(2), RefCfg(**kw),
                                     jnp.float32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    w = rng.standard_normal((3, 20, 64)).astype(np.float32)

    def ref_f(params, x):
        out, aux = ref_moe.moe_ffn(params, x, RefCfg(**kw), base_rules(mesh))
        return jnp.sum(out * w) + aux

    with jax.set_mesh(mesh):
        r_params, r_x = jax.grad(ref_f, argnums=(0, 1))(params,
                                                        jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), params)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(tp, tx, TransformerConfig(**kw))
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_x), **GRAD)
    got = flatten_with_paths(jax.tree.map(lambda t: t.grad, tp,
                                          is_leaf=torch.is_tensor))
    for key, want in flatten_with_paths(_np(r_params)).items():
        np.testing.assert_allclose(got[key].numpy(), want, err_msg=key,
                                   **GRAD)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_remat_recomputes_the_same_gradients(arch):
    """cfg.remat (blocks recomputed in the backward) gives the gradients
    of the plain backward bit for bit."""
    _, _, port = _smoke_pair(arch)
    toks, labs = (torch.from_numpy(x) for x in _tokens(1, 2, 20))
    runs = []
    for remat in (True, False):
        port.cfg = dataclasses.replace(port.cfg, remat=remat)
        loss, _ = port.loss_fn(toks, labs)
        runs.append([loss] + list(torch.autograd.grad(
            loss, list(port.parameters()))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_params_to_jax_tree_inverts_params_from_jax():
    ref, params, port = _smoke_pair("deepseek-v2-236b")
    tree = params_to_jax_tree(port)
    want = flatten_with_paths(_np(params))
    got = flatten_with_paths(tree)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert isinstance(got[key], torch.nn.Parameter)
        np.testing.assert_array_equal(got[key].detach().numpy(), w)
    again = params_from_jax(LM(port.cfg, device="cpu"),
                            jax.tree.map(lambda t: t.detach().numpy(), tree))
    for (n, a), (_, b) in zip(port.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_serving_builds_no_graph():
    """forward, prefill and decode_step run without autograd, though the
    parameters require gradients."""
    _, _, port = _smoke_pair("llama3-8b")
    assert all(p.requires_grad for p in port.parameters())
    toks = torch.from_numpy(_tokens(2, 2, 12)[0])
    logits, _ = port.forward(toks)
    last, pre = port.prefill(toks)
    cache = port.init_cache(2, 16)
    step, _ = port.decode_step(cache, last.argmax(-1)[:, None],
                               torch.full((2,), 12))
    for out in (logits, last, step, *pre["dense"]):
        assert out.grad_fn is None and not out.requires_grad


def _ref_train_step(arch, n_micro, batch, seq, mesh):
    """The reference's train_step for the smoke cut of ``arch`` at
    ``grad_accum`` = n_micro and a [batch, seq] train shape."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), **SMOKE[arch],
                               grad_accum=n_micro)
    rspec = dataclasses.replace(ref_get_arch(arch), model=rcfg)
    return _lm_bundle(rspec, LMShape("t", seq, batch, "train"), mesh).fn


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_train_step_with_grad_accum_matches_reference(arch, mesh):
    """train_step at grad_accum 2 (4 rows, 2 micro-batches, the reference's
    default AdamW): params after 1 and 3 steps within 1e-5 of the
    reference's train_step on the 1-device smoke mesh, and its metrics."""
    n_micro, b, s = 2, 4, 16
    ref, params, port = _smoke_pair(arch, grad_accum=n_micro)
    fn = jax.jit(_ref_train_step(arch, n_micro, b, s, mesh))
    opt_state = ref_opt.init_opt_state(params)
    t_opt = optimizer.init_opt_state(dict(port.named_parameters()))
    data = SyntheticLM(LMDataConfig(512, s, b, seed=1))
    for step in range(3):
        batch = data.batch(step)
        with jax.set_mesh(mesh):
            params, opt_state, r_met = fn(params, opt_state,
                                          jnp.asarray(batch["tokens"]),
                                          jnp.asarray(batch["labels"]))
        t_opt, met = train_step(port, t_opt, batch["tokens"],
                                batch["labels"])
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(r_met[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        if step in (0, 2):
            got = flatten_with_paths(params_to_jax_tree(port))
            for key, w in flatten_with_paths(_np(params)).items():
                np.testing.assert_allclose(got[key].detach().numpy(), w,
                                           rtol=0, atol=1e-5, err_msg=key)
    assert int(t_opt["step"]) == 3


def test_train_step_counts_no_kernel_launch_on_the_cpu():
    _, _, port = _smoke_pair("llama3-8b", grad_accum=2)
    before = (flash_ops.launches.n, flash_ops.bwd_launches.n)
    toks, labs = _tokens(3, 4, 8)
    opt = optimizer.init_opt_state(dict(port.named_parameters()))
    opt, met = train_step(port, opt, toks, labs)
    assert (flash_ops.launches.n, flash_ops.bwd_launches.n) == before
    assert np.isfinite(float(met["loss"]))
    with pytest.raises(ValueError, match="micro-batches"):
        train_step(port, opt, toks[:3], labs[:3])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _train_cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "HOME": str(cwd)})


def test_launch_train_runs_on_the_cpu_and_restarts(tmp_path):
    """--device cpu --steps 3 trains the smoke cut end to end and
    checkpoints; a second run with more steps resumes from the checkpoint."""
    ck = tmp_path / "ck"
    first = _train_cli("--arch", "llama3-8b", "--steps", "3", "--device",
                       "cpu", "--seq", "32", "--ckpt-dir", str(ck),
                       cwd=tmp_path)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "[train] step 0 loss" in first.stdout
    assert "done on cpu" in first.stdout
    assert CheckpointManager(str(ck)).latest_version() == 3
    second = _train_cli("--arch", "llama3-8b", "--steps", "4", "--device",
                        "cpu", "--seq", "32", "--ckpt-dir", str(ck),
                        cwd=tmp_path)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "restored version 3" in second.stdout
    assert "[train] step 3 loss" in second.stdout


def test_launch_train_needs_a_card_or_the_cpu(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "llama3-8b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main()
