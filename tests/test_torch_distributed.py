"""Two-sided tests of the port's sharding rules and collectives against the
reference (``repro.distributed``).

Sharding: the reference's spec tests (tests/test_distributed.py) on both
packages, and the rule tables of both over stand-in meshes (an object with
``axis_names`` and ``shape``, which both packages read) of 1, 16 x 16 and
2 x 16 x 16 devices.  Placements run on a world-1 gloo ``DeviceMesh``.

Collectives: 2 and 4 gloo ranks, each a subprocess joined through a
``FileStore`` in the test's directory and bounded by its own timeout, so a
hang fails the test.  Every rank holds an even shard of one seeded corpus
(or of one sequence); the result is held against the reference's function
on the 1-device smoke mesh over the whole corpus (or sequence): ids
identical, values within 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.distributed import collectives as ref_coll
from repro.distributed import sharding as ref_sharding
from repro.launch.mesh import make_smoke_mesh
from repro_torch.distributed import sharding

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
RANK_TIMEOUT_S = 180


# ---------------------------------------------------------------------------
# specs and rule tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rules,axes,want", [
    ({"batch": ("pod", "data"), "heads": "model", "embed": None},
     ("batch", None, "heads"), (("pod", "data"), None, "model")),
    ({"batch": ("pod", "data"), "heads": "model", "embed": None},
     ("embed",), ()),
    ({"batch": ("pod", "data"), "heads": "model", "embed": None},
     (None, "embed"), ()),
    # 'model' already used by axis a -> b falls back to replicated
    ({"a": ("data", "model"), "b": "model"}, ("a", "b"),
     (("data", "model"),)),
])
def test_spec_building(rules, axes, want):
    port = sharding.ShardingRules(rules).spec(*axes)
    ref = ref_sharding.ShardingRules(rules).spec(*axes)
    assert port == want
    assert tuple(ref) == port


def test_spec_no_duplicate_physical_axes():
    rules = {"a": ("data", "model"), "b": "model", "c": ("model", "data"),
             "d": "data"}
    for axes in (("a", "b"), ("b", "c"), ("d", "c", "a"), ("c", None, "b")):
        port = sharding.ShardingRules(rules).spec(*axes)
        assert tuple(ref_sharding.ShardingRules(rules).spec(*axes)) == port
        flat = [a for p in port if p is not None
                for a in ((p,) if isinstance(p, str) else p)]
        assert len(flat) == len(set(flat))


def test_with_overrides_immutable():
    for mod in (sharding, ref_sharding):
        r1 = mod.ShardingRules({"a": "data"})
        r2 = r1.with_overrides(a=None, b="model")
        assert r1.rules["a"] == "data"
        assert r2.rules["a"] is None and r2.rules["b"] == "model"


MESHES = {
    "1": SimpleNamespace(axis_names=("data", "model"),
                         shape={"data": 1, "model": 1}),
    "16x16": SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 16, "model": 16}),
    "2x16x16": SimpleNamespace(axis_names=("pod", "data", "model"),
                               shape={"pod": 2, "data": 16, "model": 16}),
}
LOGICAL = [("batch", "seq", "embed"), ("batch", "seq", "heads", None),
           ("batch", "kv_seq", "kv_heads", None), ("p_embed", "p_mlp"),
           ("layers", "p_expert", "p_embed", None), ("corpus", "feat"),
           ("batch", "expert", None, None), ("p_vocab", "p_embed"),
           ("table_row", None), ("edge",), ("candidate", "batch")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("kind", ["base", "decode", "decode_seq_over_data"])
def test_rules_match_reference_over_mesh_shapes(mesh, fsdp, kind):
    m = MESHES[mesh]

    def make(mod):
        if kind == "base":
            return mod.base_rules(m, fsdp=fsdp)
        return mod.decode_rules(m, fsdp=fsdp,
                                shard_seq_over_data=kind != "decode")

    port, ref = make(sharding), make(ref_sharding)
    assert port.rules == ref.rules
    for axes in LOGICAL:
        assert sharding.logical_spec(port, *axes) == tuple(ref.spec(*axes))
    assert sharding.LOGICAL_RULES(m).rules == ref_sharding.base_rules(m).rules


def _run_ranks(tmp_path: Path, world: int, body: str) -> None:
    """Run ``body`` in ``world`` gloo ranks (subprocesses joined through a
    FileStore in ``tmp_path``; ``rank``, ``world`` and ``out`` (tmp_path)
    are defined for it), each bounded by RANK_TIMEOUT_S."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent("""
        import sys
        from pathlib import Path
        import torch.distributed as dist
        rank, world, out = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(out / "store"), world),
            rank=rank, world_size=world)
        try:
    """) + textwrap.indent(textwrap.dedent(body), "    ") + textwrap.dedent("""
        finally:
            dist.destroy_process_group()
    """))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-W", "ignore", str(script),
                               str(r), str(world), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} of {world} still running after "
                        f"{RANK_TIMEOUT_S} s (a collective hangs)")
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-2000:]}")
    assert not errors, "\n".join(errors)


def test_placements_on_a_gloo_device_mesh(tmp_path):
    """Rules built for a 16 x 16 mesh, applied on a world-1 (data, model)
    ``DeviceMesh``: ``Shard(dim)`` on each mesh dim the spec names, a
    ``DTensor`` redistributed by ``constrain``, a plain tensor returned as
    it is, and ``tree_shardings`` over a nested dict."""
    _run_ranks(tmp_path, 1, """
        import json
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import distribute_tensor, Replicate
        from types import SimpleNamespace
        from repro_torch.distributed.sharding import (
            base_rules, constrain, logical_sharding, tree_shardings)
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        rules = base_rules(SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 16, "model": 16}),
            fsdp=True)
        got = {"act": logical_sharding(mesh, rules, "batch", "seq", "heads"),
               "param": logical_sharding(mesh, rules, "p_embed", "p_mlp"),
               "corpus": logical_sharding(mesh, rules, "corpus", None),
               "none": logical_sharding(mesh, rules, None, "embed")}
        x = torch.arange(24.0).reshape(2, 3, 4)
        assert constrain(x, rules, "batch", None, "heads") is x
        dt = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        moved = constrain(dt, rules, "batch", None, "heads")
        assert torch.equal(moved.full_tensor(), x)
        tree = tree_shardings(mesh, rules, {"a": ("p_embed", "p_mlp"),
                                            "b": {"c": None}})
        got["moved"] = list(moved.placements)
        got["tree_a"], got["tree_c"] = tree["a"], tree["b"]["c"]
        (out / "placements.json").write_text(json.dumps(
            {k: [repr(p) for p in v] for k, v in got.items()}))
    """)
    got = json.loads((tmp_path / "placements.json").read_text())
    assert got == {
        "act": ["Shard(dim=0)", "Shard(dim=2)"],
        "param": ["Shard(dim=0)", "Shard(dim=1)"],
        "corpus": ["Shard(dim=0)", "Shard(dim=0)"],
        "none": ["Replicate()", "Replicate()"],
        "moved": ["Shard(dim=0)", "Shard(dim=2)"],
        "tree_a": ["Shard(dim=0)", "Shard(dim=1)"],
        "tree_c": ["Replicate()", "Replicate()"],
    }


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

N_ROWS, DIM, N_QUERIES = 96, 16, 5
METRICS = ("l2", "ip", "cosine")
KS = (1, 8, 30)                 # 30 > the 24 rows a rank holds at world 4
SEQ, HEAD = 64, 8


def _corpus():
    """Integer-valued rows (exact sums), the second half a copy of the first:
    ties across ranks, which must break to the lower row."""
    rng = np.random.default_rng(0)
    half = rng.integers(-3, 4, (N_ROWS // 2, DIM)).astype(np.float32)
    corpus = np.concatenate([half, half])
    ids = (np.arange(N_ROWS) * 7 + (1 << 33)).astype(np.int64)
    q = rng.integers(-3, 4, (N_QUERIES, DIM)).astype(np.float32)
    return q, corpus, ids


def _sequence():
    rng = np.random.default_rng(1)
    scores = (rng.standard_normal((3, SEQ)) * 4).astype(np.float32)
    values = rng.standard_normal((3, SEQ, HEAD)).astype(np.float32)
    return scores, values


_COLLECTIVES = """
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (
        partial_softmax_combine, sharded_topk)
    rng = np.random.default_rng(0)
    half = rng.integers(-3, 4, ({n} // 2, {d})).astype(np.float32)
    corpus = np.concatenate([half, half])
    ids = (np.arange({n}) * 7 + (1 << 33)).astype(np.int64)
    q = torch.from_numpy(rng.integers(-3, 4, ({nq}, {d})).astype(np.float32))
    rows = slice(rank * {n} // world, (rank + 1) * {n} // world)
    c_l = torch.from_numpy(corpus[rows])
    i_l = torch.from_numpy(ids[rows])
    res = {{}}
    for metric in {metrics}:
        for k in {ks}:
            v, i = sharded_topk(q, c_l, i_l, k, metric=metric)
            assert i.dtype == torch.int64
            res[f"{{metric}}_{{k}}_v"] = v.numpy()
            res[f"{{metric}}_{{k}}_i"] = i.numpy()
    rng = np.random.default_rng(1)
    scores = (rng.standard_normal((3, {seq})) * 4).astype(np.float32)
    values = rng.standard_normal((3, {seq}, {head})).astype(np.float32)
    cols = slice(rank * {seq} // world, (rank + 1) * {seq} // world)
    res["softmax"] = partial_softmax_combine(
        torch.from_numpy(scores[:, cols]),
        torch.from_numpy(values[:, cols])).numpy()
    np.savez(out / f"rank{{rank}}.npz", **res)
""".format(n=N_ROWS, d=DIM, nq=N_QUERIES, metrics=METRICS, ks=KS, seq=SEQ,
           head=HEAD)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Every rank's results at world sizes 2 and 4: {world: [npz, ...]}."""
    runs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        _run_ranks(d, world, _COLLECTIVES)
        runs[world] = [dict(np.load(d / f"rank{r}.npz"))
                       for r in range(world)]
    return runs


@pytest.fixture(scope="module")
def mesh():
    return make_smoke_mesh()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", KS)
def test_sharded_topk_matches_reference(gloo_runs, mesh, world, metric, k):
    q, corpus, ids = _corpus()
    with jax.set_mesh(mesh):
        rv, ri = ref_coll.sharded_topk(mesh, "data", jnp.asarray(q),
                                       jnp.asarray(corpus), jnp.asarray(ids),
                                       k, metric=metric)
    ranks = gloo_runs[world]
    for res in ranks:           # every rank holds the same answer
        np.testing.assert_array_equal(res[f"{metric}_{k}_i"],
                                      ranks[0][f"{metric}_{k}_i"])
    got_v, got_i = ranks[0][f"{metric}_{k}_v"], ranks[0][f"{metric}_{k}_i"]
    assert got_v.shape == (N_QUERIES, k)
    # JAX runs without x64: the reference holds the ids as int32, which
    # wraps these ids past 2**31 (ROADMAP Queue C); the port keeps int64
    np.testing.assert_array_equal(got_i.astype(np.int32), np.asarray(ri))
    np.testing.assert_allclose(got_v, np.asarray(rv), rtol=1e-5, atol=1e-5)
    # and the whole-corpus exact top-k, ties to the lower row
    from repro_torch.core.vector_index import scan_topk
    import torch
    wv, wi = scan_topk(*(torch.from_numpy(x) for x in (q, corpus, ids)), k,
                       metric=metric)
    np.testing.assert_array_equal(got_i, wi.numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_partial_softmax_combine_matches_reference(gloo_runs, mesh, world):
    scores, values = _sequence()
    with jax.set_mesh(mesh):
        ref = ref_coll.partial_softmax_combine(
            mesh, "data", jnp.asarray(scores), jnp.asarray(values))
    plain = np.einsum("qs,qsd->qd", np.asarray(jax.nn.softmax(
        jnp.asarray(scores), axis=-1)), values)
    for res in gloo_runs[world]:
        np.testing.assert_allclose(res["softmax"], np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["softmax"], plain, rtol=1e-5,
                                   atol=1e-5)
