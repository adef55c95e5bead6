"""The port's sharded dry run: steps on DTensors over a fake process group,
counted for one device (``launch/op_analysis.py``, ``launch/dryrun.py``).

Each case that starts a fake process group runs in a subprocess of its
own: a process holds one default group, and other files' tests (under
xdist's ``loadfile``) leave gloo groups in the worker.

* A 2-layer narrow LM ``train_step`` on a fake 4 x 2 mesh, every product
  split evenly: the per-device FLOPs equal the local products' hand count
  (forward, remat recompute, backward) plus the attention kernels' work at
  the local shapes, and one-eighth of the one-device count.  Rank 0's
  peak is below the one-device peak.
* A Megatron-sharded MLP block: its collectives by kind and bytes match a
  hand count (one all-reduce of the output forward, one of the input's
  gradient backward), and ``repeat(n)`` scales them by n.
* The same tiny cell compiled by the reference on 4 forced host devices
  (``hlo_analysis.analyze``): per-device dot FLOPs within 1%; total
  collective bytes within a factor of 1.5 (the two partitioners choose
  different collectives: ROADMAP Queue C has the numbers).  So do cells
  whose query or key heads do not divide a model axis of 4, and the GNNs
  (graphsage, GCN, SchNet) on a graph whose nodes shard.
* A GNN and an AutoInt cell counted by ``dryrun.run_cell`` on the 16 x 16
  mesh, each with its collectives; graphsage's ogb_products count equal
  on the 16 x 16 and the 2 x 16 x 16 mesh (its rules map nothing to
  ``pod``).
* A 1 x 1 gloo mesh: the DTensor route of the kernel wrappers and of a
  whole train step equals the plain route bit for bit on the CPU;
  ``constrain`` is a no-op off a mesh, and a plain tensor reaching a
  wrapper takes the plain path.  On 4 gloo ranks the uneven-heads
  attention, on 2 the kernel wrappers' and MoE's sharded routes, equal
  the whole computation.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.distributed.sharding import base_rules, constrain
from repro_torch.launch.mesh import ONE

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: a narrow llama3-8b cut: every product splits over data 4 x model 2
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, grad_accum=2, fsdp=False, remat=True)


def _run(code: str, timeout: int = 600, env=None) -> dict:
    """Run ``code`` in a fresh interpreter (the port on ``sys.path``) and
    return the JSON object its last line prints."""
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
             OMP_NUM_THREADS="1")
    e.update(env or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=e, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_TINY_CELL = """
import dataclasses, json
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMShape
from repro_torch.distributed.sharding import place_tree
from repro_torch.launch.mesh import make_fake_mesh, ONE
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.steps import _lm_bundle
torch.set_num_threads(1)
spec = get_arch("llama3-8b")
spec = dataclasses.replace(spec, model=dataclasses.replace(spec.model,
                                                           **OVER))
shape = LMShape("t", SEQ, BATCH, "train")
one = _lm_bundle(spec, shape, ONE)
an1 = analyze(one.fn, *one.abstract_args)
dm = make_fake_mesh(MESH, ("data", "model"))
b = _lm_bundle(spec, shape, dm)
args = tuple(place_tree(a, s, dm) for a, s in zip(b.abstract_args,
                                                  b.in_specs))
with implicit_replication():
    an = analyze(b.fn, *args)
print(json.dumps({"flops": an.flops, "one": an1.flops,
                  "kernels": an.kernels, "collectives": an.collectives,
                  "collective_bytes": an.collective_bytes,
                  "peak": an.peak_bytes, "peak_one": an1.peak_bytes}))
"""


def _tiny_cell(over, seq, batch, mesh):
    return _run(f"OVER = {over!r}\nSEQ, BATCH, MESH = {seq}, {batch}, "
                f"{mesh!r}\n" + _TINY_CELL)


def test_tiny_lm_train_step_counts_the_local_products():
    c = TINY
    seq, batch, shards = 64, 16, 8
    res = _tiny_cell(TINY, seq, batch, (4, 2))
    t = batch * seq
    d, h, kvh, hd, f, v = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                           c["head_dim"], c["d_ff"], c["vocab_size"])
    down = 2 * t * f * d
    layer = 2 * t * d * (h + 2 * kvh) * hd + 2 * t * h * hd * d \
        + 2 * 2 * t * d * f + down
    head = 2 * t * d * v
    # a block's products run forward, twice for their gradients, and again
    # in the backward under remat, all but the last (w_down: the
    # recomputation stops once the saved tensors are back); the head
    # forward and backward
    products = (c["n_layers"] * (4 * layer - down) + 3 * head) / shards
    kernels = sum(k["flops"] for k in res["kernels"].values())
    assert res["kernels"]["flash_attention"]["calls"] == 2 * c["n_layers"] \
        * c["grad_accum"]
    assert res["flops"] == pytest.approx(products + kernels, rel=1e-9)
    assert res["flops"] * shards == pytest.approx(res["one"], rel=1e-9)
    kinds = set(res["collectives"])
    assert "all-reduce" in kinds                 # Megatron's activations
    assert res["collective_bytes"] == pytest.approx(sum(
        e["bytes"] for e in res["collectives"].values()))
    assert 0 < res["peak"] < res["peak_one"]


_MLP = """
import json
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.distributed.sharding import base_rules, constrain, place
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.op_analysis import analyze, repeat
dm = make_fake_mesh((4, 2), ("data", "model"))
rules = base_rules(dm)
b, s, d, f = 8, 32, 64, 256
m = lambda *shape: torch.empty(shape, device="meta")
x = place(m(b, s, d), dm, rules.spec("batch", "seq", "embed")
          ).requires_grad_()
wg = place(m(d, f), dm, rules.spec(None, "p_mlp")).requires_grad_()
wu = place(m(d, f), dm, rules.spec(None, "p_mlp")).requires_grad_()
wd = place(m(f, d), dm, rules.spec("p_mlp", None)).requires_grad_()

def block(x):
    h = constrain(x, rules, "batch", "seq", "embed")
    gu = constrain(F.silu(h @ wg) * (h @ wu), rules, "batch", "seq", "mlp")
    return constrain(gu @ wd, rules, "batch", "seq", "embed")

def step(n):
    with repeat(n):
        block(x).sum().backward()

out = {}
for n in (1, 3):
    an = analyze(step, n)
    out[n] = {"collectives": an.collectives, "bytes": an.collective_bytes,
              "flops": an.flops}
print(json.dumps(out))
"""


def test_megatron_mlp_collectives_match_a_hand_count_and_repeat_scales():
    res = _run(_MLP)
    one, three = res["1"], res["3"]
    # the output's partial sum over model all-reduced forward, the input's
    # gradient (a partial sum of the two products') backward: each a
    # float32 [B/4, S, d] shard; the weights' gradients stay partial sums
    # over data (they are leaves: no optimizer reduces them here)
    local = 8 // 4 * 32 * 64 * 4
    assert one["collectives"] == {"all-reduce": {"count": 2.0,
                                                 "bytes": 2.0 * local}}
    assert one["bytes"] == 2 * local
    assert three["collectives"]["all-reduce"] == {"count": 6.0,
                                                  "bytes": 6.0 * local}
    assert three["flops"] == pytest.approx(3 * one["flops"])
    # per device: 3 products forward, 6 backward, of [B/4 S, d] x [d, f/2]
    assert one["flops"] == 9 * 2 * (8 // 4 * 32) * 64 * (256 // 2)


_REF = """
import dataclasses, json
import jax
from repro.configs import get_arch
from repro.configs.base import LMShape
from repro.launch import mesh as rmesh
from repro.launch.hlo_analysis import analyze
from repro.launch.steps import _lm_bundle
spec = get_arch("llama3-8b")
spec = dataclasses.replace(spec, model=dataclasses.replace(spec.model,
                                                           **OVER))
mesh = rmesh.make_mesh_for(4, model_parallel=MODEL)
b = _lm_bundle(spec, LMShape("t", SEQ, BATCH, "train"), mesh)
with jax.set_mesh(mesh):
    c = jax.jit(b.fn, in_shardings=b.in_shardings,
                out_shardings=b.out_shardings,
                donate_argnums=b.donate_argnums).lower(
                    *b.abstract_args).compile()
an = analyze(c.as_text())
print(json.dumps({"flops": an.flops, "collectives": an.collectives,
                  "collective_bytes": an.collective_bytes}))
"""

#: the cell both packages count on 4 devices: float32 (the reference's
#: CPU compile would move bf16 weights as float32), 8 positions (the
#: attention, which the two count differently, is 0.4% of the products)
REF_CELL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                head_dim=64, d_ff=512, vocab_size=512, grad_accum=1,
                dtype="float32")


def test_tiny_cell_matches_the_reference_on_four_host_devices():
    ref = _ref_cell(REF_CELL, 2)
    port = _tiny_cell(REF_CELL, 8, 16, (2, 2))
    assert port["flops"] == pytest.approx(ref["flops"], rel=0.01)
    # the partitioners differ: XLA reduces the gradients by all-reduce and
    # gathers each weight twice as often under remat; the port reduce-
    # scatters FSDP gradients (ROADMAP Queue C: 10.75 vs 7.94 MB)
    ratio = port["collective_bytes"] / ref["collective_bytes"]
    assert 1 / 1.5 <= ratio <= 1.5, (port["collectives"],
                                     ref["collectives"])


def _ref_cell(over, model: int) -> dict:
    """The tiny cell ``over`` (8 x 16 tokens) counted by the reference on 4
    forced host devices, ``model`` of them on the model axis."""
    return _run(f"OVER = {over!r}\nSEQ, BATCH = 8, 16\nMODEL = {model}\n"
                + _REF, env={"XLA_FLAGS":
                             "--xla_force_host_platform_device_count=4"})


@pytest.mark.parametrize("heads,kv_heads,head_dim", [
    (6, 2, 64), (8, 2, 32), (10, 2, 32)])
def test_uneven_heads_match_the_reference_on_four_host_devices(
        heads, kv_heads, head_dim):
    """Query or key heads that do not divide a model axis of 4: the
    reference's partitioner pads the head dim, the port gives each rank
    its ``torch.chunk`` of the query heads and the key heads they read
    (``LM._gqa_local``).  Rank 0's FLOPs equal the reference's per-device
    count within 1%.  The port's explicit slices move fewer collective
    bytes than XLA's padded reshards (ROADMAP Queue C has the numbers)."""
    over = dict(REF_CELL, n_heads=heads, n_kv_heads=kv_heads,
                head_dim=head_dim)
    ref = _ref_cell(over, 4)
    port = _tiny_cell(over, 8, 16, (1, 4))
    assert port["flops"] == pytest.approx(ref["flops"], rel=0.01)
    assert port["flops"] * 4 < 1.25 * port["one"]
    assert port["collective_bytes"] <= ref["collective_bytes"], (
        port["collectives"], ref["collectives"])


_REF_GNN = """
import json
import jax
from repro.configs import get_arch
from repro.configs.base import GraphShape
from repro.launch import mesh as rmesh
from repro.launch.gnn_steps import gnn_bundle
from repro.launch.hlo_analysis import analyze
mesh = rmesh.make_mesh_for(4, model_parallel=2)
b = gnn_bundle(get_arch(ARCH), GraphShape("t", **SHAPE), mesh)
with jax.set_mesh(mesh):
    c = jax.jit(b.fn, in_shardings=b.in_shardings,
                out_shardings=b.out_shardings,
                donate_argnums=b.donate_argnums).lower(
                    *b.abstract_args).compile()
print(json.dumps({"flops": analyze(c.as_text()).flops}))
"""

_PORT_GNN = """
import json
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import GraphShape
from repro_torch.distributed.sharding import place_tree
from repro_torch.launch.gnn_steps import gnn_bundle
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.op_analysis import analyze
torch.set_num_threads(1)
dm = make_fake_mesh((2, 2), ("data", "model"))
b = gnn_bundle(get_arch(ARCH), GraphShape("t", **SHAPE), dm)
args = tuple(place_tree(a, s, dm) for a, s in zip(b.abstract_args,
                                                  b.in_specs))
with implicit_replication():
    an = analyze(b.fn, *args)
print(json.dumps({"flops": an.flops, "by_op": an.flops_by_op}))
"""

#: a full graph past 500,000 nodes, so that its nodes shard as
#: ogb_products' do (``gnn_steps.cell_of``), at a small width
GNN_REF_SHAPE = dict(kind="full_graph", n_nodes=600_000, n_edges=1_200_128,
                     d_feat=16)


@pytest.mark.parametrize("arch", ["graphsage-reddit", "gcn-cora", "schnet"])
def test_gnn_cell_matches_the_reference_on_four_host_devices(arch):
    """The node and edge tables pinned by the cell's rules at each layer
    boundary: the port's per-device products equal the reference's dot
    FLOPs on 4 forced host devices (data 2, model 2) within 1%.  The
    gather-scatter kernel's sums, which XLA does not count as dots, are
    left out."""
    head = f"ARCH, SHAPE = {arch!r}, {GNN_REF_SHAPE!r}\n"
    ref = _run(head + _REF_GNN, env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    port = _run(head + _PORT_GNN)
    products = port["by_op"]["aten.mm"]
    assert products == pytest.approx(ref["flops"], rel=0.01)


_MESH_COUNT = """
import json
from repro_torch.launch import dryrun
res = dryrun.run_cell("graphsage-reddit", "ogb_products", MESH)
print(json.dumps({k: res[k] for k in ("flops", "bytes", "collectives")}))
"""


def test_graphsage_products_count_is_fixed_by_the_rules():
    """ogb_products' nodes shard over (data, model) and its edges over
    data; no GNN rule maps a node or an edge dim to ``pod``, so the graph
    is replicated over the pods and a device's count on ``multi`` is its
    count on ``single``, whatever strategy DTensor would pick between the
    pinned layer boundaries.  The products run on a device's 1/256 of the
    nodes: the step's FLOPs a device are below 1% of the one-card count."""
    one = _run(_MESH_COUNT.replace("MESH", '"one"'))
    single = _run(_MESH_COUNT.replace("MESH", '"single"'))
    multi = _run(_MESH_COUNT.replace("MESH", '"multi"'))
    assert multi == single
    assert single["flops"] < 0.01 * one["flops"]


_CELL = """
import json
from repro_torch.launch import dryrun
res = dryrun.run_cell(ARCH, SHAPE, "single")
print(json.dumps({k: res[k] for k in (
    "n_chips", "flops", "bytes", "peak_bytes", "collectives",
    "collective_bytes", "roofline", "fits_80GB", "analysis")}))
"""


@pytest.mark.parametrize("arch,shape,kinds,kernel", [
    ("graphsage-reddit", "full_graph_sm", {"all-reduce"}, "gather_scatter"),
    ("autoint", "train_batch", {"all-gather", "all-reduce"},
     "gather_scatter"),
])
def test_gnn_and_recsys_cells_count_their_collectives(arch, shape, kinds,
                                                      kernel):
    res = _run(f"ARCH, SHAPE = {arch!r}, {shape!r}\n" + _CELL)
    assert res["n_chips"] == 256
    assert set(res["collectives"]) >= kinds
    assert all(e["count"] > 0 and e["bytes"] > 0
               for e in res["collectives"].values())
    assert res["analysis"]["kernels"][kernel]["calls"] > 0
    assert res["roofline"]["collective_s"] > 0


_ONE_RANK = """
import dataclasses, json
import torch
from torch.distributed.tensor import Shard, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMShape
from repro_torch.distributed.sharding import place_tree
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import _lm_bundle, train_step
from repro_torch.models.transformer import LM
from repro_torch.training.optimizer import init_opt_state
torch.set_num_threads(1)
torch.manual_seed(0)
mesh = make_smoke_mesh("cpu")
spec = get_arch("llama3-8b")
cfg = dataclasses.replace(spec.model, **OVER)
res = {}

def dt(t, *pl):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, pl or [Replicate(), Replicate()],
                              run_check=False)

q, k = torch.randn(2, 16, 4, 16), torch.randn(2, 16, 2, 16)
plain = flash_ops.flash_attention(q, k, k)
sh = flash_ops.flash_attention(dt(q, Shard(0), Shard(2)), dt(k), dt(k))
res["flash"] = bool(torch.equal(sh.to_local(), plain))

def model_and_args():
    g = torch.Generator().manual_seed(1)
    m = LM(cfg, device="cpu", generator=g)
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    return m, init_opt_state(dict(m.named_parameters())), tok, lab

m, opt, tok, lab = model_and_args()
_, met = train_step(m, opt, tok, lab)
b = _lm_bundle(dataclasses.replace(spec, model=cfg),
               LMShape("t", 16, 4, "train"), mesh)
m2, opt2, tok2, lab2 = model_and_args()
m2.rules = b.rules
args = tuple(place_tree(a, s, mesh, values=True) for a, s in
             zip((m2, opt2, tok2, lab2), b.in_specs))
with implicit_replication():
    _, met2 = train_step(*args)
res["loss"] = bool(torch.equal(met2["loss"].full_tensor(), met["loss"]))
res["params"] = all(torch.equal(p.full_tensor(), q)
                    for (_, p), q in zip(m2.named_parameters(),
                                         m.parameters()))
print(json.dumps(res))
"""


def test_one_rank_mesh_dtensor_route_equals_the_plain_route():
    over = dict(TINY, remat=False)
    res = _run(f"OVER = {over!r}\n" + _ONE_RANK)
    assert res == {"flash": True, "loss": True, "params": True}


def test_constrain_is_a_no_op_off_a_mesh():
    x = torch.randn(2, 3, 4)
    rules = base_rules(ONE)
    assert constrain(x, rules, "batch", "seq", "embed") is x
    assert constrain(x, None, "batch") is x


_TWO_RANKS = """
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.gather_scatter import ops as gs_ops
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.models.recsys.embedding_bag import embedding_bag_dense
torch.manual_seed(0)
by_model = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))
by_data = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                     mesh_dim_names=("data", "model"))
R = Replicate()

def put(t, mesh, *pl):
    return distribute_tensor(t, mesh, pl, src_data_rank=None)

def close(got, want, what, tol=1e-5):
    got = got.full_tensor()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max())
    assert err <= tol, (what, err)

# decode over a cache whose positions are split: row 0 sees only rank 0's
# half, row 1 both halves
q = torch.randn(2, 1, 4, 16)
kc, vc = torch.randn(2, 32, 2, 16), torch.randn(2, 32, 2, 8)
pos = torch.tensor([9, 27], dtype=torch.int32)
want = decode_ops.decode_attention(q, kc, vc, pos)
got = decode_ops.decode_attention(put(q, by_model, R, R),
                                  put(kc, by_model, R, Shard(1)),
                                  put(vc, by_model, R, Shard(1)),
                                  put(pos, by_model, R, R))
close(got, want, "decode")

# gather_scatter's mean over edges split over data, and its gradient
x = torch.randn(50, 8)
src = torch.randint(0, 50, (300,))
dst = torch.randint(0, 40, (300,))
w = torch.rand(300)
xw = x.clone().requires_grad_()
want = gs_ops.gather_scatter(xw, src, dst, 40, w, "mean")
want.square().sum().backward()
xd = put(x, by_data, R, R).requires_grad_()
got = gs_ops.gather_scatter(xd, put(src, by_data, Shard(0), R),
                            put(dst, by_data, Shard(0), R), 40,
                            put(w, by_data, Shard(0), R), "mean")
close(got, want.detach(), "gather_scatter mean")
got.square().sum().backward()
close(xd.grad, xw.grad, "gather_scatter mean, d x")

# the embedding bag: tables split by fields over model, and by rows
table = torch.randn(4, 30, 8)
ids = torch.randint(0, 30, (6, 4, 3), dtype=torch.int32)
want = embedding_bag_dense(table, ids)
for pl in ((R, Shard(0)), (R, Shard(1))):
    got = embedding_bag_dense(put(table, by_model, *pl),
                              put(ids, by_model, R, R))
    close(got, want, f"bag {pl}")

# ivf_scan over a corpus split by rows
qv, corpus = torch.randn(3, 16), torch.randn(101, 16)
wv, wi = ivf_ops.ivf_scan_topk(qv, corpus, 7, "ip")
gv, gi = ivf_ops.ivf_scan_topk(put(qv, by_data, R, R),
                               put(corpus, by_data, Shard(0), R), 7, "ip")
close(gv, wv, "ivf values")
assert torch.equal(gi.full_tensor(), wi), "ivf rows"
"""

_MOE_TWO_RANKS = """
import dataclasses
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import base_rules
from repro_torch.models.moe import init_moe_params, moe_ffn
cfg = dataclasses.replace(get_arch("deepseek-moe-16b").model, d_model=32,
                          moe_d_ff=16, n_routed_experts=8, top_k=2,
                          n_shared_experts=1, dtype="float32")
mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                  mesh_dim_names=("data", "model"))
g = torch.Generator().manual_seed(3)
params = init_moe_params(cfg, torch.float32, torch.device("cpu"), g)
x = torch.randn(2, 16, 32, generator=g)
R = Replicate()

def grads(p, x):
    leaves = [p["router"], *p["experts"].values(), *p["shared"].values(), x]
    for t in leaves:
        t.requires_grad_()
    out, aux = moe_ffn(p, x, cfg, rules)
    (out.square().sum() + aux).backward()
    return out, aux, [t.grad for t in leaves]

rules = None
out, aux, want = grads(params, x)
rules = base_rules(mesh)
pl = lambda t, *p: distribute_tensor(t.detach(), mesh, p or (R, R),
                                     src_data_rank=None)
dp = {"router": pl(params["router"]),
      "experts": {k: pl(v, R, Shard(0)) for k, v in
                  params["experts"].items()},
      "shared": {k: pl(v, R, Shard(1) if k != "w_down" else Shard(0))
                 for k, v in params["shared"].items()}}
with implicit_replication():
    dout, daux, got = grads(dp, pl(x))
for a, b, what in [(dout, out, "out"), (daux, aux, "aux")] + [
        (gg, ww, f"grad {i}") for i, (gg, ww) in enumerate(zip(got, want))]:
    # float32 sums over the ranks' partials in another order
    err = float((a.full_tensor() - b).abs().max())
    assert err <= 1e-5 * max(1.0, float(b.abs().max())), (what, err)
"""


_UNEVEN_HEADS_FOUR_RANKS = """
import dataclasses
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMShape
from repro_torch.distributed.sharding import place_tree
from repro_torch.launch.steps import _lm_bundle
from repro_torch.models.transformer import LM
from repro_torch.training.optimizer import gradients
torch.set_num_threads(1)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                  mesh_dim_names=("data", "model"))

def close(got, want, what):
    got = got.full_tensor()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max())
    # float32 sums over the ranks' partials in another order
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), (what, err)

for arch, h, kvh in (("qwen3-14b", 10, 2), ("llama3-8b", 8, 2)):
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.model, n_layers=2, d_model=32, n_heads=h,
                              n_kv_heads=kvh, head_dim=8, d_ff=64,
                              vocab_size=64, grad_accum=1, fsdp=False,
                              remat=False, dtype="float32")
    spec = dataclasses.replace(spec, model=cfg)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, 64, (4, 16), generator=g)
    lab = torch.randint(0, 64, (4, 16), generator=g)

    def make():
        return LM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(1))

    m = make()
    loss, _ = m.loss_fn(tok, lab)
    grads = gradients(loss, dict(m.named_parameters()))
    logits, cache = m.prefill(tok)
    tb = _lm_bundle(spec, LMShape("t", 16, 4, "train"), mesh)
    pb = _lm_bundle(spec, LMShape("t", 16, 4, "prefill"), mesh)
    m2 = place_tree(make(), tb.in_specs[0], mesh, values=True)
    m2.rules = tb.rules
    calls = []
    local = LM._gqa_local
    LM._gqa_local = lambda self, *a: calls.append(1) or local(self, *a)
    with implicit_replication():
        loss2, _ = m2.loss_fn(
            place_tree(tok, tb.in_specs[2], mesh, values=True),
            place_tree(lab, tb.in_specs[3], mesh, values=True))
        grads2 = gradients(loss2, dict(m2.named_parameters()))
        close(loss2, loss, f"{arch} loss")
        for n in grads:
            close(grads2[n], grads[n], f"{arch} grad {n}")
        m2.rules = pb.rules
        logits2, cache2 = m2.prefill(
            place_tree(tok, pb.in_specs[1], mesh, values=True))
        close(logits2, logits, f"{arch} prefill logits")
        for key in cache:
            for got, want in zip(cache2[key], cache[key]):
                close(got, want, f"{arch} cache {key}")
    LM._gqa_local = local
    assert len(calls) == 4, (arch, calls)       # 2 layers, loss and prefill
"""


def test_uneven_heads_on_four_gloo_ranks_equal_the_whole(tmp_path):
    """``LM._gqa_local`` on a model axis of 4 real gloo ranks against the
    same model on whole tensors: qwen3's 10 heads over 2 key heads (ranks
    of 3, 3, 3 and 1 query heads; rank 1's split a group, each query head
    reading its key head) and llama3's 8 over 2 (the query heads even, the
    key heads not): the loss, every gradient, the prefill's logits and
    its cache."""
    from test_torch_distributed import _run_ranks
    _run_ranks(tmp_path, 4, _UNEVEN_HEADS_FOUR_RANKS)


@pytest.mark.parametrize("body", ["kernels", "moe"])
def test_sharded_wrappers_equal_the_whole_on_two_gloo_ranks(tmp_path, body):
    """The arithmetic of the sharded routes on 2 real gloo ranks, against
    the same function on whole tensors: decode's partial-softmax combine
    over a position-split cache (a row one rank sees nothing of), the
    gather-scatter mean over split edges (its counts reduced before the
    division) and its gradient, the bag over field- and row-split tables,
    the IVF top-k merged over a row-split corpus, and the MoE layer with
    its experts split over model (the combine a partial sum), its output,
    aux loss and every gradient."""
    from test_torch_distributed import _run_ranks
    _run_ranks(tmp_path, 2, _TWO_RANKS if body == "kernels"
               else _MOE_TWO_RANKS)


def test_a_plain_tensor_takes_the_plain_path():
    """Off a mesh each wrapper returns what its plain version returns, as
    a plain tensor: the DTensor route is taken only for DTensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    g = torch.Generator().manual_seed(5)
    q, k = torch.randn(2, 16, 4, 8, generator=g), torch.randn(
        2, 16, 2, 8, generator=g)
    pos = torch.tensor([3, 15], dtype=torch.int32)
    x = torch.randn(20, 4, generator=g)
    e = torch.randint(0, 20, (50,), generator=g)
    pairs = [
        (flash_ops.flash_attention(q, k, k),
         flash_attention_ref(q, k, k, causal=True, scale=8 ** -0.5)),
        (decode_ops.decode_attention(q[:, :1], k, k, pos),
         decode_attention_ref(q[:, :1], k, k, pos)),
        (gs_ops.gather_scatter(x, e, e.flip(0), 20, None, "mean"),
         gather_scatter_ref(x, e, e.flip(0), 20, None, "mean"))]
    for got, want in pairs:
        assert not isinstance(got, DTensor)
        assert torch.equal(got, want)
