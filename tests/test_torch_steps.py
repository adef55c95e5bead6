"""Two-sided tests of the port's step-bundle layer against the reference:
the models' sharding axes, ``opt_state_axes``, the LM's cache spec and
axes, ``lm_rules``, ``build_step`` for every cell, and the meshes.

* ``param_axes``: for every arch at a reduced config, the keys equal
  ``named_parameters()``, each rank matches, and each leaf's spec under
  ``base_rules`` (and the family's own rules) on stand-in meshes of 1,
  16 x 16 and 2 x 16 x 16 devices equals the reference's spec of the
  matching JAX leaf.  The reference stacks SchNet's interactions and
  Equiformer's layers under a leading "layers" axis, which no rule
  shards; the port keeps one parameter a layer, so its spec is the
  reference's without that first entry.
* ``build_step`` for the 40 cells and the two bonus archs at full size
  (abstract on both sides: nothing is allocated) against the reference's
  ``build_step`` on its one-device ``make_smoke_mesh``: each argument
  leaf's shape, dtype and spec, each output's spec, ``donate_argnums``
  and ``meta``, exactly.
* One LM train step and one GNN train step from their bundles, on CPU
  tensors with the reference's weights, give the reference bundle's loss
  within 1e-4 (and its gradient norm).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import GraphShape as RefGraphShape
from repro.configs.base import LMShape as RefLMShape
from repro.distributed.sharding import base_rules as ref_base_rules
from repro.launch import gnn_steps as ref_gnn_steps
from repro.launch import recsys_steps as ref_recsys_steps
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh_for as ref_make_mesh_for
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.launch.train import smoke_config as ref_smoke_config
from repro.models.gnn import build_gnn as ref_build_gnn
from repro.models.recsys.autoint import AutoInt as RefAutoInt
from repro.models.transformer import LM as RefLM
from repro.training.optimizer import init_opt_state as ref_init_opt_state
from repro.training.optimizer import opt_state_axes as ref_opt_state_axes
from repro_torch.configs import all_cells, arch_names, get_arch
from repro_torch.configs.base import GraphShape, LMShape
from repro_torch.distributed.sharding import base_rules
from repro_torch.launch import gnn_steps, recsys_steps, steps
from repro_torch.launch.mesh import (HW, ONE, make_mesh_for,
                                     make_production_mesh, stand_in)
from repro_torch.launch.train import smoke_config
from repro_torch.models.gnn import build_gnn, gnn_params_from_jax
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.models.transformer import (LM, params_from_jax,
                                            params_to_jax_tree)
from repro_torch.training.optimizer import init_opt_state, opt_state_axes

# one intra-op thread: the timing-driven tests beside this file under -n 6
# must not be starved of cores
torch.set_num_threads(1)

MESHES = {"1": ONE, "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
#: the reference's SchNet and Equiformer stack these groups' layers
STACKED = {"schnet": "interactions", "equiformer_v2": "layers"}
GNN_SMALL = dict(n_layers=2, d_hidden=8)
GNN_EXTRA = {"equiformer_v2": dict(l_max=2, m_max=1, n_heads=2),
             "schnet": dict(n_rbf=8)}
RECSYS_TINY = dict(n_sparse=6, embed_dim=8, n_attn_layers=2, n_heads=2,
                   d_attn=16, vocab_per_field=100, multi_hot=3)


def _is_axes(x):
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def _ref_flat(tree, is_leaf=None):
    """{"a/b/0": leaf} of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)] = leaf
    return out


def _is_spec(x):
    """A partition spec (not a tuple of specs): None, str or non-empty
    tuples of str, no physical axis named twice."""
    if not isinstance(x, tuple):
        return False
    names = []
    for a in x:
        if a is None:
            continue
        if isinstance(a, str):
            names.append(a)
        elif isinstance(a, tuple) and a and all(isinstance(n, str)
                                                 for n in a):
            names.extend(a)
        else:
            return False
    return len(names) == len(set(names))


def _port_flat(tree, prefix=""):
    """{"a/b/0": spec} of a port spec tree."""
    if _is_spec(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


class Names:
    """Port parameter name -> (reference leaf path, layer in a stacked
    group or None)."""

    def __init__(self, model, family):
        self.family = family
        self.stacked = STACKED.get(getattr(model.cfg, "kind", None))
        if family == "lm":
            tree = params_to_jax_tree(model, {n: n for n, _ in
                                              model.named_parameters()})
            self.lm = {v: k for k, v in _ref_flat(tree).items()}

    def __call__(self, name):
        if self.family == "lm":
            return self.lm[name], None
        parts = name.split(".")
        if parts[0] == self.stacked and parts[1].isdigit():
            return "/".join([parts[0]] + parts[2:]), int(parts[1])
        return "/".join(parts), None


# ---------------------------------------------------------------------------
# sharding axes
# ---------------------------------------------------------------------------


def _reduced_pair(arch):
    """(port model on the CPU, the reference's param tree shapes and its
    param_axes) for ``arch`` at a reduced config."""
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    if spec.family == "lm":
        port = LM(smoke_config(arch), device="cpu")
        ref = RefLM(ref_smoke_config(arch))
        shapes = jax.eval_shape(ref.init, jax.random.key(0))
        return port, shapes, ref.param_axes()
    if spec.family == "gnn":
        over = dict(GNN_SMALL, **GNN_EXTRA.get(spec.model.kind, {}))
        cfg = dataclasses.replace(spec.model, **over)
        ref = ref_build_gnn(dataclasses.replace(ref_spec.model, **over))
        port = build_gnn(cfg, 6, 3, device="cpu")
        shapes = jax.eval_shape(lambda k: ref.init(k, 6, 3),
                                jax.random.key(0))
        return port, shapes, ref.param_axes()
    cfg = dataclasses.replace(spec.model, **RECSYS_TINY)
    ref = RefAutoInt(dataclasses.replace(ref_spec.model, **RECSYS_TINY),
                     n_fields_padded=8)
    return AutoInt(cfg, 8, device="cpu"), \
        jax.eval_shape(ref.init, jax.random.key(0)), ref.param_axes()


def _family_rules(arch, mesh):
    """(port, reference) rules of the arch's family on ``mesh``, beside
    base_rules."""
    spec = get_arch(arch)
    if spec.family == "lm":
        shape = spec.shape("train_4k")
        return (steps.lm_rules(spec.model, shape, mesh),
                ref_steps.lm_rules(ref_get_arch(arch).model,
                                   ref_get_arch(arch).shape("train_4k"),
                                   mesh))
    if spec.family == "gnn":
        kw = dict(shard_nodes=True, channel_shard=True)
        return (gnn_steps.gnn_rules(mesh, **kw),
                ref_gnn_steps.gnn_rules(mesh, **kw))
    return recsys_steps.recsys_rules(mesh), ref_recsys_steps.recsys_rules(
        mesh)


@pytest.mark.parametrize("arch", arch_names())
def test_param_axes_match_reference(arch):
    port, ref_shapes, ref_axes = _reduced_pair(arch)
    names = Names(port, get_arch(arch).family)
    ref_shapes = _ref_flat(ref_shapes)
    ref_axes = _ref_flat(ref_axes, is_leaf=_is_axes)
    axes = port.param_axes()
    params = dict(port.named_parameters())
    assert list(axes) == list(params)
    seen = set()
    for name, p in params.items():
        a = axes[name] or ()
        assert len(a) == p.dim(), name
        path, layer = names(name)
        seen.add(path)
        ref_a, ref_shape = ref_axes[path] or (), tuple(ref_shapes[path].shape)
        if layer is not None:
            assert ref_a[0] == "layers" and ref_shape[1:] == p.shape, name
            assert layer < ref_shape[0]
        else:
            assert ref_shape == tuple(p.shape), name
        for mesh in MESHES.values():
            pairs = [(base_rules(mesh), ref_base_rules(mesh)),
                     _family_rules(arch, mesh)]
            for rules, ref_rules in pairs:
                want = tuple(ref_rules.spec(*ref_a))
                if layer is not None:
                    assert not want or want[0] is None
                    want = want[1:]
                assert rules.spec(*a) == want, (name, mesh.shape)
    assert seen == set(ref_shapes)


def test_opt_state_axes_match_reference():
    axes = LM(smoke_config("deepseek-v2-236b"), device="meta").param_axes()
    assert opt_state_axes(axes) == {"m": axes, "v": axes, "step": None}
    assert set(ref_opt_state_axes({})) == set(opt_state_axes({}))
    rules = base_rules(MESHES["16x16"])
    specs = steps.tree_specs(rules, opt_state_axes(axes))
    assert specs["step"] == () and specs["m"] == specs["v"] == \
        steps.tree_specs(rules, axes)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b",
                                  "deepseek-v2-236b"])
def test_cache_spec_and_axes_match_reference(arch):
    """Dense, MoE and MLA: the meta cache has init_cache's and the
    reference's cache_spec's shapes and dtypes, its axes the reference's."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    ref = RefLM(dataclasses.replace(ref_smoke_config(arch),
                                    dtype="bfloat16"))
    model = LM(cfg, device="meta")
    spec, want = model.cache_spec(3, 17), ref.cache_spec(3, 17)
    real = LM(cfg, device="cpu").init_cache(3, 17)
    assert list(spec) == list(want) == list(real)
    for key in spec:
        for got, w, r in zip(spec[key], want[key], real[key]):
            assert got.is_meta and tuple(got.shape) == w.shape == r.shape
            assert got.dtype == r.dtype == torch.bfloat16
            assert str(w.dtype) == "bfloat16"
    assert model.cache_axes() == ref.cache_axes()


@pytest.mark.parametrize("arch", [a for a in arch_names()
                                  if get_arch(a).family == "lm"])
def test_lm_rules_match_reference(arch):
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    for shape in spec.shapes:
        for mesh in MESHES.values():
            got = steps.lm_rules(spec.model, spec.shape(shape), mesh)
            want = ref_steps.lm_rules(ref_spec.model, ref_spec.shape(shape),
                                      mesh)
            assert got.rules == want.rules, (shape, mesh.shape)


# ---------------------------------------------------------------------------
# build_step
# ---------------------------------------------------------------------------

TRAIN_KINDS = ("train", "gnn_train", "recsys_train")


def _to_ref_path(path, kind, names, out=False):
    """A port bundle path -> (reference path, layer)."""
    parts = path.split("/")
    if parts[0] == "0" and len(parts) == 2 and (not out or kind in
                                                 TRAIN_KINDS):
        ref, layer = names(parts[1])
        return f"0/{ref}", layer
    if parts[0] == "1" and kind in TRAIN_KINDS and len(parts) == 3 \
            and parts[1] in ("m", "v"):
        ref, layer = names(parts[2])
        return f"1/{parts[1]}/{ref}", layer
    return path, None


def _compare(port_leaves, ref_leaves, kind, names, out=False):
    """Every reference leaf matched by the port's leaf (or one leaf a
    layer of a stacked group) with the same shape, dtype and spec."""
    grouped = {}
    for path, leaf in port_leaves.items():
        ref_path, layer = _to_ref_path(path, kind, names, out)
        grouped.setdefault(ref_path, {})[layer] = leaf
    assert set(grouped) == set(ref_leaves)
    for ref_path, leaves in grouped.items():
        ref = ref_leaves[ref_path]
        want_spec = tuple(ref[1].spec)
        for layer, (t, spec) in leaves.items():
            want_shape = tuple(ref[0].shape) if t is not None else None
            w = want_spec
            if layer is not None:
                assert not w or w[0] is None
                w = w[1:]
                if t is not None:
                    assert len(leaves) == want_shape[0]
                    want_shape = want_shape[1:]
            assert spec == w, ref_path
            if t is not None:
                assert tuple(t.shape) == want_shape, ref_path
                assert str(t.dtype).split(".")[1] == str(ref[0].dtype), \
                    ref_path
                assert t.is_meta


def _cells():
    bonus = [(a, s) for a in ("gat-bonus", "gin-bonus")
             for s in get_arch(a).shapes]
    return all_cells() + bonus


@pytest.mark.parametrize("arch", list(dict.fromkeys(a for a, _ in _cells())))
def test_build_step_matches_reference_in_every_cell(arch):
    assert [c for c in all_cells()] == list(ref_all_cells())
    mesh = ref_smoke_mesh()
    family = get_arch(arch).family
    for a, shape in _cells():
        if a != arch:
            continue
        ref = ref_steps.build_step(arch, shape, mesh)
        got = steps.build_step(arch, shape, ONE)
        assert got.meta == ref.meta, shape
        assert got.donate_argnums == ref.donate_argnums, shape
        assert got.rules.rules == ref.rules.rules, shape
        names = Names(got.abstract_args[0], family)
        kind = got.meta["kind"]
        port_in = steps.flat_leaves(got.abstract_args, got.in_specs)
        ref_in = {p: (x, _ref_flat(ref.in_shardings)[p])
                  for p, x in _ref_flat(ref.abstract_args).items()}
        _compare(port_in, ref_in, kind, names)
        ref_out = {p[2:]: (None, s) for p, s in _ref_flat(
            {"o": ref.out_shardings}).items()}
        port_out = {p[2:]: (None, s) for p, s in _port_flat(
            {"o": got.out_specs}).items()}
        _compare(port_out, ref_out, kind, names, out=True)


# ---------------------------------------------------------------------------
# one step from a bundle, on the CPU, against the reference's
# ---------------------------------------------------------------------------


def test_lm_bundle_train_step_matches_reference():
    """llama3-8b's smoke cut at grad_accum 2: the bundle's fn on CPU
    tensors with the reference's weights gives the reference bundle's
    loss within 1e-4."""
    cfg = dataclasses.replace(smoke_config("llama3-8b"), grad_accum=2)
    ref_cfg = dataclasses.replace(ref_smoke_config("llama3-8b"),
                                  grad_accum=2)
    spec = dataclasses.replace(get_arch("llama3-8b"), model=cfg)
    ref_spec = dataclasses.replace(ref_get_arch("llama3-8b"), model=ref_cfg)
    ref_bundle = ref_steps._lm_bundle(ref_spec, RefLMShape("t", 16, 4,
                                                           "train"),
                                      ref_smoke_mesh())
    bundle = steps._lm_bundle(spec, LMShape("t", 16, 4, "train"), ONE)
    params = RefLM(ref_cfg).init(jax.random.key(3))
    port = params_from_jax(LM(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (2, 4, 16)).astype(np.int32)
    with jax.set_mesh(ref_smoke_mesh()):
        _, _, want = ref_bundle.fn(params, ref_init_opt_state(params),
                                   jnp.asarray(toks[0]), jnp.asarray(toks[1]))
    out_params, _, got = bundle.fn(
        port, init_opt_state(dict(port.named_parameters())),
        torch.from_numpy(toks[0]), torch.from_numpy(toks[1]))
    assert set(out_params) == set(dict(port.named_parameters()))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_gnn_bundle_train_step_matches_reference():
    """graphsage-reddit on a small full graph: the bundle's fn on CPU
    tensors with the reference's weights gives the reference bundle's
    loss within 1e-4."""
    over = dict(d_hidden=16, n_classes=5)
    spec = dataclasses.replace(get_arch("graphsage-reddit"),
                               model=dataclasses.replace(
                                   get_arch("graphsage-reddit").model, **over))
    ref_spec = dataclasses.replace(ref_get_arch("graphsage-reddit"),
                                   model=dataclasses.replace(
                                       ref_get_arch("graphsage-reddit").model,
                                       **over))
    shape = dict(kind="full_graph", n_nodes=60, n_edges=400, d_feat=7)
    bundle = gnn_steps.gnn_bundle(spec, GraphShape("s", **shape), ONE)
    ref_bundle = ref_gnn_steps.gnn_bundle(ref_spec, RefGraphShape(
        "s", **shape), ref_smoke_mesh())
    cell = gnn_steps.GNNCell(**bundle.meta["cell"])
    rng = np.random.default_rng(9)
    arrays = {"feats": rng.standard_normal((60, 7)).astype(np.float32),
              "src": rng.integers(0, 60, 400).astype(np.int32),
              "dst": rng.integers(0, 60, 400).astype(np.int32),
              "labels": rng.integers(-1, 5, 60).astype(np.int32)}
    batch = gnn_steps.gnn_batch(cell, arrays, "cpu")
    params = ref_build_gnn(ref_spec.model).init(jax.random.key(1), 7, 5)
    port = gnn_params_from_jax(gnn_steps.gnn_model(spec, cell, device="cpu"),
                               jax.tree.map(np.asarray, params))
    _, _, want = ref_bundle.fn(params, ref_init_opt_state(params),
                               {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
    _, _, got = bundle.fn(port, init_opt_state(dict(port.named_parameters())),
                          batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# meshes and peaks
# ---------------------------------------------------------------------------


def test_stand_in_meshes_match_the_reference_layouts():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    got, want = make_mesh_for(1), ref_make_mesh_for(1)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape) and got.size == want.size
    assert make_mesh_for(32, model_parallel=4).shape == {"data": 8,
                                                         "model": 4}
    assert stand_in(("a",), (3,)).size == 3
    assert HW == {"peak_flops_bf16": 989e12, "peak_flops_fp32": 67e12,
                  "hbm_bw": 3.35e12, "hbm_bytes": 80e9, "nvlink_bw": 900e9,
                  "link_bw": 50e9}


def test_smoke_mesh_is_a_one_rank_gloo_device_mesh(tmp_path):
    """In a process of its own (it starts the default process group)."""
    code = ("import json, sys\n"
            "from repro_torch.launch.mesh import make_smoke_mesh\n"
            "import torch.distributed as dist\n"
            "m = make_smoke_mesh('cpu')\n"
            "json.dump({'names': list(m.mesh_dim_names),"
            " 'shape': list(m.shape), 'backend': dist.get_backend(),"
            " 'world': dist.get_world_size()}, sys.stdout)\n"
            "dist.destroy_process_group()\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) == {"names": ["data", "model"],
                                      "shape": [1, 1], "backend": "gloo",
                                      "world": 1}
