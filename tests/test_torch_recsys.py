"""Two-sided tests of the port's recsys family against the reference.

The same numpy-seeded inputs go through ``repro`` (JAX, on the CPU) and
``repro_torch`` (on the CPU, where the embedding bag's ``gather_scatter``
takes its plain version), with the reference's parameters loaded by
``autoint_params_from_jax``: the reference's own recsys cases, the dense
and ragged bags in every mode, AutoInt's logits and gradients, retrieval,
the rules and the padded fields, the 40 cells, and one
``recsys_train_step`` (and the serve and retrieval steps) against the
reference's ``recsys_bundle(...).fn``.

Tolerances: the bags 1e-6 (the same float32 adds; the mean over H = 2^k
divides exactly on both sides, otherwise by one rounding); AutoInt's
logits and scores 1e-5, its gradients 1e-5 of each leaf's largest (float32
einsums summed in another order by XLA and by torch); retrieval ids
equal; the train step's loss, gradient norm and updated parameters 1e-4,
as the GNN's step is held.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import RecsysConfig as RefRecsysConfig
from repro.configs.base import RecsysShape as RefRecsysShape
from repro.launch import recsys_steps as ref_steps
from repro.launch.mesh import make_smoke_mesh
from repro.models.recsys.autoint import AutoInt as RefAutoInt
from repro.models.recsys.embedding_bag import (
    embedding_bag_dense as ref_bag_dense,
    embedding_bag_ragged as ref_bag_ragged)
from repro.training.optimizer import init_opt_state as ref_init_opt_state
from repro_torch.configs import ASSIGNED, all_cells, get_arch
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.gather_scatter.ops import EdgeCSR
from repro_torch.launch import recsys_steps
from repro_torch.models.recsys import (AutoInt, autoint_params_from_jax,
                                       embedding_bag_dense,
                                       embedding_bag_ragged)
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.tree import flatten_with_paths

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

BAG = dict(rtol=0, atol=1e-6)
MODEL = dict(rtol=0, atol=1e-5)
TINY = dict(kind="autoint", n_sparse=6, embed_dim=8, n_attn_layers=2,
            n_heads=2, d_attn=16, vocab_per_field=100, multi_hot=3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_recsys.py), on the port
# ---------------------------------------------------------------------------


def test_embedding_bag_dense_matches_manual():
    rng = np.random.default_rng(0)
    f, v, d, b, h = 3, 50, 4, 6, 2
    table = rng.standard_normal((f, v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, f, h)).astype(np.int32)
    out = embedding_bag_dense(_t(table), _t(ids), mode="mean")
    manual = np.stack([
        np.stack([table[fi, ids[bi, fi]].mean(0) for fi in range(f)])
        for bi in range(b)])
    np.testing.assert_allclose(out.numpy(), manual, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_dense(mode):
    rng = np.random.default_rng(1)
    v, d, b, h = 40, 8, 5, 3
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids2d = rng.integers(0, v, (b, h))
    flat = _t(ids2d.reshape(-1).astype(np.int32))
    offsets = _t((np.arange(b) * h).astype(np.int32))
    ragged = embedding_bag_ragged(_t(table), flat, offsets, b, mode=mode)
    dense = embedding_bag_dense(_t(table)[None], _t(ids2d[:, None, :]),
                                mode=mode)[:, 0]
    np.testing.assert_allclose(ragged.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_embedding_bag_ragged_variable_lengths():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    ids = _t(np.array([1, 2, 3, 7, 8, 9, 9], np.int32))
    offsets = _t(np.array([0, 3, 5], np.int32))     # bags: 3, 2, 2 items
    out = embedding_bag_ragged(_t(table), ids, offsets, 3, mode="sum")
    np.testing.assert_allclose(out[0].numpy(), table[[1, 2, 3]].sum(0),
                               rtol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), table[[9, 9]].sum(0),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny AutoInt (6 fields padded to 8) and the port's
    with the same parameters."""
    ref = RefAutoInt(RefRecsysConfig(**TINY), n_fields_padded=8)
    params = ref.init(jax.random.key(0))
    port = AutoInt(RecsysConfig(**TINY), n_fields_padded=8, device="cpu")
    autoint_params_from_jax(port, jax.tree.map(np.asarray, params))
    return ref, params, port


def _mask(f=8, real=6):
    return (np.arange(f) < real).astype(np.float32)


def test_autoint_forward(tiny):
    _, _, port = tiny
    ids = np.random.default_rng(3).integers(0, 100, (4, 8, 3))
    lg = port.logits(_t(ids.astype(np.int32)), _t(_mask()))
    assert lg.shape == (4,)
    assert torch.isfinite(lg).all()


def test_autoint_padded_fields_are_inert(tiny):
    ref, params, port = tiny
    ids = np.random.default_rng(4).integers(0, 100, (4, 8, 3)).astype(
        np.int32)
    ids2 = ids.copy()
    ids2[:, 6:] = (ids2[:, 6:] + 13) % 100              # perturb padded fields
    with torch.no_grad():
        lg1 = port.logits(_t(ids), _t(_mask()))
        lg2 = port.logits(_t(ids2), _t(_mask()))
    np.testing.assert_allclose(lg1.numpy(), lg2.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = ref.logits(params, jnp.asarray(ids2), jnp.asarray(_mask()))
    np.testing.assert_allclose(lg2.numpy(), np.asarray(want), **MODEL)


def test_autoint_training_decreases_loss(tiny):
    _, _, port = tiny
    rng = np.random.default_rng(5)
    model = AutoInt(RecsysConfig(**TINY), n_fields_padded=8, device="cpu")
    model.load_state_dict(port.state_dict())
    ids = _t(rng.integers(0, 100, (64, 8, 3)).astype(np.int32))
    labels = _t(rng.integers(0, 2, 64).astype(np.float32))
    loss = model.loss_fn(ids, labels, _t(_mask()))
    l0 = float(loss.detach())
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(0.5 * p.grad)
        assert float(model.loss_fn(ids, labels, _t(_mask()))) < l0


def test_retrieval_topk_matches_ref(tiny):
    _, _, port = tiny
    rng = np.random.default_rng(6)
    qids = _t(rng.integers(0, 100, (1, 8, 3)).astype(np.int32))
    cands = rng.standard_normal((1000, port.d_repr)).astype(np.float32)
    vals, idx = port.score_candidates(qids, _t(cands), k=10,
                                      field_mask=_t(_mask()))
    with torch.no_grad():
        q = port.representation(qids, _t(_mask()))[0].numpy()
    ref_idx = np.argsort(-(cands @ q))[:10]
    assert set(idx.tolist()) == set(ref_idx.tolist())
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32


# ---------------------------------------------------------------------------
# the bags against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_dense_matches_reference(mode, weighted):
    rng = np.random.default_rng(7)
    f, v, d, b, h = 5, 60, 6, 9, 4
    table = rng.standard_normal((f, v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, f, h)).astype(np.int32)
    ids[:, 0] = 3                         # one row in every bag of field 0
    w = rng.standard_normal((b, f, h)).astype(np.float32) if weighted \
        else None
    got = embedding_bag_dense(_t(table), _t(ids), mode,
                              None if w is None else _t(w))
    want = ref_bag_dense(jnp.asarray(table), jnp.asarray(ids), mode,
                         None if w is None else jnp.asarray(w))
    assert got.shape == (b, f, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_dense_gradient_matches_jax(mode):
    """The tables' gradient (the kernel's backward over the CSR by
    source) against ``jax.grad`` of the reference bag."""
    rng = np.random.default_rng(8)
    f, v, d, b, h = 3, 20, 5, 7, 4
    table = rng.standard_normal((f, v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, f, h)).astype(np.int32)
    cot = rng.standard_normal((b, f, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(ref_bag_dense(
        t, jnp.asarray(ids), mode) * cot))(jnp.asarray(table))
    tt = _t(table).requires_grad_()
    (embedding_bag_dense(tt, _t(ids), mode) * _t(cot)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), **BAG)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_reference(mode):
    """Variable lengths, an empty bag (0 under sum and mean, -inf under
    max) and ids before the first offset, which belong to no bag."""
    rng = np.random.default_rng(9)
    table = rng.standard_normal((25, 3)).astype(np.float32)
    ids = rng.integers(0, 25, 12).astype(np.int32)
    offsets = np.array([2, 2, 6, 7, 7, 12], np.int32)   # bags 0, 3, 5 empty
    got = embedding_bag_ragged(_t(table), _t(ids), _t(offsets), 6, mode)
    want = np.asarray(ref_bag_ragged(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(offsets), 6, mode))
    np.testing.assert_allclose(got.numpy(), want, **BAG)
    empty = got[[0, 3, 5]]
    if mode == "max":
        assert torch.isneginf(empty).all()
    else:
        assert (empty == 0).all()


@pytest.mark.parametrize("per_row", [1, 4, 70])
def test_regular_csr_equals_sorted_build(per_row):
    """``EdgeCSR.regular`` (no sort) gives ``EdgeCSR.build``'s CSR for
    edges in destination order; at 70 a row every row is long."""
    rng = np.random.default_rng(per_row)
    n, n_src = 13, 50
    src = _t(rng.integers(0, n_src, n * per_row).astype(np.int32))
    reg = EdgeCSR.regular(src, per_row, n_src)
    dst = torch.arange(n * per_row, dtype=torch.int32) // per_row
    assert torch.equal(reg.dst, dst) and reg.n_nodes == n
    built = EdgeCSR.build(src, dst, n, n_src)
    for name in ("ptr", "perm", "col", "count", "long_rows", "n_long",
                 "work"):
        assert torch.equal(getattr(reg.rows, name),
                           getattr(built.rows, name)), name
    assert reg.rows.long_min == built.rows.long_min
    assert torch.equal(reg.count, built.count)
    assert torch.equal(reg.transposed().col, built.transposed().col)
    with pytest.raises(ValueError, match="rows of 3"):
        EdgeCSR.regular(src[:10], 3, n_src)


# ---------------------------------------------------------------------------
# AutoInt against the reference
# ---------------------------------------------------------------------------


def test_autoint_logits_and_gradients_match_reference(tiny):
    ref, params, port = tiny
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 100, (16, 8, 3)).astype(np.int32)
    labels = rng.integers(0, 2, 16).astype(np.float32)
    mask = _mask()
    want_lg = ref.logits(params, jnp.asarray(ids), jnp.asarray(mask))
    want_rep = ref.representation(params, jnp.asarray(ids),
                                  jnp.asarray(mask))
    loss, grads = jax.value_and_grad(ref.loss_fn)(
        params, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
    port.zero_grad()
    got = port.loss_fn(_t(ids), _t(labels), _t(mask))
    got.backward()
    with torch.no_grad():
        np.testing.assert_allclose(port.logits(_t(ids), _t(mask)).numpy(),
                                   np.asarray(want_lg), **MODEL)
        np.testing.assert_allclose(
            port.representation(_t(ids), _t(mask)).numpy(),
            np.asarray(want_rep), **MODEL)
    np.testing.assert_allclose(float(got.detach()), float(loss), **MODEL)
    named = dict(port.named_parameters())
    flat = flatten_with_paths(jax.tree.map(np.asarray, grads))
    assert {p.replace("/", ".") for p in flat} == set(named)
    for path, want in flat.items():
        g = named[path.replace("/", ".")].grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=path)
    # padded fields' tables get no gradient, on either side
    assert (named["tables"].grad[6:] == 0).all()


def test_score_candidates_match_reference(tiny):
    ref, params, port = tiny
    rng = np.random.default_rng(11)
    qids = rng.integers(0, 100, (1, 8, 3)).astype(np.int32)
    cands = rng.standard_normal((3000, port.d_repr)).astype(np.float32)
    cands[1500:1510] = cands[20]            # ties go to the lower row
    want_v, want_i = ref.score_candidates(params, jnp.asarray(qids),
                                          jnp.asarray(cands), k=40,
                                          field_mask=jnp.asarray(_mask()))
    vals, idx = port.score_candidates(_t(qids), _t(cands), k=40,
                                      field_mask=_t(_mask()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), **MODEL)


def test_autoint_params_from_jax_rejects_a_mismatched_tree(tiny):
    _, params, port = tiny
    tree = jax.tree.map(np.asarray, params)
    tree["w_out"] = tree["w_out"][:-1]
    with pytest.raises(ValueError, match="w_out"):
        autoint_params_from_jax(port, tree)
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"][1]
    with pytest.raises(ValueError, match="layers.1"):
        autoint_params_from_jax(port, tree)


def test_build_model_builds_autoint_on_the_cpu_only_when_asked(monkeypatch):
    spec = dataclasses.replace(get_arch("autoint"), model=RecsysConfig(
        **TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(spec)
    model = build_model(spec, device="cpu")
    assert isinstance(model, AutoInt) and model.f == 6
    ref = RefAutoInt(RefRecsysConfig(**TINY))
    shapes = jax.eval_shape(ref.init, jax.random.key(0))
    assert {p.replace("/", "."): tuple(s.shape) for p, s in
            flatten_with_paths(shapes).items()} == \
        {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in model.parameters())


# ---------------------------------------------------------------------------
# configs, rules, cells and the steps
# ---------------------------------------------------------------------------


def test_autoint_config_and_cells_match_reference():
    ref, port = ref_get_arch("autoint"), get_arch("autoint")
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert {k: dataclasses.asdict(v) for k, v in port.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    assert (port.name, port.family, port.source) == \
        (ref.name, ref.family, ref.source)
    from repro.configs import ASSIGNED as REF_ASSIGNED
    assert ASSIGNED == REF_ASSIGNED
    assert all_cells() == ref_all_cells() and len(all_cells()) == 40


@pytest.mark.parametrize("model_axis", [1, 16])
def test_recsys_rules_and_field_padding_match_reference(model_axis):
    m = dict(axis_names=("data", "model"),
             shape={"data": 2, "model": model_axis})
    rules = recsys_steps.recsys_rules(SimpleNamespace(**m))
    assert rules.rules == ref_steps.recsys_rules(SimpleNamespace(**m)).rules
    spec = get_arch("autoint")
    f_pad = recsys_steps.fields_padded(spec, SimpleNamespace(**m))
    assert f_pad == ref_steps._pad_to(spec.model.n_sparse, model_axis)
    assert f_pad == (39 if model_axis == 1 else 48)


def _bundle_pair(kind):
    spec = dataclasses.replace(get_arch("autoint"),
                               model=RecsysConfig(**TINY))
    ref_spec = dataclasses.replace(ref_get_arch("autoint"),
                                   model=RefRecsysConfig(**TINY))
    shape = dict(train=dict(kind="train", batch=16),
                 serve=dict(kind="serve", batch=16),
                 retrieval=dict(kind="retrieval", batch=1,
                                n_candidates=500))[kind]
    bundle = ref_steps.recsys_bundle(ref_spec, RefRecsysShape("s", **shape),
                                     make_smoke_mesh())
    model = RefAutoInt(ref_spec.model, n_fields_padded=6)
    params = model.init(jax.random.key(1))
    port = recsys_steps.recsys_model(spec, device="cpu")
    autoint_params_from_jax(port, jax.tree.map(np.asarray, params))
    return spec, bundle, params, port


def test_recsys_train_step_matches_reference_bundle():
    """One step of the reference's ``recsys_bundle(...).fn`` on a one-device
    CPU mesh against ``recsys_train_step``: loss, gradient norm, lr and
    every parameter after AdamW within 1e-4."""
    spec, bundle, params, port = _bundle_pair("train")
    assert bundle.meta["f_pad"] == port.f == 6
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 100, (16, 6, 3)).astype(np.int32)
    labels = rng.integers(0, 2, 16).astype(np.float32)
    new_params, _, met = bundle.fn(params, ref_init_opt_state(params),
                                   jnp.asarray(ids), jnp.asarray(labels))
    opt = init_opt_state(dict(port.named_parameters()))
    opt, got = recsys_steps.recsys_train_step(port, opt, _t(ids),
                                              _t(labels))
    assert int(opt["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(met[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    want = autoint_params_from_jax(
        recsys_steps.recsys_model(spec, device="cpu"),
        jax.tree.map(np.asarray, new_params))
    for (name, p), (_, q) in zip(port.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_recsys_serve_and_retrieval_steps_match_reference_bundles():
    rng = np.random.default_rng(13)
    _, bundle, params, port = _bundle_pair("serve")
    ids = rng.integers(0, 100, (16, 6, 3)).astype(np.int32)
    np.testing.assert_allclose(
        recsys_steps.recsys_serve_step(port, _t(ids)).numpy(),
        np.asarray(bundle.fn(params, jnp.asarray(ids))), **MODEL)
    _, bundle, params, port = _bundle_pair("retrieval")
    assert bundle.meta["n_cand"] == 500
    qids = rng.integers(0, 100, (1, 6, 3)).astype(np.int32)
    cands = rng.standard_normal((500, port.d_repr)).astype(np.float32)
    want_v, want_i = bundle.fn(params, jnp.asarray(qids), jnp.asarray(cands))
    vals, idx = recsys_steps.recsys_retrieval_step(port, _t(qids),
                                                   _t(cands))
    assert idx.shape == (100,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), **MODEL)
