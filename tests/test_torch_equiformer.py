"""Equiformer-v2 in the port against the reference, and its chunked
aggregation (``torch.autograd.Function``) against its flat path, mirroring
``tests/test_equiformer_vjp.py``: values and gradients, masked edges,
rotation invariance, and the port's chunked gradients against the
reference's custom VJP.

Tolerances: the port's chunked path against its flat path 1e-5 in values
and 1e-5 absolute in gradients (the same float32 operations, summed chunk
by chunk: the reference's own test allows 1e-4 / 1e-3); the port's chunked
gradients against the reference's 1e-4 of each leaf's largest; rotation
invariance 5e-3, as the reference's test (float32 Wigner matrices up to
l = 3 composed over two layers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import GNNConfig as RefGNNConfig
from repro.models.gnn import build_gnn as ref_build_gnn
from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import build_gnn, gnn_params_from_jax
from test_torch_gnn import EQUIFORMER, _grads_close, \
    check_model_against_reference

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)


@pytest.mark.parametrize("name", EQUIFORMER)
def test_equiformer_logits_and_grads_match_reference(name):
    """l_max 2 / m_max 1, and the config's l_max 6 / m_max 2."""
    check_model_against_reference(name)


def _setup(layers=2, n=40, e=160, d=6, seed=3):
    rng = np.random.default_rng(7)
    kw = dict(kind="equiformer_v2", n_layers=layers, d_hidden=8, l_max=3,
              m_max=2, n_heads=2, n_rbf=8, cutoff=5.0, n_classes=3)
    ref = ref_build_gnn(RefGNNConfig(**kw))
    params = ref.init(jax.random.key(seed), d, 3)
    port = build_gnn(GNNConfig(**kw), d, 3, device="cpu")
    gnn_params_from_jax(port, jax.tree.map(np.asarray, params))
    data = dict(feats=rng.standard_normal((n, d)).astype(np.float32),
                pos=rng.standard_normal((n, 3)).astype(np.float32),
                src=rng.integers(0, n, e).astype(np.int32),
                dst=rng.integers(0, n, e).astype(np.int32),
                mask=(rng.random(e) > 0.3).astype(np.float32))
    return ref, params, port, data


def _run(port, data, chunk, pos=None):
    port.zero_grad()
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    lg = port(t["feats"], t["pos"] if pos is None else pos, t["src"],
              t["dst"], t["mask"], len(data["feats"]), chunk=chunk)
    torch.mean(torch.square(lg)).backward()
    return lg.detach(), {n: p.grad.clone()
                         for n, p in port.named_parameters()}


@pytest.mark.parametrize("layers", [2, 4])
def test_chunked_matches_flat_with_masked_edges(layers):
    """Chunks of 16, 32 and 80 edges against the flat path, 20-30% of the
    edges masked; at 4 layers the chunked path also runs the grouped
    remat (torch.utils.checkpoint)."""
    _, _, port, data = _setup(layers)
    flat, g_flat = _run(port, data, None)
    for chunk in (16, 32, 80):
        got, g = _run(port, data, chunk)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0,
                                   atol=1e-5)
        for name in g:
            np.testing.assert_allclose(g[name].numpy(), g_flat[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_chunked_grads_match_reference_custom_vjp():
    ref, params, port, data = _setup(4)
    args = [jnp.asarray(data[k]) for k in ("feats", "pos", "src", "dst",
                                            "mask")]

    def loss(p):
        return jnp.mean(jnp.square(ref.node_logits(p, *args, 40, chunk=32)))

    want = jax.grad(loss)(params)
    _run(port, data, 32)
    _grads_close(port, want)


def test_chunked_equivariance_preserved():
    _, _, port, data = _setup()
    rng = np.random.default_rng(9)
    a = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    if np.linalg.det(a) < 0:
        a[:, 0] *= -1
    out1, _ = _run(port, data, 32)
    rot = torch.from_numpy(data["pos"] @ a.T.astype(np.float32))
    out2, _ = _run(port, data, 32, pos=rot)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=5e-3,
                               atol=5e-3)
