"""AutoInt [arXiv:1810.11921], the reference's ``models/recsys/autoint.py``:
multi-head self-attention feature interaction over sparse-field embeddings,
with huge row tables (the lookup is the hot path: ``embedding_bag.py``).

Fields may be padded past ``cfg.n_sparse`` (39 -> 48 on a model axis of
16); a field mask keeps the padded fields out of the interaction.  The
interaction's products are float32 einsums, as the reference computes
them outside any kernel (no TF32: ``device.resolve_device``).  Retrieval
scores one query against the candidates with the ``ivf_scan`` kernel's
inner product and top-k (``lax.top_k``'s order: ties to the lower row).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.models.layers import dense_init_, embed_init_
from repro_torch.models.recsys.embedding_bag import embedding_bag_dense
from repro_torch.training.tree import flatten_with_paths


class AutoInt(nn.Module):
    """AutoInt's parameters, float32 on ``device`` (default: the CUDA card;
    with no card and no device named it raises), named as the reference's
    tree: ``tables`` [F, V, D], ``layers.{i}.{wq,wk,wv}`` [d_in, heads,
    d_attn / heads] and ``layers.{i}.w_res`` [d_in, d_attn], ``w_out``
    [F d_attn, 1].  Drawn from ``generator`` (default: seed 0 on that
    device) in that order: the tables 0.02 x a normal, the matrices
    truncated normals of their fan-in (``autoint_params_from_jax`` loads
    the reference's own)."""

    def __init__(self, cfg: RecsysConfig,
                 n_fields_padded: Optional[int] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.f_real = cfg.n_sparse
        self.f = n_fields_padded or cfg.n_sparse
        self.d_repr = self.f * cfg.d_attn    # final representation width
        self.device = resolve_device(device)

        def param(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=self.device))

        hk = cfg.d_attn // cfg.n_heads
        self.tables = param(self.f, cfg.vocab_per_field, cfg.embed_dim)
        layers = []
        d_in = cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            layers.append(nn.ParameterDict({
                "wq": param(d_in, cfg.n_heads, hk),
                "wk": param(d_in, cfg.n_heads, hk),
                "wv": param(d_in, cfg.n_heads, hk),
                "w_res": param(d_in, cfg.d_attn)}))
            d_in = cfg.d_attn
        self.layers = nn.ModuleList(layers)
        self.w_out = param(self.d_repr, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        embed_init_(self.tables, generator)
        for lp in self.layers:
            for name in ("wq", "wk", "wv", "w_res"):
                dense_init_(lp[name], lp[name].shape[0], generator)
        dense_init_(self.w_out, self.d_repr, generator)

    # -- forward -----------------------------------------------------------

    def representation(self, ids: torch.Tensor,
                       field_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """ids [B, F, H] -> the sample's representation [B, F d_attn]."""
        x = embedding_bag_dense(self.tables, ids, mode="mean")   # [B, F, D]
        if field_mask is not None:
            x = x * field_mask[None, :, None]
        for lp in self.layers:
            q = torch.einsum("bfd,dhk->bfhk", x, lp["wq"])
            k = torch.einsum("bfd,dhk->bfhk", x, lp["wk"])
            v = torch.einsum("bfd,dhk->bfhk", x, lp["wv"])
            scores = torch.einsum("bfhk,bghk->bhfg", q, k)
            if field_mask is not None:
                scores = torch.where(field_mask[None, None, None, :] > 0,
                                     scores, -1e30)
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhfg,bghk->bfhk", probs, v)
            ctx = ctx.reshape(ctx.shape[0], ctx.shape[1], -1)  # [B, F, d_attn]
            x = torch.relu(ctx + torch.einsum("bfd,de->bfe", x,
                                              lp["w_res"]))
        return x.reshape(x.shape[0], -1)

    def logits(self, ids: torch.Tensor,
               field_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.representation(ids, field_mask) @ self.w_out[:, 0]

    def loss_fn(self, ids: torch.Tensor, labels: torch.Tensor,
                field_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Binary cross-entropy of the logits, clipped to [-30, 30]."""
        lg = torch.clamp(self.logits(ids, field_mask), -30, 30)
        return torch.mean(torch.clamp(lg, min=0) - lg * labels
                          + torch.log1p(torch.exp(-torch.abs(lg))))

    @torch.no_grad()
    def score_candidates(self, query_ids: torch.Tensor,
                         cand_reps: torch.Tensor, k: int = 100,
                         field_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """retrieval_cand: one query [1, F, H] against the candidates'
        representations [N, F d_attn] -> (scores [k] float32, rows [k]
        int32): the inner products' top-k through ``ivf_scan_topk``, in
        ``lax.top_k`` order.  No gradient."""
        q = self.representation(query_ids, field_mask)      # [1, R]
        vals, idx = ivf_scan_topk(q[:1].contiguous(), cand_reps, k, "ip")
        return vals[0], idx[0]


@torch.no_grad()
def autoint_params_from_jax(model: AutoInt, tree: Dict[str, Any]) -> AutoInt:
    """Load the reference AutoInt's parameter pytree (numpy arrays, or
    anything ``np.asarray`` takes) into ``model``, which is returned: each
    leaf by its path (``layers/0/wq`` is ``layers.0.wq``).  A leaf set or a
    shape that does not match the model raises."""
    flat = {path.replace("/", "."): np.array(leaf, dtype=np.float32)
            for path, leaf in flatten_with_paths(tree).items()}
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"autoint_params_from_jax: the tree's leaves "
                         f"{sorted(set(flat) ^ set(params))} do not match "
                         f"the model's")
    for name, p in params.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"autoint_params_from_jax: {name} has shape "
                             f"{flat[name].shape}, the model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(flat[name]))
    return model
