"""Decoder-only LM for serving: the five transformer configs of the registry.

The reference's ``models/transformer.py``: GQA with optional per-head
qk-norm, RoPE, SwiGLU, an untied or tied head; fine-grained MoE with shared
experts (DeepSeekMoE, ``models/moe.py``) after ``first_dense_layers`` dense
layers; MLA latent attention with the absorbed decode (DeepSeek-V2).
Parameters keep the reference's stacked layout, one stack of dense layers
(``layers``: ``wq`` [L, d, H, hd], ``wo`` [L, H, hd, d], ...) and, for a
MoE config, one of MoE layers (``moe_layers``), so :func:`params_from_jax`
loads a reference param tree as it is.  ``param_axes`` and
``cache_axes`` name each tensor's logical axes for the step bundles'
partition specs (``launch/steps.py``).  ``rules`` (None by default) are
the cell's sharding rules: on DTensors the model constrains its
activations at the reference's points by their logical names
(``constrain``), and off a mesh nothing changes.  On the card the GQA
prefill and MLA's prefill run through the hand-written flash-attention
kernel and the GQA decode through the decode-attention kernel; on the CPU
through their plain versions.
MLA's absorbed decode is plain torch in float32, as the reference's is.

Training: ``loss_fn`` is the reference's (float32 logits, cross-entropy
plus ``AUX_LOSS_COEF`` times the MoE layers' summed aux loss), and its
gradient runs through every layer, attention through the flash kernel's
``torch.autograd.Function`` (``models/attention.py``).  Under
``cfg.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` with ``nothing_saveable``).  ``forward``, ``prefill``
and ``decode_step`` serve under ``torch.no_grad``: they build no graph.
:func:`params_to_jax_tree` maps the parameters, or their gradients, back
to the reference's tree.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.layers import (
    apply_rotary,
    dense_init_,
    embed_init_,
    rms_norm,
    rotary_cos_sin,
)
from repro_torch.models.moe import (
    moe_ffn,
    moe_param_axes,
    moe_param_path,
    moe_param_shapes,
    nest_moe_params,
)

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
Layer = Dict[str, torch.Tensor]

AUX_LOSS_COEF = 0.003  # DeepSeekMoE expert-level balance coefficient

_MLP_KEYS = ("w_gate", "w_up", "w_down")


def _attn_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[Tuple, int]]:
    """The attention weights of one layer: name -> (shape, fan-in), 0 for a
    float32 norm scale (initialised to ones)."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.is_mla:
        dc, dq = cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        p = {"wkv_a": ((d, dc + dr), d), "kv_a_norm": ((dc,), 0),
             "wkv_b": ((dc, h, dn + dv), dc), "wo": ((h, dv, d), h * dv)}
        if dq:
            p.update(wq_a=((d, dq), d), q_a_norm=((dq,), 0),
                     wq_b=((dq, h, dn + dr), dq))
        else:
            p["wq"] = ((d, h, dn + dr), d)
        return p
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ((d, h, hd), d), "wk": ((d, kvh, hd), d),
         "wv": ((d, kvh, hd), d), "wo": ((h, hd, d), h * hd)}
    if cfg.qk_norm:
        p.update(q_norm=((hd,), 0), k_norm=((hd,), 0))
    return p


def _ffn_shapes(cfg: TransformerConfig, moe: bool
                ) -> Dict[str, Tuple[Tuple, int]]:
    """The FFN weights of one layer, as :func:`_attn_shapes` (a MoE
    layer's as ``moe_param_shapes`` names them)."""
    if moe:
        return moe_param_shapes(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": ((d, f), d), "w_up": ((d, f), d), "w_down": ((f, d), f)}


def _attn_axes(cfg: TransformerConfig) -> Dict[str, Tuple]:
    """The logical axes of each attention weight of one layer (the
    reference's ``_attn_axes``)."""
    if cfg.is_mla:
        p = {"wkv_a": ("p_embed", None), "kv_a_norm": (None,),
             "wkv_b": (None, "p_heads", None),
             "wo": ("p_heads", None, "p_embed")}
        if cfg.q_lora_rank:
            p.update(wq_a=("p_embed", None), q_a_norm=(None,),
                     wq_b=(None, "p_heads", None))
        else:
            p["wq"] = ("p_embed", "p_heads", None)
        return p
    p = {"wq": ("p_embed", "p_heads", None),
         "wk": ("p_embed", "p_kv_heads", None),
         "wv": ("p_embed", "p_kv_heads", None),
         "wo": ("p_heads", None, "p_embed")}
    if cfg.qk_norm:
        p.update(q_norm=(None,), k_norm=(None,))
    return p


def _layer_axes(cfg: TransformerConfig, moe: bool) -> Dict[str, Tuple]:
    """Every weight of one layer under its flat name -> its logical axes;
    a MoE layer's as ``moe_param_axes`` gives them."""
    if moe:
        nested = moe_param_axes(cfg)
        ffn = {}
        for name in moe_param_shapes(cfg):
            node = nested
            for key in moe_param_path(name):
                node = node[key]
            ffn[name] = node
    else:
        ffn = {"w_gate": ("p_embed", "p_mlp"), "w_up": ("p_embed", "p_mlp"),
               "w_down": ("p_mlp", "p_embed")}
    return {"ln1": (None,), "ln2": (None,), **_attn_axes(cfg), **ffn}


def _layer_shapes(cfg: TransformerConfig, moe: bool
                  ) -> Dict[str, Tuple[Tuple, int]]:
    """Every weight of one dense or MoE layer, as :func:`_attn_shapes`."""
    return {"ln1": ((cfg.d_model,), 0), "ln2": ((cfg.d_model,), 0),
            **_attn_shapes(cfg), **_ffn_shapes(cfg, moe)}


class LM(nn.Module):
    """Decoder-only LM on one device.

    ``LM(cfg, device=None)`` allocates the parameters on the CUDA card (or
    on ``device``) in ``cfg.dtype`` (norm scales and the router in float32)
    and initialises them there from ``generator`` (default: seed 0 on that
    device); with no card and no device named it raises.  On the ``meta``
    device nothing is allocated or drawn: the model has its parameters'
    shapes and dtypes only (the step bundles' abstract arguments).  ``layers`` holds
    the dense layers (``first_dense_layers`` of a MoE config, else all),
    ``moe_layers`` the MoE layers (None without MoE)."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.rules: Optional[ShardingRules] = None
        self.n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense if cfg.is_moe else 0
        d, v = cfg.d_model, cfg.vocab_size

        def param(*shape, dtype=self.dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device))

        f32 = torch.float32
        self.embed = param(v, d)
        self.final_norm = param(d, dtype=f32)
        self.lm_head = None if cfg.tie_embeddings else param(d, v)

        def stack(n: int, moe: bool) -> nn.ParameterDict:
            return nn.ParameterDict({
                name: param(n, *shape, dtype=f32 if fan == 0
                            or name == "router" else self.dtype)
                for name, (shape, fan) in _layer_shapes(cfg, moe).items()})

        self.layers = stack(self.n_dense, False)
        self.moe_layers = stack(self.n_moe, True) if self.n_moe else None
        if self.device.type == "meta":
            return
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def _stacks(self) -> Iterator[Tuple[str, nn.ParameterDict, int]]:
        """(cache key, parameter stack, layers) of each stack, in order."""
        yield "dense", self.layers, self.n_dense
        if self.n_moe:
            yield "moe", self.moe_layers, self.n_moe

    @staticmethod
    def _unstack(lp: nn.ParameterDict) -> Iterator[Layer]:
        """Each layer of a stack as {name: its slice} (views).  ``unbind``
        gives every slice at once, so the backward stacks one gradient for
        the whole stack instead of one full-size gradient a slice."""
        cols = {name: t.unbind(0) for name, t in lp.items()}
        for i in range(len(next(iter(cols.values())))):
            yield {name: c[i] for name, c in cols.items()}

    def param_axes(self) -> Dict[str, Tuple]:
        """The logical axes of each parameter, keyed as
        ``named_parameters()`` names it: the reference's ``param_axes``
        leaf for leaf (a stack's leading axis is ``"layers"``)."""
        top = {"embed": ("p_vocab", "p_embed"), "final_norm": (None,),
               "lm_head": ("p_embed", "p_vocab")}
        stacks = {"layers": _layer_axes(self.cfg, False),
                  "moe_layers": _layer_axes(self.cfg, True)
                  if self.n_moe else {}}
        axes: Dict[str, Tuple] = {}
        for name, _ in self.named_parameters():
            stack, _, leaf = name.partition(".")
            axes[name] = ("layers",) + stacks[stack][leaf] if leaf \
                else top[name]
        return axes

    # -- init ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's init on this model's device: 0.02-normal
        embedding, truncated-normal fan-in matrices, unit norm scales.  Each
        layer is drawn on its own, in fp32, then cast to its dtype."""
        embed_init_(self.embed, generator)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            dense_init_(self.lm_head, self.cfg.d_model, generator)
        for key, lp, n in self._stacks():
            shapes = _layer_shapes(self.cfg, key == "moe")
            for name, p in lp.items():
                fan = shapes[name][1]
                if fan == 0:
                    p.fill_(1.0)
                    continue
                for layer in range(n):
                    dense_init_(p[layer], fan, generator)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, scale, self.cfg.rms_eps, fused=self.cfg.fused_norm)

    def _gathered(self, w: torch.Tensor, axes: Tuple) -> torch.Tensor:
        """A weight as its product uses it: on DTensors its FSDP sharding
        (``p_embed``) gathered explicitly, the others kept (the
        reference's partitioner gathers it alike); the gradient comes back
        reduce-scattered to the weight's own sharding."""
        if self.rules is None or not isinstance(w, DTensor):
            return w
        from repro_torch.kernels import sharded
        fsdp = self.rules.spec(*(a if a == "p_embed" else None
                                 for a in axes))
        names = list(sharded.mesh_names(w))
        return sharded.unshard(w, [names.index(a) for a in _flat_axes(fsdp)])

    def _layer_gathered(self, p: Layer, moe: bool) -> Layer:
        """:meth:`_gathered` of every weight of one layer."""
        if self.rules is None:
            return p
        axes = _layer_axes(self.cfg, moe)
        return {n: self._gathered(t, axes[n]) for n, t in p.items()}

    def _heads_uneven(self, x: torch.Tensor) -> bool:
        """Whether x is a DTensor on whose mesh the query or the key heads
        do not divide the mesh axes of ``heads`` (:meth:`_gqa_local`)."""
        if self.rules is None or not isinstance(x, DTensor):
            return False
        from repro_torch.distributed.sharding import mesh_axes
        sizes = mesh_axes(x.device_mesh)
        k = 1
        for a in _flat_axes(self.rules.spec("heads")):
            k *= sizes.get(a, 1)
        return bool(self.cfg.n_heads % k or self.cfg.n_kv_heads % k)

    def _flat(self, w: torch.Tensor, heads: str) -> torch.Tensor:
        """w [d, H, k] (FSDP-gathered) -> [d, H * k], pinned (on DTensors)
        to (None, ``heads``)."""
        return constrain(w.reshape(w.shape[0], -1), self.rules, None, heads)

    def _rope_dim(self) -> int:
        cfg = self.cfg
        return cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim

    # -- attention ----------------------------------------------------------

    def _gqa(self, p: Layer, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, cache=None, slot: "_Slot" = None,
             want_cache: bool = False):
        cfg = self.cfg
        b, s, d = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cache is None and self._heads_uneven(x):
            return self._gqa_local(p, x, cos, sin, want_cache)
        # on DTensors the products and their weights' gradients are pinned
        # to the heads' sharding before a split: DTensor may shard the
        # columns of a product (or of its gradient) where its heads cannot go
        q = constrain(x @ self._flat(p["wq"], "p_heads"), self.rules,
                      "batch", "seq", "heads").reshape(b, s, h, hd)
        k = constrain(x @ self._flat(p["wk"], "p_kv_heads"), self.rules,
                      "batch", "seq", "kv_heads").reshape(b, s, kvh, hd)
        v = constrain(x @ self._flat(p["wv"], "p_kv_heads"), self.rules,
                      "batch", "seq", "kv_heads").reshape(b, s, kvh, hd)
        if cfg.qk_norm:
            q = self._norm(q, p["q_norm"])
            k = self._norm(k, p["k_norm"])
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if cache is None:
            q = constrain(q, self.rules, "batch", "seq", "heads", None)
            # k and v keep their KVH heads: the kernel reads head h // G
            out = chunked_attention(q, k, v, causal=True,
                                    block_kv=min(cfg.attn_block_kv, s),
                                    bf16_probs=cfg.bf16_probs)
            new_cache = (k, v)
        else:
            k_cache, v_cache = cache
            _write_rows(k_cache, k[:, 0], slot)
            _write_rows(v_cache, v[:, 0], slot)
            k_cache = constrain(k_cache, self.rules, "batch", "kv_seq",
                                "kv_heads", None)
            v_cache = constrain(v_cache, self.rules, "batch", "kv_seq",
                                "kv_heads", None)
            out = decode_attention(q, k_cache, v_cache, slot.pos)
            new_cache = cache
        o = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)
        return o, new_cache

    def _gqa_local(self, p: Layer, x: DTensor, cos: torch.Tensor,
                   sin: torch.Tensor, want_cache: bool):
        """Train or prefill attention on DTensors whose query or key heads
        do not divide the mesh axes of ``heads`` (the reference's
        partitioner pads such a head dim).  Each rank takes its query
        heads as ``torch.chunk`` splits them (rank 0 the most, a trailing
        rank maybe none) and the key heads they read, projects them from
        its shards of the weights or its slices of replicated ones, runs
        attention on its rows and heads (a kernel call on local tensors)
        and projects back: the output is a partial sum over the heads'
        mesh dims, which the residual's constraint reduces.  A query head
        group that a rank holds in part reads its key head once a query
        head.  Under ``want_cache`` each rank also projects the key and
        value heads of its share of the cache, as the cache's axes place
        it (prefill: its ``kv_seq`` rows).  -> (output, cache entry or
        None)."""
        from torch.distributed.tensor import Partial, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        from repro_torch.distributed.sharding import spec_placements
        from repro_torch.kernels import sharded

        cfg = self.cfg
        b, s, d = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        g = h // kvh
        mesh = x.device_mesh
        names = sharded.mesh_names(x)
        head_dims = [names.index(a) for a in _flat_axes(
            self.rules.spec("heads"))]
        x = sharded.keep_only(x, (0,))
        rows = list(x.placements)
        by_rows = [i for i, pl in enumerate(rows) if isinstance(pl, Shard)]
        q_pl = [Shard(2) if i in head_dims else pl
                for i, pl in enumerate(rows)]
        (bl, _, hl, _), (_, _, oq, _) = compute_local_shape_and_global_offset(
            (b, s, h, hd), mesh, q_pl)

        def local(w: torch.Tensor, dim: int, first: int, n: int):
            """w's heads first .. first + n - 1 along ``dim``, local; its
            gradient a partial sum over the rows' and the heads' mesh
            dims (the heads' only where w is whole there).  A weight the
            rules shard on its head dim holds just these heads: they shard
            it only where its heads divide the axis (``lm_rules``), and
            then the query heads split evenly too."""
            held = [i for i, pl in enumerate(w.placements)
                    if isinstance(pl, Shard) and pl.dim == dim]
            w = sharded.keep_only(w, (dim,) if held else ())
            grad = [pl if i in held else Partial()
                    if i in by_rows or i in head_dims else pl
                    for i, pl in enumerate(w.placements)]
            wl = w.to_local(grad_placements=grad)
            return wl if held else wl.narrow(dim, first, n)

        def whole(t: torch.Tensor) -> torch.Tensor:
            if not isinstance(t, DTensor):
                return t
            t = sharded.keep_only(t, ())
            return t.to_local(grad_placements=[
                Partial() if i in by_rows or i in head_dims else pl
                for i, pl in enumerate(t.placements)])

        def proj(xs, w, norm, c, sn):
            y = torch.einsum("bsd,dhk->bshk", xs, w)
            if norm is not None:
                y = self._norm(y, norm)
            return y if c is None else apply_rotary(y, c, sn)

        q_norm = whole(p["q_norm"]) if cfg.qk_norm else None
        k_norm = whole(p["k_norm"]) if cfg.qk_norm else None
        cos, sin = whole(cos), whole(sin)
        xl = x.to_local(grad_placements=[
            Partial() if i in head_dims else pl for i, pl in enumerate(rows)])
        first = oq // g
        nk = (oq + hl - 1) // g - first + 1 if hl else 0
        q = proj(xl, local(p["wq"], 1, oq, hl), q_norm, cos, sin)
        wk, wv = local(p["wk"], 1, first, nk), local(p["wv"], 1, first, nk)
        k, v = proj(xl, wk, k_norm, cos, sin), proj(xl, wv, None, None, None)
        reads = [(oq + i) // g - first for i in range(hl)]
        if any(reads.count(j) != hl // nk for j in range(nk)):
            # this rank's query heads split a group: a key head a query head
            idx = torch.tensor(reads, device=k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        if hl:
            out = chunked_attention(q, k, v, causal=True,
                                    block_kv=min(cfg.attn_block_kv, s),
                                    bf16_probs=cfg.bf16_probs)
        else:
            out = q
        o = torch.einsum("bshk,hkd->bsd", out, local(p["wo"], 0, oq, hl))
        o = sharded.wrap(o, x, [Partial() if i in head_dims else pl
                                for i, pl in enumerate(rows)], (b, s, d))
        if not want_cache:
            return o, None
        c_pl = spec_placements(mesh, self.rules.spec("batch", "kv_seq",
                                                     "kv_heads", None))
        (cb, cs, ck, _), (ob, os_, ok, _) = \
            compute_local_shape_and_global_offset((b, s, kvh, hd), mesh, c_pl)
        ob -= sharded.offset(x, 0)
        if ob < 0 or ob + cb > bl:
            raise ValueError("attention on shards: the cache's batch rows "
                             "are not this rank's rows")
        xc = xl[ob:ob + cb, os_:os_ + cs]
        kc = proj(xc, local(p["wk"], 1, ok, ck), k_norm, cos[os_:os_ + cs],
                  sin[os_:os_ + cs])
        vc = proj(xc, local(p["wv"], 1, ok, ck), None, None, None)
        return o, tuple(sharded.wrap(t, x, c_pl, (b, s, kvh, hd))
                        for t in (kc, vc))

    def _mla(self, p: Layer, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, cache=None, slot: "_Slot" = None):
        cfg = self.cfg
        b, s, d = x.shape
        dc, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        dr, dv, h = cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.n_heads
        scale = (dn + dr) ** -0.5

        if cfg.q_lora_rank:
            qc = self._norm(x @ p["wq_a"], p["q_a_norm"])
            wq = p["wq_b"]
        else:
            qc, wq = x, p["wq"]
        q = (qc @ wq.reshape(wq.shape[0], h * (dn + dr))).reshape(
            b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rotary(q_rope, cos, sin)

        kv_a = x @ p["wkv_a"]
        c_kv = self._norm(kv_a[..., :dc], p["kv_a_norm"])
        k_rope = apply_rotary(kv_a[..., None, dc:], cos, sin)[:, :, 0]
        wkv_b = p["wkv_b"]                              # [dc, H, dn + dv]
        wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]

        if cache is None:
            kv = (c_kv @ wkv_b.reshape(dc, h * (dn + dv))).reshape(
                b, s, h, dn + dv)
            k = torch.cat([kv[..., :dn],
                           k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
            qf = constrain(torch.cat([q_nope, q_rope], dim=-1), self.rules,
                           "batch", "seq", "heads", None)
            out = chunked_attention(qf, k, kv[..., dn:].contiguous(),
                                    causal=True, scale=scale,
                                    block_kv=min(cfg.attn_block_kv, s),
                                    bf16_probs=cfg.bf16_probs)
            new_cache = (c_kv, k_rope)
        else:
            # absorbed decode: score/context in the dc-wide latent space
            ckv_cache, krope_cache = cache
            _write_rows(ckv_cache, c_kv[:, 0], slot)
            _write_rows(krope_cache, k_rope[:, 0], slot)
            ckv_cache = constrain(ckv_cache, self.rules, "batch", "kv_seq",
                                  None)
            krope_cache = constrain(krope_cache, self.rules, "batch",
                                    "kv_seq", None)
            ckv = ckv_cache.float()
            q_lat = torch.einsum("bqhn,chn->bqhc", q_nope, wk_b)
            s_lat = torch.einsum("bqhc,bsc->bhqs", q_lat.float(), ckv)
            s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                                  krope_cache.float())
            scores = (s_lat + s_rope) * scale
            valid = torch.arange(ckv.shape[1], device=x.device)[None, :] \
                <= slot.pos[:, None]
            scores = torch.where(valid[:, None, None, :], scores, -1e30)
            probs = _softmax(scores)
            ctx_lat = torch.einsum("bhqs,bsc->bqhc", probs, ckv).to(x.dtype)
            out = torch.einsum("bqhc,chv->bqhv", ctx_lat, wv_b)
            new_cache = cache
        o = out.reshape(b, s, h * dv) @ p["wo"].reshape(h * dv, d)
        return o, new_cache

    # -- blocks -------------------------------------------------------------

    def _block(self, p: Layer, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, moe: bool, cache=None,
               slot: "_Slot" = None, want_cache: bool = False):
        """One layer -> (x, its aux loss (0 for a dense layer), its cache
        entry: the new one under ``want_cache``, the decode's given one)."""
        p = self._layer_gathered(p, moe)
        h = self._norm(x, p["ln1"])
        if self.cfg.is_mla:
            attn_out, new_cache = self._mla(p, h, cos, sin, cache=cache,
                                            slot=slot)
        else:
            attn_out, new_cache = self._gqa(p, h, cos, sin, cache=cache,
                                            slot=slot, want_cache=want_cache)
        x = constrain(x + attn_out, self.rules, "batch", "seq", "embed")
        h = self._norm(x, p["ln2"])
        if moe:
            ffn_out, aux = moe_ffn(nest_moe_params(
                {n: p[n] for n in moe_param_shapes(self.cfg)}), h, self.cfg,
                self.rules)
        else:
            g = F.silu(h @ p["w_gate"])
            gu = constrain(g * (h @ p["w_up"]), self.rules, "batch", "seq",
                           "mlp")
            ffn_out = gu @ p["w_down"]
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = constrain(x + ffn_out, self.rules, "batch", "seq", "embed")
        return x, aux, new_cache

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(x, self.final_norm)
        if self.cfg.tie_embeddings:
            head = self._gathered(self.embed, ("p_vocab", "p_embed")).T
        else:
            head = self._gathered(self.lm_head, ("p_embed", "p_vocab"))
        return x @ head

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _cache_shapes(self, n: int, batch: int, seq: int
                      ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The two cache tensors of a stack of ``n`` layers: (k, v) each
        [n, B, S, KVH, hd], or MLA's (c_kv [n, B, S, dc], k_rope
        [n, B, S, dr])."""
        cfg = self.cfg
        if cfg.is_mla:
            return ((n, batch, seq, cfg.kv_lora_rank),
                    (n, batch, seq, cfg.qk_rope_head_dim))
        kv = (n, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return kv, kv

    def _new_cache(self, batch: int, seq: int, alloc, like=None) -> Cache:
        """A cache of ``alloc``'s tensors; where ``like`` is a DTensor (the
        prefill's activations) each is placed on its mesh by the cache's
        axes, made without a collective (``sharding.place``)."""
        if self.rules is None or not isinstance(like, DTensor):
            return {key: tuple(alloc(shape, dtype=self.dtype,
                                     device=self.device)
                               for shape in self._cache_shapes(n, batch, seq))
                    for key, _, n in self._stacks()}
        from repro_torch.distributed.sharding import place_new
        axes = self.cache_axes()
        return {key: tuple(
            place_new(shape, self.dtype, like.device_mesh,
                      self.rules.spec(*ax), self.device)
            for shape, ax in zip(self._cache_shapes(n, batch, seq),
                                 axes[key]))
            for key, _, n in self._stacks()}

    # -- full forward (train / prefill) ---------------------------------------

    def _trunk(self, tokens: torch.Tensor, collect_cache: bool,
               remat: bool = False):
        """tokens [B, S] -> (final hidden [B, S, d], summed aux loss, cache
        | None); under ``remat`` each block is recomputed in the backward
        (no cache then)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = constrain(F.embedding(tokens, self._gathered(
            self.embed, ("p_vocab", "p_embed"))), self.rules, "batch", "seq",
            "embed")
        cos, sin = rotary_cos_sin(torch.arange(s, device=self.device),
                                  self._rope_dim(), cfg.rope_theta)
        cache = self._new_cache(b, s, torch.empty, like=x) \
            if collect_cache else None
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for key, lp, _ in self._stacks():
            moe = key == "moe"
            for i, p in enumerate(self._unstack(lp)):
                if remat:
                    x, aux_i = checkpoint(self._remat_block, p, x, cos, sin,
                                          moe, use_reentrant=False)
                else:
                    x, aux_i, layer_cache = self._block(
                        p, x, cos, sin, moe, want_cache=cache is not None)
                    if cache is not None:
                        for dst, src in zip(cache[key], layer_cache):
                            dst[i].copy_(src)
                aux = aux + aux_i
        return x, aux, cache

    def _remat_block(self, p: Layer, x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, moe: bool):
        x, aux, _ = self._block(p, x, cos, sin, moe)
        return x, aux

    @torch.no_grad()
    def forward(self, tokens, collect_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """tokens [B, S] -> (logits [B, S, V], cache | None).  The cache is
        ``{"dense": ..., "moe": ...}`` ("moe" for a MoE config only), each
        entry a pair as :meth:`init_cache` lays it out."""
        x, _, cache = self._trunk(self._tokens(tokens), collect_cache)
        return constrain(self._head(x), self.rules, "batch", "seq",
                         "vocab"), cache

    @torch.no_grad()
    def prefill(self, tokens) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] -> (last-position logits [B, V], cache).  The head
        runs on the last position only: the same values as the reference's
        ``logits[:, -1]``, without the [B, S, V] logits."""
        x, _, cache = self._trunk(self._tokens(tokens), True)
        return constrain(self._head(x[:, -1:])[:, 0], self.rules, "batch",
                         "vocab"), cache

    # -- loss ---------------------------------------------------------------

    def loss_fn(self, tokens, labels
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens, labels [B, S] -> (loss, {"ce", "aux"}), the reference's
        arithmetic: float32 logits, ce = mean(logsumexp - label logit),
        loss = ce + AUX_LOSS_COEF * aux.  The loss is differentiable (call
        it with gradients enabled), ce and aux are detached; blocks are
        recomputed in the backward under ``cfg.remat``."""
        tokens, labels = self._tokens(tokens), self._tokens(labels)
        x, aux, _ = self._trunk(tokens, False, remat=self.cfg.remat)
        logits = constrain(self._head(x), self.rules, "batch", "seq",
                           "vocab").float()
        lse = _logsumexp(logits)
        ll = _label_logit(logits, labels)
        ce = torch.mean(lse - ll)
        return ce + AUX_LOSS_COEF * aux, {"ce": ce.detach(),
                                           "aux": aux.detach()}

    # -- decode -------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A zeroed cache in ``cfg.dtype`` on this device, one pair a stack
        as the reference's ``cache_spec`` lays it out: ``{"dense": (k, v)}``
        (plus ``"moe"`` for a MoE config), each [n, batch, max_seq, KVH,
        hd]; for MLA (c_kv [n, batch, max_seq, dc], k_rope [n, batch,
        max_seq, dr]).  It takes the place of the abstract ``cache_spec``."""
        return self._new_cache(batch, max_seq, torch.zeros)

    def cache_spec(self, batch: int, max_seq: int) -> Cache:
        """:meth:`init_cache`'s layout, shapes and dtypes as ``meta``
        tensors: nothing is allocated (the reference's abstract
        ``cache_spec``)."""
        return {key: tuple(torch.empty(shape, dtype=self.dtype,
                                       device="meta")
                           for shape in self._cache_shapes(n, batch,
                                                           max_seq))
                for key, _, n in self._stacks()}

    def cache_axes(self) -> Dict[str, Tuple[Tuple, Tuple]]:
        """The logical axes of each cache tensor, laid out as the cache."""
        cfg = self.cfg
        one = (("layers", "batch", "kv_seq", None) if cfg.is_mla
               else ("layers", "batch", "kv_seq", "kv_heads", None))
        return {key: (one, one) for key, _, _ in self._stacks()}

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """One serve step: tokens [B, 1], pos [B] -> (logits [B, V], cache).

        Writes each layer's new cache rows at ``pos`` in place and returns
        the same cache; the reference (JAX) returns a new one.  A row whose
        pos >= max_seq is dropped, as the reference's ``mode="drop"``
        scatter drops it: never wrapped, never raised."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        pos = torch.as_tensor(pos, device=self.device).to(torch.int32)
        x = constrain(F.embedding(tokens, self._gathered(
            self.embed, ("p_vocab", "p_embed"))), self.rules, "batch", "seq",
            "embed")
        cos, sin = rotary_cos_sin(pos[:, None].float(), self._rope_dim(),
                                  cfg.rope_theta)
        slot = _Slot(pos, cache["dense"][0].shape[2])
        for key, lp, _ in self._stacks():
            first, second = cache[key]
            for i, p in enumerate(self._unstack(lp)):
                x, _, _ = self._block(p, x, cos, sin, key == "moe",
                                      cache=(first[i], second[i]), slot=slot)
        return constrain(self._head(x)[:, 0], self.rules, "batch",
                         "vocab"), cache


def _flat_axes(spec) -> list:
    """The mesh axes a partition spec names, in order."""
    out = []
    for e in spec:
        out += [] if e is None else [e] if isinstance(e, str) else list(e)
    return out


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last dim.  Where a DTensor's last dim is sharded
    (MLA's decode scores over a position-sharded cache) it is taken as
    exp(x - max) / sum: an all-reduce of the max and one of the sum over
    the sharding mesh dims, the flash-decoding combine, where DTensor's own
    softmax would gather the whole dim."""
    if isinstance(x, DTensor):
        from repro_torch.kernels import sharded
        if sharded.sharded_over(x, x.dim() - 1):
            e = torch.exp(x - x.amax(dim=-1, keepdim=True))
            return e / e.sum(dim=-1, keepdim=True)
    return torch.softmax(x, dim=-1)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  Where a DTensor's last dim is sharded
    it is taken as max + log(sum(exp(x - max))): an all-reduce of the max
    and one of the sum over the sharding mesh dims, where DTensor's own
    logsumexp would gather the whole dim."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    from repro_torch.kernels import sharded
    if not sharded.sharded_over(x, x.dim() - 1):
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)))[
        ..., 0]


def _label_logit(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """logits [B, S, V], labels [B, S] -> each label's logit [B, S].  On a
    DTensor whose vocab is sharded each rank gathers the labels that fall
    in its columns (0 for the others): a partial sum over the vocab's mesh
    dims, where DTensor's own gather would replicate the logits' gradient
    in the backward."""
    if isinstance(logits, DTensor):
        from repro_torch.kernels import sharded
        if sharded.sharded_over(logits, 2):
            return _label_logit_on_shards(logits, labels)
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def _label_logit_on_shards(logits: DTensor, labels) -> DTensor:
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import sharded

    logits = sharded.keep_only(logits, (0, 2))
    labels = sharded.follow(labels, logits, {0: 0})
    first = sharded.offset(logits, 2)
    out_pl = [p if p.is_shard() and p.dim == 0 else
              sharded.Partial() if p.is_shard() else Replicate()
              for p in logits.placements]

    def local(lg, lab):
        col = lab.long() - first
        mine = (col >= 0) & (col < lg.shape[-1])
        v = torch.gather(lg, -1, col.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(mine, v[..., 0], 0.0)
    return local_map(local, out_placements=(out_pl,),
                     in_placements=(logits.placements, labels.placements),
                     in_grad_placements=(logits.placements,
                                         labels.placements),
                     device_mesh=logits.device_mesh)(logits, labels)


class _Slot:
    """Where one decode step writes each row's new cache entry, computed
    once a step: row b goes to position pos[b], and a row with
    pos >= max_seq is dropped without a host sync (it writes back the value
    already at max_seq - 1)."""

    def __init__(self, pos: torch.Tensor, max_seq: int) -> None:
        self.pos = pos
        self.max_seq = max_seq
        self.rows = torch.arange(pos.shape[0], device=pos.device)
        self.at = pos.clamp(max=max_seq - 1).long()
        self.keep = pos < max_seq


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, slot: _Slot
                ) -> None:
    """cache[b, pos[b]] = rows[b] in place ([B, S, ...] <- [B, ...]) for
    the rows ``slot`` keeps.  A DTensor cache, sharded by rows and by
    positions, is written on each rank's shard alone."""
    if isinstance(cache, DTensor):
        return _write_rows_on_shards(cache, rows, slot)
    old = cache[slot.rows, slot.at]
    keep = slot.keep.view(-1, *([1] * (rows.dim() - 1)))
    cache[slot.rows, slot.at] = torch.where(keep, rows.to(cache.dtype), old)


def _write_rows_on_shards(cache: DTensor, rows: torch.Tensor, slot: _Slot
                          ) -> None:
    """:func:`_write_rows` on this rank's shard of a DTensor cache: its rows
    of the batch, each written where its position falls in the rank's
    positions (the others are some other rank's to write)."""
    from repro_torch.kernels import sharded

    dims = {0: 0, **{i: i - 1 for i in range(2, cache.dim())}}
    mine = sharded.follow(rows, cache, dims).to_local()
    pos = sharded.follow(slot.pos, cache, {0: 0}).to_local()
    local = cache.to_local()
    at = pos.long() - sharded.offset(cache, 1)
    keep = (at >= 0) & (at < local.shape[1]) & (pos < slot.max_seq)
    at = at.clamp(0, max(local.shape[1] - 1, 0))
    b = torch.arange(local.shape[0], device=local.device)
    old = local[b, at]
    keep = keep.view(-1, *([1] * (mine.dim() - 1)))
    local[b, at] = torch.where(keep, mine.to(local.dtype), old)


@torch.no_grad()
def params_from_jax(model: LM, tree: Dict[str, Any]) -> LM:
    """Load the reference LM's parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model``, values cast to each parameter's
    dtype.  The tree has the reference's layout: ``embed``, ``final_norm``,
    ``lm_head`` unless the embeddings are tied, ``dense_layers`` and, for a
    MoE config, ``moe_layers``, each with stacked ``ln1``, ``ln2``, ``attn``
    (GQA: ``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``/``k_norm`` under
    qk-norm; MLA: ``wkv_a``, ``kv_a_norm``, ``wkv_b``, ``wo`` and
    ``wq_a``/``q_a_norm``/``wq_b`` or ``wq``) and ``mlp`` (``w_gate``,
    ``w_up``, ``w_down``) or ``moe`` (``router``, ``experts`` and
    ``shared``, each with ``w_gate``, ``w_up``, ``w_down``).  A key set that
    does not match the config raises."""
    def put(dst: torch.Tensor, src: Any, name: str) -> None:
        arr = np.array(src, dtype=np.float32)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{arr.shape}, the model {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr).to(dst.dtype))

    def same_keys(where: str, got: Any, want) -> None:
        if set(got) != set(want):
            raise ValueError(f"params_from_jax: {where} keys {sorted(got)} "
                             f"do not match the config's {sorted(want)}")

    cfg = model.cfg
    attn_keys = tuple(_attn_shapes(cfg))
    stacks = {"dense_layers": (model.layers, False)}
    if model.n_moe:
        stacks["moe_layers"] = (model.moe_layers, True)
    same_keys("top-level", [k for k in tree if k.endswith("_layers")],
              stacks)
    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"], "lm_head")
    for stack, (lp, moe) in stacks.items():
        layers = tree[stack]
        same_keys(stack, layers, ("ln1", "ln2", "attn",
                                  "moe" if moe else "mlp"))
        same_keys(f"{stack}.attn", layers["attn"], attn_keys)
        for name in ("ln1", "ln2"):
            put(lp[name], layers[name], f"{stack}.{name}")
        for name in attn_keys:
            put(lp[name], layers["attn"][name], f"{stack}.attn.{name}")
        if not moe:
            same_keys(f"{stack}.mlp", layers["mlp"], _MLP_KEYS)
            for name in _MLP_KEYS:
                put(lp[name], layers["mlp"][name], f"{stack}.mlp.{name}")
            continue
        want = nest_moe_params(dict.fromkeys(moe_param_shapes(cfg)))
        same_keys(f"{stack}.moe", layers["moe"], want)
        for group, names in want.items():
            if isinstance(names, dict):
                same_keys(f"{stack}.moe.{group}", layers["moe"][group], names)
        for name in moe_param_shapes(cfg):
            src = layers["moe"]
            for key in moe_param_path(name):
                src = src[key]
            put(lp[name], src, f"{stack}.moe.{'.'.join(moe_param_path(name))}")
    return model


def params_to_jax_tree(model: LM, tensors: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the model's parameters in the
    reference's tree (``embed``, ``final_norm``, ``lm_head`` unless tied,
    ``dense_layers`` and ``moe_layers`` with ``ln1``, ``ln2``, ``attn`` and
    ``mlp`` or ``moe``), each leaf the parameter itself (no copy) or, given
    ``tensors`` keyed as ``model.named_parameters()`` names them (their
    ``.grad``, for example), that tensor."""
    def leaf(name: str) -> Any:
        return model.get_parameter(name) if tensors is None else tensors[name]

    cfg = model.cfg
    tree: Dict[str, Any] = {"embed": leaf("embed"),
                            "final_norm": leaf("final_norm")}
    if model.lm_head is not None:
        tree["lm_head"] = leaf("lm_head")
    for stack, attr, moe in (("dense_layers", "layers", False),
                             ("moe_layers", "moe_layers", True)):
        if moe and not model.n_moe:
            continue
        node = {"ln1": leaf(f"{attr}.ln1"), "ln2": leaf(f"{attr}.ln2"),
                "attn": {k: leaf(f"{attr}.{k}") for k in _attn_shapes(cfg)}}
        if moe:
            node["moe"] = nest_moe_params({n: leaf(f"{attr}.{n}")
                                           for n in moe_param_shapes(cfg)})
        else:
            node["mlp"] = {k: leaf(f"{attr}.{k}") for k in _MLP_KEYS}
        tree[stack] = node
    return tree
