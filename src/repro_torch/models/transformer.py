"""Decoder-only LM, dense grouped-query attention, for serving.

The reference's ``models/transformer.py`` for its dense configs: GQA with
optional per-head qk-norm, RoPE, SwiGLU, an untied or tied head.  Parameters
keep the reference's stacked layout (``wq`` [L, d, H, hd], ``wo``
[L, H, hd, d], ...), so :func:`params_from_jax` loads a reference param tree
as it is.  One card has no mesh, so there are no sharding rules.  On the card
attention runs through the hand-written flash-attention (prefill) and
decode-attention (decode) kernels; on the CPU through their plain versions.

Serving only: parameters do not require gradients.  MoE and MLA configs
raise; they come with ``models/moe.py`` and the MLA port (ROADMAP Queue A8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.layers import (
    apply_rotary,
    dense_init_,
    embed_init_,
    rms_norm,
    rotary_cos_sin,
)

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_NORM_KEYS = ("q_norm", "k_norm")
_MLP_KEYS = ("w_gate", "w_up", "w_down")


class LM(nn.Module):
    """Dense GQA decoder-only LM on one device.

    ``LM(cfg, device=None)`` allocates the parameters on the CUDA card (or
    on ``device``) in ``cfg.dtype`` and initialises them there from
    ``generator`` (default: seed 0 on that device); with no card and no
    device named it raises."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        if cfg.is_moe:
            raise NotImplementedError(
                "MoE configs are not ported yet: models/moe.py comes with "
                "ROADMAP Queue A8 (model stack, MoE)")
        if cfg.is_mla:
            raise NotImplementedError(
                "MLA configs are not ported yet: latent attention comes with "
                "ROADMAP Queue A8 (model stack, MLA)")
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        n, d, h = cfg.n_layers, cfg.d_model, cfg.n_heads
        kvh, hd, f, v = cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size

        def param(*shape, dtype=self.dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device),
                                requires_grad=False)

        f32 = torch.float32
        self.embed = param(v, d)
        self.final_norm = param(d, dtype=f32)
        self.lm_head = None if cfg.tie_embeddings else param(d, v)
        layers = {"ln1": param(n, d, dtype=f32), "ln2": param(n, d, dtype=f32),
                  "wq": param(n, d, h, hd), "wk": param(n, d, kvh, hd),
                  "wv": param(n, d, kvh, hd), "wo": param(n, h, hd, d),
                  "w_gate": param(n, d, f), "w_up": param(n, d, f),
                  "w_down": param(n, f, d)}
        if cfg.qk_norm:
            layers["q_norm"] = param(n, hd, dtype=f32)
            layers["k_norm"] = param(n, hd, dtype=f32)
        self.layers = nn.ParameterDict(layers)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    # -- init ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's init on this model's device: 0.02-normal
        embedding, truncated-normal fan-in matrices, unit norm scales.  Each
        layer is drawn on its own, in fp32, then cast to ``cfg.dtype``."""
        cfg = self.cfg
        d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        embed_init_(self.embed, generator)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            dense_init_(self.lm_head, d, generator)
        fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * hd, "w_gate": d,
                  "w_up": d, "w_down": f}
        for name, p in self.layers.items():
            if name in fan_in:
                for layer in range(cfg.n_layers):
                    dense_init_(p[layer], fan_in[name], generator)
            else:
                p.fill_(1.0)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, scale, self.cfg.rms_eps, fused=self.cfg.fused_norm)

    # -- attention ----------------------------------------------------------

    def _gqa(self, i: int, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, cache=None, slot: "_Slot" = None):
        cfg = self.cfg
        lp = self.layers
        b, s, d = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ lp["wq"][i].reshape(d, h * hd)).reshape(b, s, h, hd)
        k = (x @ lp["wk"][i].reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
        v = (x @ lp["wv"][i].reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
        if cfg.qk_norm:
            q = self._norm(q, lp["q_norm"][i])
            k = self._norm(k, lp["k_norm"][i])
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if cache is None:
            # k and v keep their KVH heads: the kernel reads head h // G
            out = chunked_attention(q, k, v, causal=True,
                                    block_kv=min(cfg.attn_block_kv, s),
                                    bf16_probs=cfg.bf16_probs)
            new_cache = (k, v)
        else:
            k_cache, v_cache = cache
            _write_rows(k_cache, k[:, 0], slot)
            _write_rows(v_cache, v[:, 0], slot)
            out = decode_attention(q, k_cache, v_cache, slot.pos)
            new_cache = cache
        o = out.reshape(b, s, h * hd) @ lp["wo"][i].reshape(h * hd, d)
        return o, new_cache

    # -- blocks -------------------------------------------------------------

    def _block(self, i: int, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, cache=None, slot: "_Slot" = None):
        lp = self.layers
        h = self._norm(x, lp["ln1"][i])
        attn_out, new_cache = self._gqa(i, h, cos, sin, cache=cache,
                                        slot=slot)
        x = x + attn_out
        h = self._norm(x, lp["ln2"][i])
        g = F.silu(h @ lp["w_gate"][i])
        u = h @ lp["w_up"][i]
        return x + (g * u) @ lp["w_down"][i], new_cache

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(x, self.final_norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- full forward (prefill) ----------------------------------------------

    @torch.no_grad()
    def _trunk(self, tokens: torch.Tensor, collect_cache: bool):
        cfg = self.cfg
        b, s = tokens.shape
        x = F.embedding(tokens, self.embed)
        cos, sin = rotary_cos_sin(torch.arange(s, device=self.device),
                                  cfg.head_dim, cfg.rope_theta)
        cache = None
        if collect_cache:
            shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
            cache = {"dense": (torch.empty(shape, dtype=self.dtype,
                                           device=self.device),
                               torch.empty(shape, dtype=self.dtype,
                                           device=self.device))}
        for i in range(cfg.n_layers):
            x, (k, v) = self._block(i, x, cos, sin)
            if cache is not None:
                cache["dense"][0][i].copy_(k)
                cache["dense"][1][i].copy_(v)
        return x, cache

    @torch.no_grad()
    def forward(self, tokens, collect_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """tokens [B, S] -> (logits [B, S, V], cache | None).  The cache is
        ``{"dense": (k, v)}``, each [L, B, S, KVH, hd]."""
        x, cache = self._trunk(self._tokens(tokens), collect_cache)
        return self._head(x), cache

    @torch.no_grad()
    def prefill(self, tokens) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] -> (last-position logits [B, V], cache).  The head
        runs on the last position only: the same values as the reference's
        ``logits[:, -1]``, without the [B, S, V] logits."""
        x, cache = self._trunk(self._tokens(tokens), True)
        return self._head(x[:, -1:])[:, 0], cache

    # -- decode -------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A zeroed KV cache ``{"dense": (k, v)}``, each
        [L, batch, max_seq, KVH, hd] in ``cfg.dtype``, on this device.  It
        takes the place of the reference's abstract ``cache_spec``."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"dense": tuple(torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
                               for _ in range(2))}

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """One serve step: tokens [B, 1], pos [B] -> (logits [B, V], cache).

        Writes each layer's new key and value into ``cache`` at ``pos`` in
        place and returns the same cache; the reference (JAX) returns a new
        one.  A row whose pos >= max_seq is dropped, as the reference's
        ``mode="drop"`` scatter drops it: never wrapped, never raised."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        pos = torch.as_tensor(pos, device=self.device).to(torch.int32)
        x = F.embedding(tokens, self.embed)
        cos, sin = rotary_cos_sin(pos[:, None].float(), cfg.head_dim,
                                  cfg.rope_theta)
        k_all, v_all = cache["dense"]
        slot = _Slot(pos, k_all.shape[2])
        for i in range(cfg.n_layers):
            x, _ = self._block(i, x, cos, sin, cache=(k_all[i], v_all[i]),
                               slot=slot)
        return self._head(x)[:, 0], cache


class _Slot:
    """Where one decode step writes each row's new key and value, computed
    once a step: row b goes to position pos[b], and a row with
    pos >= max_seq is dropped without a host sync (it writes back the value
    already at max_seq - 1)."""

    def __init__(self, pos: torch.Tensor, max_seq: int) -> None:
        self.pos = pos
        self.rows = torch.arange(pos.shape[0], device=pos.device)
        self.at = pos.clamp(max=max_seq - 1).long()
        self.keep = (pos < max_seq)[:, None, None]


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, slot: _Slot
                ) -> None:
    """cache[b, pos[b]] = rows[b] in place ([B, S, KVH, hd] <- [B, KVH, hd])
    for the rows ``slot`` keeps."""
    old = cache[slot.rows, slot.at]
    cache[slot.rows, slot.at] = torch.where(slot.keep, rows.to(cache.dtype),
                                            old)


@torch.no_grad()
def params_from_jax(model: LM, tree: Dict[str, Any]) -> LM:
    """Load the reference LM's parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model``, values cast to each parameter's
    dtype.  The tree has the reference's layout: ``embed``, ``final_norm``,
    ``lm_head`` unless the embeddings are tied, and ``dense_layers`` with
    stacked ``ln1``, ``ln2``, ``attn`` (``wq``, ``wk``, ``wv``, ``wo``,
    ``q_norm``/``k_norm`` under qk-norm) and ``mlp`` (``w_gate``, ``w_up``,
    ``w_down``)."""
    def put(dst: torch.Tensor, src: Any, name: str) -> None:
        arr = np.array(src, dtype=np.float32)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{arr.shape}, the model {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr).to(dst.dtype))

    cfg = model.cfg
    layers = tree["dense_layers"]
    attn_keys = _ATTN_KEYS + (_NORM_KEYS if cfg.qk_norm else ())
    if set(layers["attn"]) != set(attn_keys) or \
            set(layers["mlp"]) != set(_MLP_KEYS):
        raise ValueError(f"params_from_jax: attn keys {sorted(layers['attn'])}"
                         f" / mlp keys {sorted(layers['mlp'])} do not match "
                         f"the config")
    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"], "lm_head")
    for name in ("ln1", "ln2"):
        put(model.layers[name], layers[name], name)
    for name in attn_keys:
        put(model.layers[name], layers["attn"][name], f"attn.{name}")
    for name in _MLP_KEYS:
        put(model.layers[name], layers["mlp"][name], f"mlp.{name}")
    return model
