"""Plain reference of DeepSeek-V2-Lite's forward and of PandaDB's text φ.

DeepSeek-V2 (arXiv:2405.04434) as its published ``config.json`` and
modeling code describe it, in plain ``torch`` and float32 with TF32 off:
no kernel, no cache, no batching tricks, no expert capacity.  It imports
only ``torch`` and reads the configuration by the published keys
(``hidden_size``, ``kv_lora_rank``, ``rope_scaling``, ...).

* Attention is MLA without q-LoRA (``q_lora_rank`` null): q = x Wq per
  head, [q_nope (128), q_pe (64)]; the latent c = RMSNorm(x Wkv_a[:512]),
  k_pe = x Wkv_a[512:] shared by the heads; [k_nope, v] = c Wkv_b.  RoPE on
  q_pe and k_pe with DeepSeek's pairing (the interleaved dims de-interleaved,
  then rotate-half) and YaRN's frequencies and scales; causal softmax in
  float32 over q.k times qk_dim^-1/2 m(mscale_all_dim)^2.
* Layers below ``first_k_dense_replace`` run a SwiGLU of
  ``intermediate_size``; the others a MoE: a softmax gate over
  ``n_routed_experts`` in float32, the greedy top ``num_experts_per_tok``,
  the weights renormalised only under ``norm_topk_prob`` and else times
  ``routed_scaling_factor`` (the published rule), every token through each
  of its experts (dropless), plus ``n_shared_experts`` shared experts as
  one SwiGLU of ``n_shared_experts * moe_intermediate_size``.
* RMSNorm with ``rms_norm_eps``; an untied head.

φ (``core/aipm.py::model_embedding_extractor``'s pooling): the mean of
the logits over all positions, cut to ``dim``; this file returns it
before the L2 normalisation.

Weights are given one layer at a time, ``layer(i)`` -> {name: tensor},
each upcast to float32 here, in the math layout (inputs first): ``ln1``,
``ln2`` [d]; ``wq`` [d, H, 192]; ``wkv_a`` [d, 576]; ``kv_a_norm`` [512];
``wkv_b`` [512, H, 256] (k_nope then v); ``wo`` [H, 128, d]; a dense
layer's ``w_gate``, ``w_up`` [d, f], ``w_down`` [f, d]; a MoE layer's
``router`` [d, E], ``w_gate``, ``w_up`` [E, d, f], ``w_down`` [E, f, d],
``shared_w_gate``, ``shared_w_up`` [d, sf], ``shared_w_down`` [sf, d]; the
published checkpoint's ``*.weight`` matrices are their transposes.  ``top``
holds ``embed`` [V, d], ``final_norm`` [d] and ``lm_head`` [d, V].

Departures, none of which changes a number the forward defines: the
positions of a batch's rows are 0..S-1 with no padding mask (φ's padding
is token 0, attended to as the model attends to any token); φ's logits
are computed for the ``dim`` columns it keeps (each column of the head is
its own product); the top-k breaks exact ties to the lower expert.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

Weights = Dict[str, torch.Tensor]
Tap = Optional[Callable[[int, torch.Tensor, Weights], None]]


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """float32 products stay float32 on the card while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(cfg: dict) -> Tuple[int, int]:
    """The correction range (low, high) of the rope dims."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], \
        cfg["rope_theta"]

    def corr(rot: float) -> float:
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    return (max(math.floor(corr(rs["beta_fast"])), 0),
            min(math.ceil(corr(rs["beta_slow"])), dim - 1))


def inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's rotary frequencies [qk_rope_head_dim / 2]."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], \
        cfg["rope_theta"]
    exponent = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exponent)
    freq_inter = 1.0 / (rs["factor"] * base ** exponent)
    low, high = yarn_range(cfg)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def cos_sin(cfg: dict, seq: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """[S, qk_rope_head_dim] cos and sin, each scaled by
    m(mscale) / m(mscale_all_dim)."""
    rs = cfg["rope_scaling"]
    t = torch.arange(seq, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq(cfg))
    emb = torch.cat((freqs, freqs), dim=-1)
    m = yarn_get_mscale(rs["factor"], rs["mscale"]) / yarn_get_mscale(
        rs["factor"], rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x [B, H, S, D] as the published ``apply_rotary_pos_emb``."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + _rotate_half(x) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


def attention(cfg: dict, x: torch.Tensor, w: Weights, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """MLA without q-LoRA on x [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, dc = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ w["wq"].reshape(d, -1)).view(b, s, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_a = x @ w["wkv_a"]
    c = rms_norm(kv_a[..., :dc], w["kv_a_norm"], cfg["rms_norm_eps"])
    k_pe = kv_a[..., dc:].view(b, s, 1, dr).transpose(1, 2)
    kv = (c @ w["wkv_b"].reshape(dc, -1)).view(b, s, h, dn + dv) \
        .transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe, k_pe = _rope(q_pe, cos, sin), _rope(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, s, dr)], dim=-1)
    scores = (q @ k.transpose(2, 3)) * softmax_scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32)
    out = (probs @ v).transpose(1, 2).reshape(b, s, h * dv)
    return out @ w["wo"].reshape(h * dv, d)


def moe(cfg: dict, x: torch.Tensor, w: Weights) -> torch.Tensor:
    """The MoE layer on x [B, S, d]: every token through each of its top-k
    experts, weighted, plus the shared experts."""
    b, s, d = x.shape
    t = x.reshape(b * s, d)
    scores = torch.softmax(t @ w["router"], dim=-1, dtype=torch.float32)
    k = cfg["num_experts_per_tok"]
    topw, topi = torch.topk(scores, k, dim=-1)
    if k > 1 and cfg["norm_topk_prob"]:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        topw = topw * cfg["routed_scaling_factor"]
    y = torch.zeros_like(t)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel():
            ye = _swiglu(t[tok], w["w_gate"][e], w["w_up"][e],
                         w["w_down"][e])
            y.index_add_(0, tok, ye * topw[tok, slot, None])
    if cfg["n_shared_experts"]:
        y = y + _swiglu(t, w["shared_w_gate"], w["shared_w_up"],
                        w["shared_w_down"])
    return y.view(b, s, d)


def block(cfg: dict, i: int, x: torch.Tensor, w: Weights,
          cos: torch.Tensor, sin: torch.Tensor, tap: Tap = None
          ) -> torch.Tensor:
    """Decoder layer ``i`` on x [B, S, d] (float32); ``tap(i, h, w)``, if
    given, sees a MoE layer's input h and its weights before it runs."""
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, rms_norm(x, w["ln1"], eps), w, cos, sin)
    h = rms_norm(x, w["ln2"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + _swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
    if tap is not None:
        tap(i, h, w)
    return x + moe(cfg, h, w)


def hidden(cfg: dict, tokens: torch.Tensor, top: Weights,
           layer: Callable[[int], Weights], tap: Tap = None
           ) -> torch.Tensor:
    """tokens [B, S] -> the last layer's output [B, S, d] (before the final
    norm), one layer's weights upcast at a time (``tap``: :func:`block`)."""
    with _no_tf32():
        x = top["embed"].float()[tokens]
        cos, sin = cos_sin(cfg, tokens.shape[1], x.device)
        for i in range(cfg["num_hidden_layers"]):
            w = {n: t.float() for n, t in layer(i).items()}
            x = block(cfg, i, x, w, cos, sin, tap)
            del w
        return x


def logits(cfg: dict, tokens: torch.Tensor, top: Weights,
           layer: Callable[[int], Weights]) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (float32)."""
    x = hidden(cfg, tokens, top, layer)
    with _no_tf32():
        return rms_norm(x, top["final_norm"].float(), cfg["rms_norm_eps"]) \
            @ top["lm_head"].float()


def phi(cfg: dict, tokens: torch.Tensor, top: Weights,
        layer: Callable[[int], Weights], dim: int, tap: Tap = None
        ) -> torch.Tensor:
    """φ before its L2 normalisation: the mean over positions of the
    logits' first ``dim`` columns -> [B, dim] (float32)."""
    x = hidden(cfg, tokens, top, layer, tap)
    with _no_tf32():
        x = rms_norm(x, top["final_norm"].float(), cfg["rms_norm_eps"])
        return (x @ top["lm_head"][:, :dim].float()).mean(dim=1)


def text_tokens(raws, vocab: int, max_tokens: int) -> torch.Tensor:
    """φ's tokens: each text's first ``max_tokens`` bytes, ``byte % vocab``,
    zero-padded -> [B, max_tokens] int64."""
    out = torch.zeros(len(raws), max_tokens, dtype=torch.int64)
    for i, raw in enumerate(raws):
        vals = list(bytes(bytearray(raw)))[:max_tokens]
        if vals:
            out[i, :len(vals)] = torch.tensor(vals, dtype=torch.int64) % vocab
    return out
