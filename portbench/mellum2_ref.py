"""Plain reference of Mellum2-12B-A2.5B's forward and of PandaDB's document φ.

Mellum2-12B-A2.5B-Instruct as its published ``config.json`` describes it
(https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct), in plain
``torch`` and float32 with TF32 off: no kernel, no cache, no batching
tricks, no expert capacity.  It imports only ``torch`` and reads the
configuration by the published keys, as ``transformers`` builds such a
decoder:

* Attention is GQA without bias or qk-norm: q = x Wq (32 heads of 128),
  k = x Wk, v = x Wv (4 heads), query head h reading key head h // 8;
  RoPE by rotate-half (dim i paired with i + 64) with the layer kind's
  ``rope_parameters``: ``"default"`` the plain frequencies theta^(-2i/D),
  ``"yarn"`` ``transformers``' YaRN (the interpolated and original
  frequencies blended by a ramp between the dims that ``beta_fast`` and
  ``beta_slow`` turn over ``original_max_position_embeddings``, floored and
  ceiled; cos and sin times ``attention_factor``); softmax in float32 over
  q.k / sqrt(head_dim), causal, and on a ``"sliding_attention"`` layer of
  ``layer_types`` only the keys j with i - sliding_window < j <= i (the
  mask ``transformers`` builds for ``sliding_window``: w keys, itself
  included).  Explicit ``layer_types`` rule, as ``transformers`` reads
  them over ``max_window_layers``.
* Every layer is a sparse MoE (``mlp_layer_types``): a softmax gate over
  ``num_experts`` in float32, the top ``num_experts_per_tok``, their
  weights renormalised under ``norm_topk_prob``, every token through each
  of its experts (dropless), each a SwiGLU of ``moe_intermediate_size``;
  no shared expert.
* RMSNorm with ``rms_norm_eps`` before attention, before the MoE and
  before the untied head.

φ (``core/aipm.py::model_embedding_extractor``'s pooling): the mean of
the logits over all positions, cut to ``dim``; this file returns it
before the L2 normalisation.

Weights are given one layer at a time, ``layer(i)`` -> {name: tensor},
each upcast to float32 here, in the math layout (inputs first): ``ln1``,
``ln2`` [d]; ``wq`` [d, H, 128], ``wk``, ``wv`` [d, KVH, 128]; ``wo``
[H, 128, d]; ``router`` [d, E]; ``w_gate``, ``w_up`` [E, d, f]; ``w_down``
[E, f, d]; the published checkpoint's ``*.weight`` matrices are their
transposes.  ``top`` holds ``embed`` [V, d], ``final_norm`` [d] and
``lm_head`` [d, V].

Departures, none of which changes a number the forward defines: the
positions of a batch's rows are 0..S-1 with no padding mask (φ's padding
is token 0, attended to as the model attends to any token); attention's
scores are taken for ``Q_BLOCK`` query rows at a time, against the keys up
to the block's last row (the keys past it are masked for every row of the
block, weight 0), so that a 32,768-position sequence fits; φ's logits are
computed for the ``dim`` columns it keeps (each column of the head is its
own product); the top-k breaks exact ties to the lower expert.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

Weights = Dict[str, torch.Tensor]
#: ``tap(part, i, h, w)``: ``part`` "attn" or "moe", layer ``i``'s input
#: h to that part (normalised) and the layer's weights
Tap = Optional[Callable[[str, int, torch.Tensor, Weights], None]]

#: query rows a block of attention scores: [B, H, 1,024, S] float32 at a
#: time
Q_BLOCK = 1024


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


def yarn_range(rp: dict, dim: int) -> Tuple[int, int]:
    """YaRN's correction range (low, high) of the rotary dims."""
    base, orig = rp["rope_theta"], rp["original_max_position_embeddings"]

    def corr(rot: float) -> float:
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    return (max(math.floor(corr(rp["beta_fast"])), 0),
            min(math.ceil(corr(rp["beta_slow"])), dim - 1))


def inv_freq(cfg: dict, kind: str) -> Tuple[torch.Tensor, float]:
    """(rotary frequencies [head_dim / 2], cos / sin scale) of a layer kind
    (``"sliding_attention"`` or ``"full_attention"``)."""
    rp, dim = cfg["rope_parameters"][kind], cfg["head_dim"]
    pos_freqs = rp["rope_theta"] ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float32) / dim)
    extra = 1.0 / pos_freqs
    if rp["rope_type"] == "default":
        return extra, 1.0
    if rp["rope_type"] != "yarn":
        raise ValueError(f"mellum2_ref: rope_type {rp['rope_type']!r}")
    inter = 1.0 / (rp["factor"] * pos_freqs)
    low, high = yarn_range(rp, dim)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp                      # the original frequency's share
    scale = rp.get("attention_factor")
    if scale is None:
        scale = 0.1 * math.log(rp["factor"]) + 1.0
    return inter * (1 - keep) + extra * keep, float(scale)


def cos_sin(cfg: dict, kind: str, seq: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, head_dim] cos and sin of a layer kind, scaled."""
    freq, scale = inv_freq(cfg, kind)
    t = torch.arange(seq, dtype=torch.float32)
    emb = torch.outer(t, freq)
    emb = torch.cat((emb, emb), dim=-1)
    return (emb.cos() * scale).to(device), (emb.sin() * scale).to(device)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x [B, H, S, D] as ``apply_rotary_pos_emb`` (rotate-half)."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., half:], x[..., :half]), -1) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


def window(cfg: dict, i: int) -> int:
    """Layer ``i``'s band in keys, 0 for a full layer."""
    if cfg["layer_types"][i] == "sliding_attention":
        return cfg["sliding_window"]
    return 0


def attention(cfg: dict, i: int, x: torch.Tensor, w: Weights,
              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Layer ``i``'s attention on x [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    q = (x @ w["wq"].reshape(d, h * hd)).view(b, s, h, hd).transpose(1, 2)
    k = (x @ w["wk"].reshape(d, kvh * hd)).view(b, s, kvh, hd) \
        .transpose(1, 2)
    v = (x @ w["wv"].reshape(d, kvh * hd)).view(b, s, kvh, hd) \
        .transpose(1, 2)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    band = window(cfg, i)
    out = torch.empty_like(q)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        scores = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(2, 3)) * hd ** -0.5
        qi = torch.arange(q0, q1, device=x.device)[:, None]
        kj = torch.arange(q1, device=x.device)[None, :]
        seen = kj <= qi
        if band:
            seen &= kj > qi - band
        scores = scores.masked_fill(~seen, float("-inf"))
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32)
        out[:, :, q0:q1] = probs @ v[:, :, :q1]
        del scores, probs
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ w["wo"].reshape(h * hd, d)


def moe(cfg: dict, x: torch.Tensor, w: Weights) -> torch.Tensor:
    """The MoE layer on x [B, S, d]: every token through each of its top-k
    experts, weighted."""
    b, s, d = x.shape
    t = x.reshape(b * s, d)
    scores = torch.softmax(t @ w["router"], dim=-1, dtype=torch.float32)
    topw, topi = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(t)
    for e in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel():
            ye = _swiglu(t[tok], w["w_gate"][e], w["w_up"][e],
                         w["w_down"][e])
            y.index_add_(0, tok, ye * topw[tok, slot, None])
    return y.view(b, s, d)


def block(cfg: dict, i: int, x: torch.Tensor, w: Weights, rope: dict,
          tap: Tap = None) -> torch.Tensor:
    """Decoder layer ``i`` on x [B, S, d] (float32); ``rope`` maps a layer
    kind to its (cos, sin); ``tap``, if given, sees each part's input."""
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, w["ln1"], eps)
    if tap is not None:
        tap("attn", i, h, w)
    x = x + attention(cfg, i, h, w, *rope[cfg["layer_types"][i]])
    h = rms_norm(x, w["ln2"], eps)
    if tap is not None:
        tap("moe", i, h, w)
    return x + moe(cfg, h, w)


def hidden(cfg: dict, tokens: torch.Tensor, top: Weights,
           layer: Callable[[int], Weights], tap: Tap = None
           ) -> torch.Tensor:
    """tokens [B, S] -> the last layer's output [B, S, d] (before the final
    norm), one layer's weights upcast at a time (``tap``: :func:`block`)."""
    with _no_tf32():
        x = top["embed"].float()[tokens]
        rope = {kind: cos_sin(cfg, kind, tokens.shape[1], x.device)
                for kind in set(cfg["layer_types"])}
        for i in range(cfg["num_hidden_layers"]):
            w = {n: t.float() for n, t in layer(i).items()}
            x = block(cfg, i, x, w, rope, tap)
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
        vals = bytes(bytearray(raw))[:max_tokens]
        if vals:
            out[i, :len(vals)] = torch.frombuffer(
                bytearray(vals), dtype=torch.uint8).long() % vocab
    return out
