"""Equiformer-v2: equivariant graph attention via eSCN SO(2) convolutions
[arXiv:2306.12059], the reference's ``models/gnn/equiformer.py``.

Per layer, per edge (u -> v):
  1. rotate x_u's irrep features into the edge frame (Wigner D, wigner.py),
  2. m-truncate to |m| <= m_max (the eSCN O(L^6)->O(L^3) trick),
  3. SO(2)-equivariant linear maps per m, FiLM-modulated by RBF(r_uv),
  4. attention logits from the invariant (m=0) channel, edge-softmax by dst,
  5. rotate messages back (D^T) and scatter-sum.
plus equivariant RMS-layernorm and an S2-style gated FFN.

Features are [N, (l_max+1)^2, C] real-SH coefficient blocks.  Big-graph
shapes run the edge loop in chunks, inside one ``torch.autograd.Function``
(the reference's ``jax.custom_vjp``): the forward keeps only node-sized
statistics, the backward recomputes each chunk's messages.  The reference's
grouped remat is ``torch.utils.checkpoint`` over four groups of layers.  The
attention's messages carry a gradient, so the scatter-sums are torch
``index_add``.

On DTensors (``rules`` set, the dry run on a production mesh) the
attention-aggregation runs edge-parallel (:func:`_agg_on_shards`): each
rank runs the chunked primitive on its edges, with the node table and the
weights gathered whole (the SO(2) convolution mixes every channel), and the
ranks' node maxima and softmax sums are all-reduced over the edge-sharding
mesh dims inside it.  Its output is pinned to the channel sharding
(``_pin_channel``, the reference's), a no-op off a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import constrain
from repro_torch.models.gnn.common import (GNNModule, segment_softmax,
                                           segment_sum)
from repro_torch.models.gnn.wigner import edge_wigner, l_slices, real_sph_harm

Params = Dict


def _m_layout(l_max: int, m_max: int) -> Dict[int, List[int]]:
    """Compact m-truncated layout: m -> the l's with l >= m (m = 0..m_max)."""
    return {m: [l for l in range(l_max + 1) if l >= m]
            for m in range(m_max + 1)}


def _full_index(l_max: int, l: int, m: int) -> int:
    """Index of (l, m) in the dense (l_max+1)^2 layout."""
    return l * l + (m + l)


class _SO2(nn.Module):
    """One layer's SO(2) conv weights: per m, [n_l, C, n_l, C] maps
    (``m.<m>.w1``, and ``w2`` for m > 0), and the RBF FiLM filter."""

    def __init__(self, owner: "EquiformerV2", n_rbf: int) -> None:
        super().__init__()
        c = owner.c
        self.m = nn.ModuleDict()
        for m, ls in owner.layout.items():
            nl = len(ls)
            names = ("w1",) if m == 0 else ("w1", "w2")
            self.m[str(m)] = nn.ParameterDict({
                n: owner.param(nl, c, nl, c, init=nl * c) for n in names})
        self.film = owner.param(n_rbf, c, init=n_rbf)


class _Layer(nn.Module):
    def __init__(self, owner: "EquiformerV2", n_rbf: int) -> None:
        super().__init__()
        c, lm = owner.c, owner.l_max + 1
        self.so2 = _SO2(owner, n_rbf)
        self.attn_mlp = nn.ParameterDict({
            "w1": owner.param(c, c, init=c),
            "w2": owner.param(c, owner.n_heads, init=c)})
        self.out_proj = owner.param(c, c, init=c)
        self.ffn_gate = owner.param(c, lm * c, init=c)
        self.ffn_mix = owner.param(lm, c, c, init=c)
        self.ln_scale = owner.param(lm, c, init=1.0)
        self.ln2_scale = owner.param(lm, c, init=1.0)

    def attn_params(self) -> Params:
        """The tensors the edge messages and logits read."""
        return {"so2": {"m": {k: dict(v) for k, v in self.so2.m.items()},
                        "film": self.so2.film},
                "attn_mlp": dict(self.attn_mlp), "ln_scale": self.ln_scale}


def _flat(p: Params) -> List[torch.Tensor]:
    """The tensors of an ``attn_params`` dict, in a fixed order."""
    out = []
    for k in sorted(p):
        out.extend(_flat(p[k]) if isinstance(p[k], dict) else [p[k]])
    return out


def _pin_channel(x: torch.Tensor, rules) -> torch.Tensor:
    """The reference's channel-sharding pin: the last (channel) dim on its
    ``channel`` rule; a no-op off a mesh."""
    return constrain(x, rules, *([None] * (x.dim() - 1)), "channel")


def _agg_on_shards(model, p: Params, n_nodes: int, x, pos, src, dst,
                   edge_mask, chunk: Optional[int]):
    """The attention-aggregation of one layer on DTensors (the module
    docstring): ``_ChunkedAgg`` on each rank's edges, cut into the
    reference's chunks (each rank takes its share of every chunk), with the
    node maxima and sums all-reduced over the edge-sharding mesh dims.  The
    gradients of x and the weights are partial sums over those dims."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import sharded

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, rep, run_check=False)
    src = sharded.keep_only(dt(src), (0,))
    edges = list(src.placements)
    dst, edge_mask = sharded.to(dt(dst), edges), sharded.to(dt(edge_mask),
                                                            edges)
    by_edge = [i for i, q in enumerate(edges) if isinstance(q, Shard)]
    whole = [sharded.keep_only(dt(t), ()) for t in [x, pos] + _flat(p)]
    grad = [Partial() if i in by_edge else Replicate()
            for i in range(mesh.ndim)]
    e = src.shape[0]
    n_chunks = e // chunk if chunk is not None and e > chunk else 1

    def combine(kind: str, t: torch.Tensor) -> torch.Tensor:
        for i in by_edge:
            t = funcol.all_reduce(t, kind, (mesh, i))
        return t

    def local(xl, pl, sl, dl, ml, *tl):
        c = sl.shape[0] // n_chunks
        return _ChunkedAgg.apply(model, p, n_nodes, xl, pl,
                                 sl.reshape(n_chunks, c),
                                 dl.reshape(n_chunks, c),
                                 ml.reshape(n_chunks, c), combine, *tl)
    n_w = len(whole) - 2
    return local_map(
        local, out_placements=(rep,),
        in_placements=(rep, rep, edges, edges, edges) + (rep,) * n_w,
        in_grad_placements=(grad, rep, edges, edges, edges) + (grad,) * n_w,
        device_mesh=mesh)(whole[0], whole[1], src, dst, edge_mask,
                          *whole[2:])


def _unflat(like: Params, ts: List[torch.Tensor]) -> Params:
    it = iter(ts)

    def rebuild(d):
        return {k: rebuild(d[k]) if isinstance(d[k], dict) else next(it)
                for k in sorted(d)}
    return rebuild(like)


class EquiformerV2(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        self.l_max = cfg.l_max
        self.m_max = cfg.m_max
        self.c = cfg.d_hidden
        self.n_heads = cfg.n_heads
        self.n_coef = (cfg.l_max + 1) ** 2
        self.layout = _m_layout(cfg.l_max, cfg.m_max)
        self.slices = l_slices(cfg.l_max)
        n_rbf = max(cfg.n_rbf, 8)
        self.embed_in = self.param(d_in, self.c, init=d_in)
        self.layers = nn.ModuleList([_Layer(self, n_rbf)
                                     for _ in range(cfg.n_layers)])
        self.head_w1 = self.param(self.c, self.c, init=self.c)
        self.head_w2 = self.param(self.c, n_out, init=self.c)
        self.reset_parameters(generator)

    def param_axes(self) -> Dict[str, Tuple]:
        """The reference's axes: the SO(2) maps and the FiLM filter shard
        their channels (``"channel"``, ``"channel_out"``); every other
        weight is replicated.  Keyed as ``named_parameters()`` names them,
        one layer at a time (the reference stacks the layers under a
        leading ``"layers"`` axis, which no rule shards)."""
        axes = super().param_axes()
        for i, lp in enumerate(self.layers):
            for m, group in lp.so2.m.items():
                for w in group:
                    axes[f"layers.{i}.so2.m.{m}.{w}"] = (
                        None, "channel", None, "channel_out")
            axes[f"layers.{i}.so2.film"] = (None, "channel")
        return axes

    # -- equivariant pieces -------------------------------------------------

    def _eq_layernorm(self, x: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
        """RMS per degree l over (m, C); x: [N, n_coef, C]."""
        outs = []
        for l in range(self.l_max + 1):
            blk = x[:, self.slices[l], :]
            rms = torch.sqrt(torch.mean(torch.square(blk.float()),
                                        dim=(1, 2), keepdim=True) + 1e-6)
            outs.append(blk * (1.0 / rms).to(blk.dtype)
                        * scale[l][None, None, :].to(blk.dtype))
        return torch.cat(outs, dim=1)

    def _rbf(self, r: torch.Tensor) -> torch.Tensor:
        n = max(self.cfg.n_rbf, 8)
        cut = self.cfg.cutoff or 10.0
        mu = torch.linspace(0.0, cut, n, device=r.device)
        gamma = (n / cut) ** 2
        return torch.exp(-gamma * torch.square(r[..., None] - mu))

    def _so2_conv(self, p: Params, x_rot: torch.Tensor, rbf: torch.Tensor
                  ) -> torch.Tensor:
        """x_rot: [E, n_coef, C] edge-frame features -> same shape (m<=m_max
        convolved, higher m zeroed)."""
        film = (torch.sigmoid(rbf.float() @ p["film"]) * 2.0).to(x_rot.dtype)
        out = torch.zeros_like(x_rot)

        def mix(v, w):
            return torch.einsum("eac,acbd->ebd", v, w.to(v.dtype))

        for m, ls in self.layout.items():
            idx = torch.tensor([_full_index(self.l_max, l, m) for l in ls],
                               device=x_rot.device)
            w1 = p["m"][str(m)]["w1"]
            if m == 0:
                y = mix(x_rot[:, idx, :], w1) * film[:, None, :]
                out = out.index_copy(1, idx, y)
            else:
                idx_n = torch.tensor([_full_index(self.l_max, l, -m)
                                      for l in ls], device=x_rot.device)
                w2 = p["m"][str(m)]["w2"]
                vp = x_rot[:, idx, :]
                vn = x_rot[:, idx_n, :]
                yp = mix(vp, w1) - mix(vn, w2)
                yn = mix(vp, w2) + mix(vn, w1)
                out = out.index_copy(1, idx, yp * film[:, None, :])
                out = out.index_copy(1, idx_n, yn * film[:, None, :])
        return out

    def _rotate(self, rots, xs: torch.Tensor, back: bool) -> torch.Tensor:
        """Each degree's block of xs [e, n_coef, C] through D^l (D^l^T when
        ``back``)."""
        eq = "eji,ejc->eic" if back else "eij,ejc->eic"
        return torch.cat([torch.einsum(eq, rots[l], xs[:, self.slices[l], :])
                          for l in range(self.l_max + 1)], dim=1)

    def _geometry(self, pos, s_c, d_c, m_c):
        """(mask, r̂, RBF(r)) of a chunk's edges."""
        rel = pos[d_c] - pos[s_c]
        r = torch.linalg.vector_norm(rel, dim=-1)
        # degenerate (zero-length / self-loop) edges have no well-defined
        # frame -- masking them is required for exact equivariance
        m_c = m_c * (r > 1e-6)
        rhat = rel / torch.clamp(r[..., None], min=1e-9)
        return m_c, rhat, self._rbf(r)

    def _attn(self, p: Params, inv: torch.Tensor, m_c: torch.Tensor
              ) -> torch.Tensor:
        dt = inv.dtype
        a = F.silu(inv @ p["attn_mlp"]["w1"].to(dt)) @ \
            p["attn_mlp"]["w2"].to(dt)
        return torch.where(m_c[:, None] > 0, a, -1e30)

    def _edge_logits_fast(self, p: Params, x_raw: torch.Tensor,
                          pos: torch.Tensor, src_c: torch.Tensor,
                          dst_c: torch.Tensor, mask_c: torch.Tensor
                          ) -> torch.Tensor:
        """Attention logits WITHOUT building Wigner matrices: the m'=0 row
        of D^l is sqrt(4pi/(2l+1)) * Y_l(r̂), so the rotation collapses to
        one SH contraction per edge."""
        mask_c, rhat, rbf = self._geometry(pos, src_c, dst_c, mask_c)
        sh = real_sph_harm(self.l_max, rhat).to(x_raw.dtype)
        xs = self._eq_layernorm(x_raw[src_c], p["ln_scale"])
        m0 = []
        for l in range(self.l_max + 1):
            coef = math.sqrt(4.0 * math.pi / (2 * l + 1))
            m0.append(torch.einsum("ej,ejc->ec",
                                   sh[:, self.slices[l]] * coef,
                                   xs[:, self.slices[l], :]))
        x_m0 = torch.stack(m0, dim=1)                         # [e, n_l, C]
        dt = x_raw.dtype
        w1 = p["so2"]["m"]["0"]["w1"].to(dt)                  # [nl, C, nl, C]
        film = torch.sigmoid(rbf.float() @ p["so2"]["film"]) * 2.0
        y0 = torch.einsum("eac,acbd->ebd", x_m0, w1) * \
            film.to(dt)[:, None, :]
        return self._attn(p, y0[:, 0, :], mask_c)

    def _chunk_messages(self, p: Params, x_rows: torch.Tensor,
                        pos: torch.Tensor, s_c: torch.Tensor,
                        d_c: torch.Tensor, m_c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk: (rotated SO(2) messages, head-max logit), from the
        pre-gathered source rows [chunk, n_coef, C]."""
        m_c, rhat, rbf = self._geometry(pos, s_c, d_c, m_c)
        rbf = rbf.to(x_rows.dtype)
        xs = self._eq_layernorm(x_rows, p["ln_scale"])
        rots = {l: edge_wigner(l, rhat).to(x_rows.dtype)
                for l in range(self.l_max + 1)}
        msg = self._so2_conv(p["so2"], self._rotate(rots, xs, False), rbf)
        a = self._attn(p, msg[:, 0, :], m_c)
        return self._rotate(rots, msg, True), torch.max(a, dim=-1).values

    # -- layer ----------------------------------------------------------------

    def _layer(self, lp: _Layer, x: torch.Tensor, pos: torch.Tensor,
               src: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
               n_nodes: int, chunk: Optional[int]) -> torch.Tensor:
        e = src.shape[0]
        p = lp.attn_params()
        if isinstance(x, DTensor):
            agg = _agg_on_shards(self, p, n_nodes, x, pos, src, dst,
                                 edge_mask, chunk)
        elif chunk is None or e <= chunk:
            h = self._eq_layernorm(x, lp.ln_scale)
            m_c, rhat, rbf = self._geometry(pos, src, dst, edge_mask)
            rbf = rbf.to(x.dtype)
            rots = {l: edge_wigner(l, rhat).to(x.dtype)
                    for l in range(self.l_max + 1)}
            msg = self._so2_conv(p["so2"], self._rotate(rots, h[src], False),
                                 rbf)
            # attention logits from the invariant channel
            a = F.silu(msg[:, 0, :] @ lp.attn_mlp["w1"]) @ lp.attn_mlp["w2"]
            a = torch.where(m_c[:, None] != 0, a, -1e30)      # [e, H]
            msg = self._rotate(rots, msg, True)
            # head-collapsed (max) attention: identical math to the chunked
            # path below
            attn = segment_softmax(torch.max(a, dim=-1).values, dst, n_nodes)
            wmsg = msg * attn[:, None, None]
            agg = segment_sum(torch.where(edge_mask[:, None, None] > 0, wmsg,
                                          0.0), dst, n_nodes)
        else:
            if e % chunk:
                raise ValueError(f"equiformer: {e} edges do not split into "
                                 f"chunks of {chunk}")
            n_chunks = e // chunk
            agg = _ChunkedAgg.apply(
                self, p, n_nodes, x, pos, src.reshape(n_chunks, chunk),
                dst.reshape(n_chunks, chunk),
                edge_mask.reshape(n_chunks, chunk), None, *_flat(p))
        agg = _pin_channel(agg, self.rules)

        x = x + torch.einsum("nic,cd->nid", agg, lp.out_proj.to(x.dtype))

        # gated FFN
        h2 = self._eq_layernorm(x, lp.ln2_scale)
        gate = torch.sigmoid(h2[:, 0, :] @ lp.ffn_gate.to(x.dtype)
                             ).reshape(-1, self.l_max + 1, self.c)
        outs = []
        for l in range(self.l_max + 1):
            blk = torch.einsum("nmc,cd->nmd", h2[:, self.slices[l], :],
                               lp.ffn_mix[l].to(x.dtype))
            outs.append(blk * gate[:, l][:, None, :])
        return x + torch.cat(outs, dim=1)

    # -- forward ----------------------------------------------------------------

    def apply_layers(self, feats: torch.Tensor, pos: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int,
                     chunk: Optional[int] = None) -> torch.Tensor:
        """Invariant node representations [N, C] (the reference's
        ``apply``)."""
        x0 = (feats @ self.embed_in.to(feats.dtype))[:, None, :]
        x = torch.cat([x0, x0.new_zeros(n_nodes, self.n_coef - 1, self.c)],
                      dim=1)

        def run(x, layers):
            for lp in layers:
                x = self._layer(lp, x, pos, src, dst, edge_mask, n_nodes,
                                chunk)
            return x

        n_layers = self.cfg.n_layers
        if chunk is not None and n_layers % 4 == 0:
            # grouped remat: save x only at group boundaries (4 x |x|
            # instead of L x |x| + per-chunk residuals)
            per = n_layers // 4
            for g in range(4):
                group = list(self.layers)[g * per:(g + 1) * per]
                x = checkpoint(run, x, group, use_reentrant=False)
        else:
            x = run(x, self.layers)
        return F.silu(x[:, 0, :] @ self.head_w1.to(x.dtype))

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        h = self.apply_layers(feats, pos, src, dst, edge_mask, n_nodes, chunk)
        return (h @ self.head_w2.to(h.dtype)).float()


def _chunk_pass(x: torch.Tensor, sb: torch.Tensor, db: torch.Tensor,
                mb: torch.Tensor):
    """(context, chunks) of one pass over the edge chunks: every chunk; on
    meta tensors, whose chunks differ in nothing but values, the first,
    counted once for each chunk by an operation count
    (``launch/op_analysis.repeat``)."""
    if x.device.type != "meta":
        return contextlib.nullcontext(), zip(sb, db, mb)
    from repro_torch.launch.op_analysis import repeat
    return repeat(sb.shape[0]), zip(sb[:1], db[:1], mb[:1])


class _ChunkedAgg(torch.autograd.Function):
    """The chunked attention-aggregation as one primitive (the reference's
    custom VJP, ``equiformer.py:308-351``).  The forward runs two passes
    over the chunks -- each node's largest logit, then the softmax-weighted
    sum -- and keeps only node-sized statistics (node_max M, denominator
    D, output agg).  The backward recomputes each chunk's messages under
    ``enable_grad`` and pushes the softmax cotangents

        d/d msg_e = a_e * g_dst,   d/d l_e = a_e * (<g_dst, msg_e> -
        <g_dst, agg_dst>),   a_e = exp(l_e - M_dst) / D_dst

    through ``autograd.grad`` of the chunk's message function.  Positions
    and edge indices are data (no gradient).  ``combine(kind, t)``, where
    given, reduces the node maxima ("max") and the softmax sums ("sum")
    over the ranks that hold the other edges."""

    @staticmethod
    def forward(ctx, model, like, n_nodes, x, pos, sb, db, mb, combine,
                *ts):
        p = _unflat(like, list(ts))
        node_max = torch.full((n_nodes,), -torch.inf, dtype=torch.float32,
                              device=x.device)
        scope, chunks = _chunk_pass(x, sb, db, mb)
        with scope:
            for s_c, d_c, m_c in chunks:
                logits = model._edge_logits_fast(p, x, pos, s_c, d_c, m_c)
                lmax = torch.max(logits, dim=-1).values
                node_max.scatter_reduce_(
                    0, d_c.long(), torch.where(m_c > 0, lmax, -torch.inf),
                    "amax")
        if combine is not None:
            node_max = combine("max", node_max)
        node_max = torch.where(torch.isfinite(node_max), node_max, 0.0)
        num = torch.zeros((n_nodes, model.n_coef, model.c), dtype=x.dtype,
                          device=x.device)
        den = torch.zeros((n_nodes,), dtype=torch.float32, device=x.device)
        scope, chunks = _chunk_pass(x, sb, db, mb)
        with scope:
            for s_c, d_c, m_c in chunks:
                msg, scal = model._chunk_messages(p, x[s_c], pos, s_c, d_c,
                                                  m_c)
                w = torch.where(m_c > 0, torch.exp(scal - node_max[d_c]),
                                0.0)
                num.index_add_(0, d_c, (msg * w[:, None, None]).to(
                    num.dtype))
                den.index_add_(0, d_c, w)
        if combine is not None:
            num, den = combine("sum", num), combine("sum", den)
        den = torch.clamp(den, min=1e-9)
        agg = num / den[:, None, None].to(num.dtype)
        ctx.model, ctx.like = model, like
        ctx.save_for_backward(x, pos, sb, db, mb, node_max, den, agg, *ts)
        return agg

    @staticmethod
    def backward(ctx, g):
        x, pos, sb, db, mb, node_max, den, agg, *ts = ctx.saved_tensors
        model = ctx.model
        p_bar = [torch.zeros_like(t) for t in ts]
        x_bar = torch.zeros_like(x)
        scope, chunks = _chunk_pass(x, sb, db, mb)
        with scope:
            for s_c, d_c, m_c in chunks:
                _ChunkedAgg._chunk_grads(model, ctx.like, g, x, pos, s_c,
                                         d_c, m_c, node_max, den, agg, ts,
                                         p_bar, x_bar)
        return (None, None, None, x_bar, None, None, None, None, None,
                *p_bar)

    @staticmethod
    def _chunk_grads(model, like, g, x, pos, s_c, d_c, m_c, node_max, den,
                     agg, ts, p_bar, x_bar) -> None:
        """One chunk's messages recomputed and their cotangents pushed into
        ``p_bar`` and ``x_bar``."""
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ts]
            rows = x[s_c].detach().requires_grad_()
            msg, scal = model._chunk_messages(_unflat(like, leaves),
                                              rows, pos, s_c, d_c, m_c)
            w = torch.where(m_c > 0, torch.exp(scal.detach()
                                               - node_max[d_c])
                            / den[d_c], 0.0)
            g_dst = g[d_c]                              # [e, n_coef, C]
            msg_bar = (g_dst * w[:, None, None]).to(msg.dtype)
            inner = torch.sum(g_dst * (msg.detach() - agg[d_c]),
                              dim=(1, 2))
            scal_bar = (w * inner).to(scal.dtype)
            grads = torch.autograd.grad((msg, scal), leaves + [rows],
                                        (msg_bar, scal_bar),
                                        allow_unused=True)
        for acc, gr in zip(p_bar, grads[:-1]):
            if gr is not None:
                acc.add_(gr)
        x_bar.index_add_(0, s_c, grads[-1])
