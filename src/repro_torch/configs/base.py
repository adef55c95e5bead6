"""Config system: dataclasses for architectures, input shapes, meshes, training.

Every assigned architecture gets one module in ``repro.configs`` exporting
``ARCH`` (an :class:`ArchSpec`).  The registry in ``repro.configs.__init__``
resolves ``--arch <id>`` strings.

Shapes are *first-class*: each architecture carries its own shape set, so a
(arch x shape) cell is fully defined by ``get_arch(name).shapes[shape_name]``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LMShape:
    """seq_len x global_batch cell for LM-family transformers.

    ``kind``:
      * ``train``   -> lowers ``train_step`` (fwd+bwd+optimizer)
      * ``prefill`` -> lowers ``prefill_step`` (forward, builds KV cache)
      * ``decode``  -> lowers ``serve_step`` (1 new token, KV cache of seq_len)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class GraphShape:
    """GNN cell. ``kind``:

      * ``full_graph`` -> full-batch training step on one big graph
      * ``minibatch``  -> sampled-subgraph training step (needs neighbor sampler)
      * ``batched``    -> batch of small graphs (molecules)
    """

    name: str
    kind: str  # full_graph | minibatch | batched
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0          # minibatch only
    fanout: Tuple[int, ...] = ()  # minibatch only
    batch_graphs: int = 0         # batched only


@dataclass(frozen=True)
class RecsysShape:
    """RecSys cell. ``kind``:

      * ``train``     -> train_step on a batch of (dense, sparse) features
      * ``serve``     -> inference scoring of a batch
      * ``retrieval`` -> score 1 query against ``n_candidates`` (batched-dot / ANN)
    """

    name: str
    kind: str  # train | serve | retrieval
    batch: int
    n_candidates: int = 0


Shape = Any  # LMShape | GraphShape | RecsysShape


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class YarnRope:
    """DeepSeek-V2's YaRN RoPE scaling (its ``rope_scaling`` of type
    "yarn"), as its published modeling code computes it: the rotary
    frequencies ramp from interpolated (``base / factor``) to the
    original ones between the dims that ``beta_fast`` and ``beta_slow``
    name at ``original_max_position`` positions; cos and sin are scaled
    by ``m(mscale) / m(mscale_all_dim)`` and the softmax scale by
    ``m(mscale_all_dim)^2``, m(a) = 0.1 a ln(factor) + 1.  The rotary
    dims are paired as that code pairs them: (0, 1), (2, 3), ...
    (interleaved), where the port's plain RoPE pairs i with i + D/2.

    On GQA it is ``transformers``' ``rope_type: "yarn"``: the same
    frequencies, the port's plain pairing (i with i + D/2), cos and sin
    scaled by ``attention_factor`` and the softmax scale left as it is."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    attention_factor: Optional[float] = None   # GQA: cos / sin scale


@dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only LM; covers dense, GQA, qk-norm, fine-grained MoE and MLA."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE (0 routed experts == dense) ---
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size (fine-grained)
    capacity_factor: float = 1.25
    first_dense_layers: int = 1       # DeepSeek keeps layer 0 dense
    # --- MLA (kv_lora_rank > 0 enables it) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- numerics / scale ---
    dtype: str = "bfloat16"
    fsdp: bool = False                # shard params over the data axis too
    remat: bool = True
    grad_accum: int = 1               # microbatches per train step
    attn_block_q: int = 512           # chunked-attention block sizes (XLA path)
    attn_block_kv: int = 1024
    fused_norm: bool = False          # §Perf: no fp32 materialization in norms
    bf16_probs: bool = False          # §Perf: bf16 softmax weights in attention
    # --- the port's own (the reference's configs have none of them; each
    # off by default, so every registered arch runs as before) ---
    yarn: Optional[YarnRope] = None   # YaRN RoPE scaling (full layers)
    norm_topk_prob: bool = True       # renormalise the top-k gate weights
    dropless: bool = False            # MoE: every (token, choice) pair runs
    # per-layer attention kinds, as ``transformers`` names them
    # ("sliding_attention" / "full_attention"; empty: every layer full);
    # a sliding layer sees its last ``sliding_window`` keys (itself
    # included) and rotates with plain RoPE at ``rope_theta``
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def window(self, layer: int) -> int:
        """Keys layer ``layer`` sees behind a query, itself included (0:
        every key up to it)."""
        if self.layer_types and self.layer_types[layer] == "sliding_attention":
            return self.sliding_window
        return 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_mla:
            qdim = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = 0
            if self.q_lora_rank:
                attn += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qdim
            else:
                attn += d * self.n_heads * qdim
            attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            attn += self.n_heads * self.head_dim * d
        dense_ffn = 3 * d * self.d_ff
        if self.is_moe:
            expert = 3 * d * self.moe_d_ff
            moe_ffn = (self.n_routed_experts + self.n_shared_experts) * expert + d * self.n_routed_experts
            n_moe = L - self.first_dense_layers
            ffn_total = self.first_dense_layers * dense_ffn + n_moe * moe_ffn
        else:
            ffn_total = L * dense_ffn
        return emb + L * attn + ffn_total + 2 * L * d  # + norms

    def active_param_count(self) -> int:
        """Params touched per token (for MODEL_FLOPS = 6 * N_active * D)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        expert = 3 * d * self.moe_d_ff
        n_moe = L - self.first_dense_layers
        inactive = n_moe * (self.n_routed_experts - self.top_k) * expert
        return full - inactive


@dataclass(frozen=True)
class GNNConfig:
    """Message-passing GNNs (SpMM / triplet / irrep regimes)."""

    kind: str                     # gcn | graphsage | schnet | equiformer_v2
    n_layers: int
    d_hidden: int
    aggregator: str = "mean"
    # graphsage
    sample_sizes: Tuple[int, ...] = ()
    # gcn
    norm: str = "sym"
    # schnet
    n_rbf: int = 0
    cutoff: float = 0.0
    # equiformer
    l_max: int = 0
    m_max: int = 0
    n_heads: int = 0
    n_classes: int = 41
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding + feature-interaction + MLP rankers."""

    kind: str                     # autoint
    n_sparse: int
    embed_dim: int
    n_attn_layers: int
    n_heads: int
    d_attn: int
    vocab_per_field: int = 1_000_000   # rows per embedding table
    mlp_dims: Tuple[int, ...] = (400, 400)
    multi_hot: int = 4                 # ids per field (EmbeddingBag regime)
    dtype: str = "float32"


ModelConfig = Any  # TransformerConfig | GNNConfig | RecsysConfig


# ---------------------------------------------------------------------------
# Arch spec (config + its own shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str              # lm | gnn | recsys
    model: ModelConfig
    shapes: Dict[str, Shape]
    source: str = ""         # provenance tag from the assignment
    notes: str = ""

    def shape(self, name: str) -> Shape:
        return self.shapes[name]


# Canonical LM shape set shared by the five LM archs (each arch re-instantiates
# so that a cell is (arch x its own shape object)).
def lm_shapes() -> Dict[str, LMShape]:
    return {
        "train_4k": LMShape("train_4k", seq_len=4_096, global_batch=256, kind="train"),
        "prefill_32k": LMShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
        "decode_32k": LMShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
        "long_500k": LMShape("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
    }


def gnn_shapes() -> Dict[str, GraphShape]:
    return {
        "full_graph_sm": GraphShape(
            "full_graph_sm", kind="full_graph", n_nodes=2_708, n_edges=10_556, d_feat=1_433
        ),
        "minibatch_lg": GraphShape(
            "minibatch_lg", kind="minibatch", n_nodes=232_965, n_edges=114_615_892,
            d_feat=602, batch_nodes=1_024, fanout=(15, 10),
        ),
        "ogb_products": GraphShape(
            "ogb_products", kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
        ),
        "molecule": GraphShape(
            "molecule", kind="batched", n_nodes=30, n_edges=64, batch_graphs=128, d_feat=0
        ),
    }


def recsys_shapes() -> Dict[str, RecsysShape]:
    return {
        "train_batch": RecsysShape("train_batch", kind="train", batch=65_536),
        "serve_p99": RecsysShape("serve_p99", kind="serve", batch=512),
        "serve_bulk": RecsysShape("serve_bulk", kind="serve", batch=262_144),
        "retrieval_cand": RecsysShape(
            "retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000
        ),
    }


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Small-config derivation for smoke tests (same family, tiny dims)."""
    return dataclasses.replace(cfg, **overrides)
