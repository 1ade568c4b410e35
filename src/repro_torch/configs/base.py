"""Model/config dataclasses shared by every architecture.

A model is a stack of *groups*; each group is a repeated sequence of
``BlockSpec``s (the repeat unit).  ``lax.scan`` runs over the repeats of a
group with stacked parameters, which keeps HLO size and compile time bounded
for 50+ layer models while still expressing hybrid interleaves
(e.g. [KDA, KDA, KDA, MLA] x 16).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Mixer specs (the sequence-mixing half of a block)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionSpec:
    """Full (quadratic) attention: MHA / GQA / MQA / SWA / MLA."""

    kind: str = "full"          # "full" | "swa" | "mla"
    q_heads: int = 8
    kv_heads: int = 8
    head_dim: int = 128
    window: int = 0             # >0 => sliding-window attention
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    # MLA-only fields (DeepSeek-V2 style latent compression).
    mla_kv_rank: int = 512      # latent c_kv dim (cached)
    mla_rope_dim: int = 64      # decoupled rope key dim (cached)
    mla_q_rank: int = 0         # 0 => full-rank q projection
    is_cross: bool = False      # encoder-decoder cross attention

    @property
    def is_sub_quadratic(self) -> bool:
        return self.window > 0

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token per-layer KVCache bytes (the paper's S_kv contribution)."""
        if self.kind == "mla":
            return (self.mla_kv_rank + self.mla_rope_dim) * dtype_bytes
        return 2 * self.kv_heads * self.head_dim * dtype_bytes

    def kv_cache_tokens(self, seq_len: int) -> int:
        """Number of cached token slots (SWA bounds this by the window)."""
        if self.kind == "swa" and self.window > 0:
            return min(seq_len, self.window)
        return seq_len


@dataclass(frozen=True)
class LinearSpec:
    """Bounded-state sequence mixers: KDA / GDN / GLA / Mamba2 / mLSTM / sLSTM."""

    kind: str = "gla"           # "kda" | "gdn" | "gla" | "mamba2" | "mlstm" | "slstm"
    heads: int = 8
    key_dim: int = 128          # per-head key/state dim
    value_dim: int = 128        # per-head value dim
    conv_kernel: int = 4        # short depthwise conv on q/k/v paths (0 = off)
    state_dtype_bytes: int = 4  # recurrent state kept in fp32

    @property
    def is_sub_quadratic(self) -> bool:
        return True

    def state_bytes(self) -> int:
        """Fixed per-request recurrent-state bytes (length independent)."""
        if self.kind == "slstm":
            # scalar-memory cells: (c, n, h, m) per head-dim unit
            return 4 * self.heads * self.value_dim * self.state_dtype_bytes
        s = self.heads * self.key_dim * self.value_dim * self.state_dtype_bytes
        if self.kind in ("mlstm",):
            # + normalizer n (heads, key_dim) and max-state m (heads,)
            s += self.heads * (self.key_dim + 1) * self.state_dtype_bytes
        if self.conv_kernel:
            s += self.conv_kernel * self.heads * (self.key_dim * 2 + self.value_dim) * 2
        return s


# ---------------------------------------------------------------------------
# FFN specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FFNSpec:
    kind: str = "dense"         # "dense" | "moe" | "none"
    d_ff: int = 0
    activation: str = "swiglu"  # "swiglu" | "gelu" | "geglu"
    # MoE fields
    num_experts: int = 0
    top_k: int = 0
    shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class BlockSpec:
    mixer: object               # AttentionSpec | LinearSpec
    ffn: FFNSpec
    shared: bool = False        # zamba-style: parameters shared across repeats
    cross: Optional[AttentionSpec] = None  # enc-dec decoder cross-attention


@dataclass(frozen=True)
class GroupSpec:
    """``repeats`` x ``blocks`` with stacked params scanned over repeats."""

    blocks: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.blocks) * self.repeats


# ---------------------------------------------------------------------------
# Whole-model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # "dense" | "moe" | "vlm" | "audio" | "hybrid" | "ssm"
    d_model: int
    vocab_size: int
    groups: Tuple[GroupSpec, ...]
    # encoder (enc-dec only); None for decoder-only LMs
    encoder_groups: Optional[Tuple[GroupSpec, ...]] = None
    encoder_input_dim: int = 0  # >0: continuous frontend features (audio stub)
    num_image_patches: int = 0  # >0: VLM patch-embedding stub prepended
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # Reference/bookkeeping
    source: str = ""
    notes: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    def iter_blocks(self):
        """Yield (group_idx, repeat_idx, block_idx, BlockSpec) in stack order."""
        for gi, g in enumerate(self.groups):
            for r in range(g.repeats):
                for bi, b in enumerate(g.blocks):
                    yield gi, r, bi, b

    def full_attn_layers(self) -> int:
        return sum(1 for *_, b in self.iter_blocks()
                   if isinstance(b.mixer, AttentionSpec))

    def linear_layers(self) -> int:
        return sum(1 for *_, b in self.iter_blocks()
                   if isinstance(b.mixer, LinearSpec))

    @property
    def is_sub_quadratic(self) -> bool:
        """True iff no unbounded full-attention layer exists."""
        for *_, b in self.iter_blocks():
            m = b.mixer
            if isinstance(m, AttentionSpec) and not m.is_sub_quadratic:
                return False
        return True

    @property
    def runs_long_context(self) -> bool:
        """long_500k eligibility: SSM/hybrid/linear-attn/SWA archs run it;
        pure full-attention archs skip (per assignment)."""
        return self.is_sub_quadratic or self.family in ("hybrid", "ssm")

    # -- parameter counting (used for 6ND model flops & memory estimates) ---
    def _block_params(self, b: BlockSpec) -> int:
        d = self.d_model
        n = 0
        m = b.mixer
        if isinstance(m, AttentionSpec):
            if m.kind == "mla":
                qd = m.q_heads * m.head_dim
                n += d * (m.mla_q_rank or qd)
                if m.mla_q_rank:
                    n += m.mla_q_rank * qd
                n += d * (m.mla_kv_rank + m.mla_rope_dim)
                n += m.mla_kv_rank * (m.kv_heads * m.head_dim * 2)
                n += qd * d  # o_proj
            else:
                n += d * m.q_heads * m.head_dim          # q
                n += 2 * d * m.kv_heads * m.head_dim     # k, v
                n += m.q_heads * m.head_dim * d          # o
                if m.qkv_bias:
                    n += (m.q_heads + 2 * m.kv_heads) * m.head_dim
        else:
            h, dk, dv = m.heads, m.key_dim, m.value_dim
            n += d * h * (2 * dk + dv)                   # q,k,v projections
            n += h * dv * d                              # o
            n += d * h * 2                               # gates (decay, beta/out-gate)
            if m.conv_kernel:
                n += m.conv_kernel * h * (2 * dk + dv)
            if m.kind == "slstm":
                n = d * 4 * h * dv * 2 + 4 * h * dv      # i,f,z,o x (W, R) + bias
        if b.cross is not None:
            c = b.cross
            n += d * c.q_heads * c.head_dim + 2 * d * c.kv_heads * c.head_dim
            n += c.q_heads * c.head_dim * d
        f = b.ffn
        if f.kind == "dense":
            mult = 3 if f.activation in ("swiglu", "geglu") else 2
            n += mult * d * f.d_ff
        elif f.kind == "moe":
            mult = 3 if f.activation in ("swiglu", "geglu") else 2
            n += f.num_experts * mult * d * f.d_ff
            n += d * f.num_experts                        # router
            n += f.shared_experts * mult * d * f.d_ff
        n += 2 * d  # two RMSNorm scales
        return n

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for *_, b in self.iter_blocks():
            n += self._block_params(b)
        if self.encoder_groups:
            for g in self.encoder_groups:
                for _ in range(g.repeats):
                    for b in g.blocks:
                        n += self._block_params(b)
            if self.encoder_input_dim:
                n += self.encoder_input_dim * self.d_model
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for *_, b in self.iter_blocks():
            f = b.ffn
            if f.kind == "moe":
                dense_b = dataclasses.replace(
                    b, ffn=FFNSpec(kind="dense", d_ff=f.d_ff * (f.top_k + f.shared_experts),
                                   activation=f.activation))
                n += self._block_params(dense_b)
            else:
                n += self._block_params(b)
        if self.encoder_groups:
            for g in self.encoder_groups:
                for _ in range(g.repeats):
                    for b in g.blocks:
                        n += self._block_params(b)
        n += self.d_model
        return n

    # -- KVCache accounting (paper Eq. 1 numerator) --------------------------
    def kv_cache_bytes(self, seq_len: int, dtype_bytes: int = 2) -> int:
        """Total per-request KVCache+state bytes at context ``seq_len``."""
        total = 0
        blocks = list(self.iter_blocks())
        if self.encoder_groups is not None:
            # decoder self-attn caches + cross-attn K/V over encoder output
            for g in self.encoder_groups:
                pass  # encoder itself holds no serving-time cache
        for *_, b in blocks:
            m = b.mixer
            if isinstance(m, AttentionSpec):
                total += m.kv_bytes_per_token(dtype_bytes) * m.kv_cache_tokens(seq_len)
            else:
                total += m.state_bytes()
            if b.cross is not None:
                c = b.cross
                total += c.kv_bytes_per_token(dtype_bytes) * seq_len
        return total


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers, narrow dims."""

    def _shrink_mixer(m):
        if isinstance(m, AttentionSpec):
            q = max(2, min(4, m.q_heads))
            kv = 1 if m.kv_heads == 1 else max(1, min(2, m.kv_heads))
            if m.kv_heads == m.q_heads:
                kv = q
            return dataclasses.replace(
                m, q_heads=q, kv_heads=kv, head_dim=16,
                window=min(m.window, 64) if m.window else 0,
                mla_kv_rank=32 if m.kind == "mla" else m.mla_kv_rank,
                mla_rope_dim=16 if m.kind == "mla" else m.mla_rope_dim,
                mla_q_rank=0)
        return dataclasses.replace(m, heads=2, key_dim=16, value_dim=16,
                                   conv_kernel=min(m.conv_kernel, 4))

    def _shrink_ffn(f):
        if f.kind == "none":
            return f
        return dataclasses.replace(
            f, d_ff=64,
            num_experts=min(f.num_experts, 4) if f.kind == "moe" else 0,
            top_k=min(f.top_k, 2) if f.kind == "moe" else 0,
            shared_experts=min(f.shared_experts, 1))

    def _shrink_groups(groups):
        out = []
        for g in groups:
            blocks = tuple(
                dataclasses.replace(b, mixer=_shrink_mixer(b.mixer),
                                    ffn=_shrink_ffn(b.ffn),
                                    cross=_shrink_mixer(b.cross) if b.cross else None)
                for b in g.blocks)
            out.append(GroupSpec(blocks=blocks, repeats=min(g.repeats, 2)))
        return tuple(out)

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        vocab_size=256,
        groups=_shrink_groups(cfg.groups),
        encoder_groups=_shrink_groups(cfg.encoder_groups) if cfg.encoder_groups else None,
        encoder_input_dim=64 if cfg.encoder_input_dim else 0,
        num_image_patches=8 if cfg.num_image_patches else 0,
        max_seq_len=512,
        dtype="float32",
    )
