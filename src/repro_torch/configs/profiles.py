"""Approximate public configs for the paper's Table 1/3 comparison models
(``src/repro/configs/profiles.py``, copied with its imports rewritten).

These are *profile* configs: used by the Φ_kv / bandwidth benchmarks for
S_kv and FLOP accounting, not as assigned dry-run architectures. Dims are
taken from public releases / tech reports where published, else approximated
from stated totals; each entry notes its provenance.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, LinearSpec, ModelConfig)


def kimi_linear_48b() -> ModelConfig:
    """Kimi Linear 48B-A3B [arXiv:2510.26692]: KDA:MLA 3:1."""
    kda = LinearSpec(kind="kda", heads=32, key_dim=128, value_dim=128)
    mla = AttentionSpec(kind="mla", q_heads=32, kv_heads=32, head_dim=128,
                        mla_kv_rank=512, mla_rope_dim=64)
    moe = FFNSpec(kind="moe", d_ff=1408, activation="swiglu",
                  num_experts=256, top_k=8, shared_experts=1)
    return ModelConfig(
        name="kimi-linear-48b", family="hybrid", d_model=4096,
        vocab_size=163840,
        groups=(GroupSpec(blocks=(BlockSpec(kda, moe), BlockSpec(kda, moe),
                                  BlockSpec(kda, moe), BlockSpec(mla, moe)),
                          repeats=12),),
        source="arXiv:2510.26692")


def mimo_v2_flash() -> ModelConfig:
    """MiMo-V2-Flash 309B [arXiv:2601.02780]: SWA:GQA 5:1 MoE."""
    swa = AttentionSpec(kind="swa", q_heads=48, kv_heads=8, head_dim=128,
                        window=4096)
    gqa = AttentionSpec(kind="full", q_heads=48, kv_heads=8, head_dim=128)
    moe = FFNSpec(kind="moe", d_ff=2048, activation="swiglu",
                  num_experts=256, top_k=8, shared_experts=1)
    return ModelConfig(
        name="mimo-v2-flash", family="hybrid", d_model=6144,
        vocab_size=151936,
        groups=(GroupSpec(blocks=(BlockSpec(swa, moe),) * 5 +
                                 (BlockSpec(gqa, moe),),
                          repeats=8),),
        source="arXiv:2601.02780")


def qwen3_5_397b() -> ModelConfig:
    """Qwen3.5-397B [qwen.ai blog]: GDN:GQA 3:1 MoE."""
    gdn = LinearSpec(kind="gdn", heads=32, key_dim=128, value_dim=128)
    gqa = AttentionSpec(kind="full", q_heads=64, kv_heads=4, head_dim=128)
    moe = FFNSpec(kind="moe", d_ff=2560, activation="swiglu",
                  num_experts=384, top_k=10, shared_experts=1)
    return ModelConfig(
        name="qwen3.5-397b", family="hybrid", d_model=6144,
        vocab_size=151936,
        groups=(GroupSpec(blocks=(BlockSpec(gdn, moe), BlockSpec(gdn, moe),
                                  BlockSpec(gdn, moe), BlockSpec(gqa, moe)),
                          repeats=15),),
        source="qwen.ai blog (Qwen3.5)")


def ring_2_5_1t() -> ModelConfig:
    """Ring-2.5-1T [github:inclusionAI/Ring-V2.5]: Lightning:MLA 7:1 MoE."""
    lightning = LinearSpec(kind="gla", heads=48, key_dim=128, value_dim=128)
    mla = AttentionSpec(kind="mla", q_heads=64, kv_heads=64, head_dim=128,
                        mla_kv_rank=512, mla_rope_dim=64)
    moe = FFNSpec(kind="moe", d_ff=2048, activation="swiglu",
                  num_experts=384, top_k=8, shared_experts=1)
    return ModelConfig(
        name="ring-2.5-1t", family="hybrid", d_model=7168,
        vocab_size=157184,
        groups=(GroupSpec(blocks=(BlockSpec(lightning, moe),) * 7 +
                                 (BlockSpec(mla, moe),),
                          repeats=8),),
        source="github:inclusionAI/Ring-V2.5")


def minimax_m2_5() -> ModelConfig:
    """MiniMax-M2.5 229B [minimax.io]: dense full GQA (the paper's 'dense' foil)."""
    gqa = AttentionSpec(kind="full", q_heads=48, kv_heads=8, head_dim=128)
    moe = FFNSpec(kind="moe", d_ff=2560, activation="swiglu",
                  num_experts=256, top_k=8, shared_experts=1)
    return ModelConfig(
        name="minimax-m2.5", family="moe", d_model=6144,
        vocab_size=200064,
        groups=(GroupSpec(blocks=(BlockSpec(gqa, moe),), repeats=62),),
        source="minimax.io (M2.5)")


def qwen3_235b() -> ModelConfig:
    """Qwen3-235B-A22B [arXiv:2505.09388]: 94L GQA kv=4 MoE."""
    gqa = AttentionSpec(kind="full", q_heads=64, kv_heads=4, head_dim=128)
    moe = FFNSpec(kind="moe", d_ff=1536, activation="swiglu",
                  num_experts=128, top_k=8)
    return ModelConfig(
        name="qwen3-235b", family="moe", d_model=4096,
        vocab_size=151936,
        groups=(GroupSpec(blocks=(BlockSpec(gqa, moe),), repeats=94),),
        source="arXiv:2505.09388")


PROFILE_MODELS = {
    "kimi-linear-48b": kimi_linear_48b,
    "mimo-v2-flash": mimo_v2_flash,
    "qwen3.5-397b": qwen3_5_397b,
    "ring-2.5-1t": ring_2_5_1t,
    "minimax-m2.5": minimax_m2_5,
    "qwen3-235b": qwen3_235b,
}
