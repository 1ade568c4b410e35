"""Llama4-Scout-17B-A16E: 48L, d=5120, 40H GQA(kv=8), d_ff=8192, 16e top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. MoE with a shared expert
and top-1 routing; full GQA attention (no window) -> long_500k skipped.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="full", q_heads=40, kv_heads=8, head_dim=128,
                         rope=True, rope_theta=500_000.0)
    ffn = FFNSpec(kind="moe", d_ff=8192, activation="swiglu",
                  num_experts=16, top_k=1, shared_experts=1)
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        d_model=5120,
        vocab_size=202048,
        groups=(GroupSpec(blocks=(block,), repeats=48),),
        max_seq_len=131072,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        notes="16 routed experts top-1 + 1 shared; early-fusion text backbone.",
    )
