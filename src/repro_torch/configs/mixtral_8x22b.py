"""Mixtral-8x22B: 56L, d=6144, 48H GQA(kv=8), d_ff=16384, 8 experts top-2, SWA.

[arXiv:2401.04088; hf]. Sliding-window attention (Mistral lineage, w=4096)
bounds the KV cache, which is what makes this MoE arch PrfaaS-friendly.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="swa", q_heads=48, kv_heads=8, head_dim=128,
                         window=4096, rope=True, rope_theta=1_000_000.0)
    ffn = FFNSpec(kind="moe", d_ff=16384, activation="swiglu",
                  num_experts=8, top_k=2)
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        d_model=6144,
        vocab_size=32768,
        groups=(GroupSpec(blocks=(block,), repeats=56),),
        max_seq_len=65536,
        source="arXiv:2401.04088",
        notes="8 experts top-2; SWA window 4096 bounds per-layer KV.",
    )
