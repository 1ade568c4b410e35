"""Qwen2.5-3B: 36L, d=2048, 16H GQA(kv=2), d_ff=11008, vocab 151936, QKV bias.

[hf:Qwen/Qwen2.5 family; hf].
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="full", q_heads=16, kv_heads=2, head_dim=128,
                         qkv_bias=True, rope=True, rope_theta=1_000_000.0)
    ffn = FFNSpec(kind="dense", d_ff=11008, activation="swiglu")
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        d_model=2048,
        vocab_size=151936,
        groups=(GroupSpec(blocks=(block,), repeats=36),),
        tie_embeddings=True,
        max_seq_len=32768,
        source="hf:Qwen/Qwen2.5-3B",
        notes="GQA kv=2 with QKV bias; tied embeddings.",
    )
