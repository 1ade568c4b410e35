"""Mistral-Nemo-12B: 40L, d=5120, 32H GQA(kv=8), head_dim=128, d_ff=14336.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]. 128k context; q_heads*head_dim
(4096) deliberately != d_model (5120), matching the released config.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="full", q_heads=32, kv_heads=8, head_dim=128,
                         rope=True, rope_theta=1_000_000.0)
    ffn = FFNSpec(kind="dense", d_ff=14336, activation="swiglu")
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        d_model=5120,
        vocab_size=131072,
        groups=(GroupSpec(blocks=(block,), repeats=40),),
        max_seq_len=131072,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        notes="128k ctx; head_dim 128 (q_heads*head_dim != d_model).",
    )
