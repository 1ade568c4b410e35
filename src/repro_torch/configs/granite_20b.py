"""Granite-20B (code): 52L, d=6144, 48H MQA(kv=1), d_ff=24576, vocab 49152.

[arXiv:2405.04324; hf]. MQA already shrinks KV 48x vs MHA; dense FFN.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="full", q_heads=48, kv_heads=1, head_dim=128,
                         rope=True)
    ffn = FFNSpec(kind="dense", d_ff=24576, activation="gelu")
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="granite-20b",
        family="dense",
        d_model=6144,
        vocab_size=49152,
        groups=(GroupSpec(blocks=(block,), repeats=52),),
        max_seq_len=8192,
        source="arXiv:2405.04324",
        notes="llama-arch code model; MQA kv=1.",
    )
