"""H2O-Danube-1.8B: 24L, d=2560, 32H GQA(kv=8), d_ff=6912, vocab 32000, SWA.

[arXiv:2401.16818; hf]. Llama+Mistral mix with sliding-window attention.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="swa", q_heads=32, kv_heads=8, head_dim=80,
                         window=4096, rope=True)
    ffn = FFNSpec(kind="dense", d_ff=6912, activation="swiglu")
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        d_model=2560,
        vocab_size=32000,
        groups=(GroupSpec(blocks=(block,), repeats=24),),
        max_seq_len=16384,
        source="arXiv:2401.16818",
        notes="SWA window 4096; head_dim 80 (d_model/q_heads).",
    )
