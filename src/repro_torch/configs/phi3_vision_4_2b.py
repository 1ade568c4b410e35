"""Phi-3-Vision-4.2B: 32L, d=3072, 32H MHA(kv=32), d_ff=8192, vocab 32064.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]. phi3-mini text backbone +
CLIP frontend. Per the assignment, the modality frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (B, 576, d_model)
that the model prepends to the token stream.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    attn = AttentionSpec(kind="full", q_heads=32, kv_heads=32, head_dim=96,
                         rope=True)
    ffn = FFNSpec(kind="dense", d_ff=8192, activation="swiglu")
    block = BlockSpec(mixer=attn, ffn=ffn)
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        d_model=3072,
        vocab_size=32064,
        groups=(GroupSpec(blocks=(block,), repeats=32),),
        num_image_patches=576,
        max_seq_len=131072,
        source="hf:microsoft/Phi-3-vision-128k-instruct",
        notes="MHA backbone; CLIP patch embeds are a precomputed stub input.",
    )
