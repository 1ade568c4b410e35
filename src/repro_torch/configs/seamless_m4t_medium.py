"""SeamlessM4T-medium: enc-dec, 12L+12L, d=1024, 16H MHA(kv=16), d_ff=4096.

[arXiv:2308.11596; hf]. Multimodal enc-dec; per the assignment the audio
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
(B, src_len, d_model) consumed directly by the transformer encoder. The
decoder has self-attention (cached) + cross-attention over encoder output.

PrfaaS mapping: the encoder plays the "prefill" role (compute-dense, produces
the cross-attention K/V = this arch's 'KVCache'), the decoder the "decode"
role — the paper's P/D split falls on the enc/dec boundary.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                ModelConfig)


def build() -> ModelConfig:
    self_attn = AttentionSpec(kind="full", q_heads=16, kv_heads=16,
                              head_dim=64, rope=False)
    cross_attn = AttentionSpec(kind="full", q_heads=16, kv_heads=16,
                               head_dim=64, rope=False, is_cross=True)
    ffn = FFNSpec(kind="dense", d_ff=4096, activation="gelu")
    enc_block = BlockSpec(mixer=self_attn, ffn=ffn)
    dec_block = BlockSpec(mixer=self_attn, ffn=ffn, cross=cross_attn)
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        d_model=1024,
        vocab_size=256206,
        groups=(GroupSpec(blocks=(dec_block,), repeats=12),),
        encoder_groups=(GroupSpec(blocks=(enc_block,), repeats=12),),
        encoder_input_dim=1024,
        max_seq_len=8192,
        source="arXiv:2308.11596",
        notes="enc-dec; audio frontend stubbed as precomputed frame embeds.",
    )
