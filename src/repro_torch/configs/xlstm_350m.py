"""xLSTM-350M: 24L, d=1024, 4H, alternating mLSTM / sLSTM blocks, d_ff=0.

[arXiv:2405.04517; unverified]. Blocks carry their own up/down projections
(pre-up-projection xLSTM style), so there is no separate FFN (d_ff=0 ->
FFNSpec 'none'). mLSTM is a matrix-memory gated linear attention (bounded
state), sLSTM a scalar-memory recurrent cell — both O(1) state, so every
shape incl. long_500k runs.
"""
from repro_torch.configs.base import (BlockSpec, FFNSpec, GroupSpec,
                                      LinearSpec, ModelConfig)


def build() -> ModelConfig:
    mlstm = LinearSpec(kind="mlstm", heads=4, key_dim=256, value_dim=256,
                       conv_kernel=4)
    slstm = LinearSpec(kind="slstm", heads=4, key_dim=256, value_dim=256,
                       conv_kernel=4)
    no_ffn = FFNSpec(kind="none")
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        d_model=1024,
        vocab_size=50304,
        groups=(GroupSpec(blocks=(BlockSpec(mixer=mlstm, ffn=no_ffn),
                                  BlockSpec(mixer=slstm, ffn=no_ffn)),
                          repeats=12),),
        tie_embeddings=True,
        max_seq_len=1_048_576,
        source="arXiv:2405.04517",
        notes="sLSTM+mLSTM 1:1 interleave; blocks embed their own FFN paths.",
    )
