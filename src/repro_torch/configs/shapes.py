"""The reference's input-shape set (``src/repro/configs/shapes.py``,
copied).  Every (arch x shape) cell is well-defined here.

``train_*`` count a train step; ``prefill_*`` the prefill forward;
``decode_*`` / ``long_*`` one decode step (one new token with a KV cache
of ``seq_len``). ``long_500k`` is only lowered for sub-quadratic archs
(``ModelConfig.is_sub_quadratic``), per the assignment.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    sub_quadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           sub_quadratic_only=True),
}


def cells(configs):
    """Yield every runnable (arch_name, shape_name) cell, applying skips."""
    for name, cfg in configs.items():
        for sname, shape in SHAPES.items():
            if shape.sub_quadratic_only and not cfg.runs_long_context:
                continue
            yield name, sname
