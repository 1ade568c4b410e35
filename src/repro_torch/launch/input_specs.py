"""``meta``-tensor stand-ins for every (arch x shape) dry-run cell
(``src/repro/launch/input_specs.py``).

Nothing is allocated: params come from ``init_params(..., "meta")``,
batches are ``meta`` tensors, decode caches come from
``Model.init_cache`` on ``meta``.  Each has the shape and dtype of the
reference's ``eval_shape`` struct, leaf for leaf.  Modality frontends are
stubs, as in the reference: a VLM cell gets precomputed patch embeddings,
an audio cell precomputed frame embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import Model
from repro_torch.models.model import torch_dtype
from repro_torch.params import init_params

META = torch.device("meta")
DECODE_HEADROOM = 8


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def frontend_extras(cfg: ModelConfig, batch: int, seq: int, specs: dict):
    """Add a VLM's ``patches`` and an encoder-decoder's ``frames``."""
    dt = torch_dtype(cfg)
    if cfg.num_image_patches:
        specs["patches"] = _meta((batch, cfg.num_image_patches, cfg.d_model),
                                 dt)
    if cfg.encoder_groups is not None:
        specs["frames"] = _meta((batch, seq, cfg.encoder_input_dim), dt)
    return specs


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    specs = {"tokens": _meta((shape.global_batch, shape.seq_len + 1),
                             torch.int32)}
    return frontend_extras(cfg, shape.global_batch, shape.seq_len, specs)


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    specs = {"tokens": _meta((shape.global_batch, shape.seq_len),
                             torch.int32)}
    return frontend_extras(cfg, shape.global_batch, shape.seq_len, specs)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec,
                 headroom: int = DECODE_HEADROOM):
    """(tokens, caches, lengths) of one decode step: one new token a row
    over a cache of ``seq_len + headroom`` rows."""
    B = shape.global_batch
    enc_len = shape.seq_len if cfg.encoder_groups is not None else 0
    caches = Model(cfg).init_cache(B, shape.seq_len + headroom, META,
                                   enc_len=enc_len)
    return _meta((B,), torch.int32), caches, _meta((B,), torch.int32)


def params_specs(cfg: ModelConfig):
    return init_params(cfg, torch.Generator().manual_seed(0), META)
