"""Zeroed single-request cache payloads (counterpart of
``src/repro/models/paged.py::zero_request_payload``; the paged KV layout
itself is a later slice of the port)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionSpec, ModelConfig
from repro_torch.models.model import torch_dtype


def zero_request_payload(cfg: ModelConfig, L: int, device):
    """Zeroed prefill caches of one request (leaves (R, 1, L, ...)) in the
    trimmed format decode admission consumes."""
    dt = torch_dtype(cfg)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    groups = []
    for g in cfg.groups:
        R = g.repeats
        gc = {}
        for bi, b in enumerate(g.blocks):
            m = b.mixer
            if isinstance(m, AttentionSpec):         # MLA
                c = {"ckv": zeros((R, 1, L, m.mla_kv_rank), dt),
                     "kpe": zeros((R, 1, L, m.mla_rope_dim), dt)}
            else:
                c = {"state": zeros((R, 1, m.heads, m.key_dim, m.value_dim),
                                    torch.float32)}
                if m.conv_kernel:
                    C = m.heads * (2 * m.key_dim + m.value_dim)
                    c["conv"] = zeros((R, 1, m.conv_kernel - 1, C), dt)
            gc[f"b{bi}"] = c
        groups.append(gc)
    return {"groups": groups}
