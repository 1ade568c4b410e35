"""KV-cache byte accounting and the int8 wire format of the cross-DC link.

Counterpart of ``src/repro/models/kvcache.py`` (with the reference's
``distributed/collectives.py::dequantize_int8``).  The wire pytree of a
cache is the cache with every K/V/latent leaf replaced by
``{"q": int8, "scale": 0-d tensor in the leaf's dtype}``; recurrent
float32 states ship as they are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.tree import tree_leaves, tree_map_named

WIRE_LEAVES = ("k", "v", "ckv", "kpe")


def kv_bytes(cfg: ModelConfig, seq_len: int, dtype_bytes: int = 2) -> int:
    """Per-request KVCache + state bytes at context ``seq_len`` (S_kv)."""
    return cfg.kv_cache_bytes(seq_len, dtype_bytes)


def cache_num_bytes(caches) -> int:
    """Actual byte size of a cache (or wire) pytree."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(caches)))


def quantize_cache_for_wire(caches):
    """int8-quantize the K/V/latent leaves (per-tensor symmetric).  The
    encode runs through ``ops.quantize_wire``: the CUDA kernel for a CUDA
    cache, the byte-identical plain version for a CPU one.  Returns (wire
    pytree, wire bytes)."""
    def enc(name, leaf):
        if name in WIRE_LEAVES and leaf.dtype in (torch.bfloat16,
                                                  torch.float32):
            q, scale = ops.quantize_wire(leaf.float())
            return {"q": q, "scale": scale.to(leaf.dtype)}
        return leaf

    wire = tree_map_named(enc, caches)
    return wire, cache_num_bytes(wire)


def dequantize_int8(q, scale):
    return q.float() * scale


def dequantize_cache_from_wire(wire):
    def walk(node):
        if isinstance(node, dict) and set(node) == {"q", "scale"}:
            scale = node["scale"]
            return dequantize_int8(node["q"], scale.float()).to(scale.dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(wire)


def wire_compression_ratio(caches) -> float:
    """Measured raw / quantized byte ratio of a real cache pytree."""
    raw = cache_num_bytes(caches)
    _, wire = quantize_cache_for_wire(caches)
    return raw / max(wire, 1)
