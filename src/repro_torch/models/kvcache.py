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
from repro_torch.kernels.quantize import request_leaf, whole_leaf
from repro_torch.models.tree import tree_leaves, tree_map_named

WIRE_LEAVES = ("k", "v", "ckv", "kpe")


def kv_bytes(cfg: ModelConfig, seq_len: int, dtype_bytes: int = 2) -> int:
    """Per-request KVCache + state bytes at context ``seq_len`` (S_kv)."""
    return cfg.kv_cache_bytes(seq_len, dtype_bytes)


def cache_num_bytes(caches) -> int:
    """Actual byte size of a cache (or wire) pytree."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(caches)))


def _encode(jobs):
    """Fill each job's empty wire slot with ``{"q", "scale"}``, the scale
    in the leaf's dtype: ``ops.quantize_wire_leaves`` on all of the jobs'
    leaves at once (on CUDA one launch pair, the kernel reading each leaf
    where it lies; on the CPU the byte-identical plain version)."""
    coded = ops.quantize_wire_leaves([leaf for _, leaf in jobs])
    for (slot, _), (q, _, scale) in zip(jobs, coded):
        slot.update(q=q, scale=scale)


def _is_wire(name, leaf) -> bool:
    return name in WIRE_LEAVES and leaf.dtype in (torch.bfloat16,
                                                  torch.float32)


def quantize_cache_for_wire(caches):
    """int8-quantize the K/V/latent leaves (per-tensor symmetric).
    Returns (wire pytree, wire bytes)."""
    jobs = []

    def enc(name, leaf):
        if _is_wire(name, leaf):
            slot = {}
            jobs.append((slot, whole_leaf(leaf.contiguous())))
            return slot
        return leaf

    wire = tree_map_named(enc, caches)
    _encode(jobs)
    return wire, cache_num_bytes(wire)


def encode_request_for_wire(caches, idx: int, length: int):
    """Request ``idx`` of a bucket-padded batched prefill cache, encoded
    for the wire: the tree and bytes of
    ``quantize_cache_for_wire(trim_request_cache(caches, idx, length))``
    without the trimmed copy.  The K/V/latent leaves are read in place,
    rows ``[0, length - off)`` of request ``idx`` (``off`` from a block's
    ``off`` marker, else 0), all of them in one encode; the other leaves
    are trimmed as ``trim_request_cache`` trims them.  Returns (wire
    pytree, wire bytes, bytes of the trimmed cache)."""
    jobs, raw, nbytes = [], 0, 0

    def walk(node):
        nonlocal raw, nbytes
        if isinstance(node, list):
            return [walk(v) for v in node]
        off = int(node["off"].reshape(-1)[0]) if "off" in node else 0
        out = {}
        for name, v in node.items():
            if not isinstance(v, torch.Tensor):
                out[name] = walk(v)
                continue
            seq = name in WIRE_LEAVES
            rows = min(max(length - off, 0), v.shape[2]) if seq else 0
            if _is_wire(name, v):
                leaf = request_leaf(v, idx, rows)
                n = leaf.segments * leaf.length
                raw += n * v.element_size()
                nbytes += n + v.element_size()        # the codes, the scale
                out[name] = {}
                jobs.append((out[name], leaf))
                continue
            t = v[:, idx:idx + 1]
            out[name] = (t[:, :, :rows] if seq else t).contiguous()
            n = out[name].numel() * out[name].element_size()
            raw, nbytes = raw + n, nbytes + n
        return out

    wire = walk(caches)
    _encode(jobs)
    return wire, nbytes, raw


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
