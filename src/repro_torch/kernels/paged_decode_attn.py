"""Paged flash-decode: the plain PyTorch version and the CUDA kernel's
wrapper.

The kernel (``csrc/paged_decode_attn.cu``) replaces the TPU kernel
``src/repro/kernels/paged_decode_attn.py::paged_decode_attention``; the
plain version follows ``src/repro/kernels/ref.py::
paged_decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.decode_attn import (decode_attention_ref,
                                             require_bf16_decode, sm_count,
                                             split_plan)


def gather_pages(pages, tables):
    """Pool (Hkv, P, T, D) through tables (B, N) -> the dense (B, Hkv,
    N * T, D) cache of each row's logical pages."""
    Hkv, _, T, D = pages.shape
    B, N = tables.shape
    return pages[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(
        B, Hkv, N * T, D)


def paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths, *,
                               window: int = 0, scale: float | None = None):
    """q: (B, Hq, Dk); pools: (Hkv, P, T, Dk) / (Hkv, P, T, Dv); tables:
    (B, N) int physical page ids (logical page j of row b is
    ``tables[b, j]``); lengths: (B,) int.  Returns (B, Hq, Dv).

    Gathers each row's pages through its table and runs the dense decode
    over them.  Keys at or past ``lengths[b]`` may lie on sink or garbage
    pages: their values are zeroed by selection before the product, so
    garbage (NaN included) never reaches the output, and on finite pools
    the result equals the dense decode over the gathered cache."""
    kg, vg = gather_pages(k_pages, tables), gather_pages(v_pages, tables)
    lengths = lengths.to(q.device)
    live = torch.arange(kg.shape[2], device=q.device)[None, :] \
        < lengths[:, None]
    vg = torch.where(live[:, None, :, None], vg, torch.zeros_like(vg))
    return decode_attention_ref(q, kg, vg, lengths, window=window,
                                scale=scale)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           window: int = 0, scale: float | None = None):
    """The CUDA kernel: same contract as :func:`paged_decode_attention_ref`,
    on contiguous CUDA tensors (q and pools of one dtype, int32 tables and
    lengths).  bfloat16 takes the Hopper core (:func:`require_bf16_decode`,
    any page size)."""
    name = "paged_decode_attention"
    _build.require_cuda(name, q, k_pages, v_pages, tables, lengths)
    B, Hq, Dk = q.shape
    Hkv, P, T, Dk2 = k_pages.shape
    Dv = v_pages.shape[-1]
    N = tables.shape[1] if tables.dim() == 2 else 0
    if (Dk2 != Dk or v_pages.shape[:3] != k_pages.shape[:3] or Hq % Hkv
            or tuple(tables.shape) != (B, N) or N < 1
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"tables {tuple(tables.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not (k_pages.dtype == v_pages.dtype == q.dtype):
        raise TypeError(f"{name}: q and pool dtypes differ")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: tables and lengths must be int32")
    if Dk > 1024 or Dv > 512:
        raise ValueError(f"{name}: head dims Dk {Dk}, Dv {Dv} too large")
    if q.dtype == torch.bfloat16:
        require_bf16_decode(name, Dk, Dv, q, k_pages, v_pages)
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = split_plan(B, Hq, Hkv, Dk, Dv, N * T, q.dtype, sm_count(q.device),
                      int(window))
    part_acc, part_ml = plan.scratch(B, Hq, Dv, q.device)
    lib = _build.library()
    err = lib.prfaas_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), B, Hq, Hkv, P, T, N, Dk, Dv,
        plan.heads, int(window), float(scale), plan.workers, plan.tile,
        plan.runs, plan.rmin, _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return out
