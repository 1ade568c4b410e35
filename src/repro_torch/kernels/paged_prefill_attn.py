"""Paged prefill attention: the plain PyTorch version and the CUDA
kernel's wrapper.

The kernel (``csrc/paged_prefill_attn.cu``) replaces the TPU kernel
``src/repro/kernels/paged_prefill_attn.py::paged_prefill_attention``; the
plain version follows ``src/repro/kernels/ref.py::
paged_prefill_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attn import (flash_attention_ref,
                                            require_bf16_core)
from repro_torch.kernels.paged_decode_attn import gather_pages


def paged_prefill_attention_ref(q, k_pages, v_pages, tables, k_suf, v_suf, *,
                                scale: float | None = None):
    """q: (B, Hq, C, Dk), the suffix chunk's queries; pools: (Hkv, P, T,
    Dk) / (Hkv, P, T, Dv); tables: (B, N) int; k_suf / v_suf: (B, Hkv,
    Ssuf, Dk / Dv), every suffix key so far (the last C rows are the
    chunk's own).  Returns (B, Hq, C, Dv).

    Gathers the N prior pages through the table, appends the suffix and
    runs the dense flash attention with q row 0 at key position
    N * T + Ssuf - C: every prior key is visible, the suffix is causal."""
    kg, vg = gather_pages(k_pages, tables), gather_pages(v_pages, tables)
    k_full = torch.cat([kg, k_suf.to(kg.dtype)], dim=2)
    v_full = torch.cat([vg, v_suf.to(vg.dtype)], dim=2)
    prior, C, Ssuf = kg.shape[2], q.shape[2], k_suf.shape[2]
    return flash_attention_ref(q, k_full, v_full, causal=True, scale=scale,
                               q_offset=prior + Ssuf - C)


def require_bf16_pages(name: str, T: int):
    """Raise ValueError unless a page of ``T`` tokens fits the bf16 core:
    a multiple of 8 that divides its 64-key tile (8, 16, 32 or 64)."""
    if T % 8 or 64 % T:
        raise ValueError(f"{name}: a bfloat16 page of {T} tokens must be a "
                         "multiple of 8 that divides 64")


def paged_prefill_attention(q, k_pages, v_pages, tables, k_suf, v_suf, *,
                            scale: float | None = None):
    """The CUDA kernel: same contract as :func:`paged_prefill_attention_ref`,
    on contiguous CUDA tensors of one dtype (int32 tables).  bfloat16 takes
    the tensor-core core (:func:`require_bf16_core`,
    :func:`require_bf16_pages`)."""
    name = "paged_prefill_attention"
    _build.require_cuda(name, q, k_pages, v_pages, tables, k_suf, v_suf)
    B, Hq, C, Dk = q.shape
    Hkv, P, T, Dk2 = k_pages.shape
    Dv = v_pages.shape[-1]
    N = tables.shape[1] if tables.dim() == 2 else 0
    Ssuf = k_suf.shape[2]
    if (Dk2 != Dk or v_pages.shape[:3] != k_pages.shape[:3] or Hq % Hkv
            or tuple(tables.shape) != (B, N) or N < 1
            or tuple(k_suf.shape) != (B, Hkv, Ssuf, Dk)
            or tuple(v_suf.shape) != (B, Hkv, Ssuf, Dv) or Ssuf < C):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"tables {tuple(tables.shape)} suffix "
                         f"{tuple(k_suf.shape)} / {tuple(v_suf.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype == k_suf.dtype
            == v_suf.dtype):
        raise TypeError(f"{name}: q, pool and suffix dtypes differ")
    if tables.dtype != torch.int32:
        raise TypeError(f"{name}: tables must be int32")
    if Dk > 256 or Dv > 256:
        raise ValueError(f"{name}: head dims Dk {Dk}, Dv {Dv} exceed 256")
    if q.dtype == torch.bfloat16:
        require_bf16_core(name, (Dk, Dv), q, k_pages, v_pages, k_suf, v_suf)
        require_bf16_pages(name, T)
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    out = torch.empty((B, Hq, C, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.prfaas_paged_prefill_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, C, P, T, N, Ssuf, Dk, Dv, float(scale),
        _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return out
