"""Kernel dispatch: each op runs its hand-written CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors.

The path follows the device of the tensors given, never a global switch:
a CUDA tensor always reaches the kernel, which raises if it cannot build or
launch (there is no fallback).  ``use_kernel=False`` on the model's ops
selects the plain version on any device; only tests and ``chip_smoke.py``'s
comparison phase pass it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import delta as _delta
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import gla as _gla
from repro_torch.kernels import paged_decode_attn as _pdecode
from repro_torch.kernels import paged_prefill_attn as _pprefill
from repro_torch.kernels import quantize as _quant


def _plain(use_kernel: bool, x) -> bool:
    return not use_kernel or x.device.type == "cpu"


def attention(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
              use_kernel=True):
    """Full attention (GQA/MQA/MHA/SWA). q: (B,Hq,Sq,Dk); k, v:
    (B,Hkv,Sk,Dk/Dv).  ``q_offset`` is always explicit: the position of q
    row 0 minus that of k row 0 (the chunked-prefill suffix passes the
    prior length)."""
    if _plain(use_kernel, q):
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, scale=scale,
                                          q_offset=q_offset)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, scale=scale,
                                  q_offset=q_offset)


def delta(q, k, v, log_a, beta, initial_state=None, *, lengths=None,
          use_kernel=True):
    """Gated delta rule over right-padded rows, in chunks of
    ``delta.CHUNK`` on both paths.  Returns (o, final_state).

    ``lengths`` (B,): valid rows per batch row (all S when None).  Rows at
    or past it are neutralized (decay -> 1, k/beta -> 0): in-kernel on
    CUDA, by :func:`delta.mask_padded` before the plain chunked form."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if initial_state is None:
        initial_state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                                    device=q.device)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    if _plain(use_kernel, q):
        log_a, k, beta = _delta.mask_padded(lengths, S, log_a, k, beta)
        return _delta.delta_chunked_ref(q, k, v, log_a, beta, initial_state)
    return _delta.delta_chunked_fused(
        q.contiguous(), k.contiguous(), v.contiguous(),
        log_a.float().contiguous(), beta.float().contiguous(),
        lengths.to(device=q.device, dtype=torch.int32).contiguous(),
        initial_state.float().contiguous())


def gla(q, k, v, log_a, initial_state=None, *, lengths=None,
        use_kernel=True):
    """Gated linear attention (scalar per-head decay) over right-padded
    rows, in chunks of ``gla.CHUNK`` on both paths.  Returns (o,
    final_state).

    ``lengths`` (B,): valid rows per batch row (all S when None).  Rows at
    or past it are neutralized (decay -> 1, k -> 0): in-kernel on CUDA, by
    :func:`gla.mask_padded` before the plain chunked form."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if initial_state is None:
        initial_state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                                    device=q.device)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    if _plain(use_kernel, q):
        log_a, k = _gla.mask_padded(lengths, S, log_a, k)
        return _gla.gla_chunked_ref(q, k, v, log_a, initial_state)
    return _gla.gla_chunked_fused(
        q.contiguous(), k.contiguous(), v.contiguous(),
        log_a.float().contiguous(),
        lengths.to(device=q.device, dtype=torch.int32).contiguous(),
        initial_state.float().contiguous())


def decode_attention(q, k_cache, v_cache, lengths, *, window=0, scale=None,
                     use_kernel=True):
    """One-query attention over a dense cache. q: (B,Hq,Dk); caches
    (B,Hkv,S,Dk/Dv); lengths (B,) keys per row (context + 1)."""
    if _plain(use_kernel, q):
        return _decode.decode_attention_ref(q, k_cache, v_cache, lengths,
                                            window=window, scale=scale)
    return _decode.decode_attention(
        q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
        lengths.to(device=q.device, dtype=torch.int32).contiguous(),
        window=window, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           window=0, scale=None, use_kernel=True):
    """One-query attention over a shared page pool. q: (B,Hq,Dk); pools
    (Hkv,P,T,Dk/Dv); tables (B,N) physical page ids; lengths (B,) keys per
    row (context + 1)."""
    if _plain(use_kernel, q):
        return _pdecode.paged_decode_attention_ref(
            q, k_pages, v_pages, tables, lengths, window=window, scale=scale)
    return _pdecode.paged_decode_attention(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        tables.to(device=q.device, dtype=torch.int32).contiguous(),
        lengths.to(device=q.device, dtype=torch.int32).contiguous(),
        window=window, scale=scale)


def paged_prefill_attention(q, k_pages, v_pages, tables, k_suf, v_suf, *,
                            scale=None, use_kernel=True):
    """A suffix chunk's queries (B,Hq,C,Dk) over the N prior pool pages of
    ``tables`` (B,N), all visible, then the dense suffix keys (B,Hkv,Ssuf,
    Dk/Dv), causally (query row i at suffix position Ssuf - C + i)."""
    if _plain(use_kernel, q):
        return _pprefill.paged_prefill_attention_ref(
            q, k_pages, v_pages, tables, k_suf, v_suf, scale=scale)
    return _pprefill.paged_prefill_attention(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        tables.to(device=q.device, dtype=torch.int32).contiguous(),
        k_suf.contiguous(), v_suf.contiguous(), scale=scale)


def quantize_wire(x):
    """Per-tensor symmetric int8 of a float32 leaf -> (q int8, scale
    float32 0-d), byte-identical on both paths."""
    if x.device.type == "cpu":
        return _quant.quantize_int8_ref(x)
    return _quant.quantize_int8_fused(x.contiguous())


# single-step recurrent updates: plain PyTorch on every device, as in the
# reference (which has no kernel for them)
delta_step = _delta.delta_step_ref
gla_step = _gla.gla_step_ref
