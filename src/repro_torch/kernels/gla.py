"""Chunked gated linear attention (scalar per-head decay): the plain
PyTorch version and the CUDA kernel's wrapper.

    S_t = exp(log_a_t) S_{t-1} + k_t v_t^T ,   o_t = q_t S_t

It serves Mamba2 (SSD), and later GLA and mLSTM.  The kernel
(``csrc/gla.cu``) has two instances: :func:`gla_chunked_fused` replaces the
TPU kernel ``src/repro/kernels/gla.py::gla_chunked_fused`` (rows past
``lengths`` masked: serving prefill) and :func:`gla_chunked` replaces
``gla_chunked`` there (no mask: training and unpadded evaluation).  Their
plain versions are :func:`mask_padded` followed by :func:`gla_chunked_ref`,
and :func:`gla_chunked_ref` alone, which follow
``src/repro/kernels/ops.py::_mask_padded`` and
``src/repro/models/chunked_attention.py::gla_chunked_jnp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels.delta import mask_padded

__all__ = ["CHUNK", "mask_padded", "gla_chunked_ref", "gla_chunked_fused",
           "gla_chunked", "gla_step_ref"]

# chunk length of both paths; csrc/gla.cu compiles it in (its C)
CHUNK = 64


def gla_chunked_ref(q, k, v, log_a, initial_state):
    """Chunked scan, float32 state.  q, k: (B, H, S, dk); v: (B, H, S, dv);
    log_a: (B, H, S) (<= 0); initial_state (B, H, dk, dv).  Returns (o
    (B, H, S, dv) in q's dtype, final state float32).  Chunks are
    ``CHUNK`` rows (fewer when S is shorter); every decay factor is the
    exp of a difference of cumulative log decays, so none exceeds 1."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    dtype = q.dtype
    chunk = min(CHUNK, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, pad))
    nc = (S + pad) // chunk

    def split(x):
        return x.reshape(B, H, nc, chunk, -1).float()

    qc, kc, vc = split(q), split(k), split(v)
    lac = log_a.reshape(B, H, nc, chunk).float()
    idx = torch.arange(chunk, device=q.device)
    incl = idx[None, :] <= idx[:, None]
    state = initial_state.float()
    outs = []
    for c in range(nc):
        qb, kb, vb = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        csum = torch.cumsum(lac[:, :, c], dim=-1)
        gamma = torch.exp(csum)[..., None]
        diff = csum[..., :, None] - csum[..., None, :]
        decay = torch.where(incl, torch.exp(torch.where(incl, diff, 0.0)), 0.0)
        a = (qb @ kb.transpose(-1, -2)) * decay
        outs.append(a @ vb + (qb * gamma) @ state)
        g_c = torch.exp(csum[..., -1:])[..., None]
        kscale = torch.exp(csum[..., -1:] - csum)[..., None]
        state = g_c * state + (kb * kscale).transpose(-1, -2) @ vb
    o = torch.stack(outs, dim=2).reshape(B, H, S + pad, dv)[:, :, :S]
    return o.to(dtype), state


def _launch(name, q, k, v, log_a, lengths, initial_state):
    """Validate, allocate and launch the masked (``lengths`` given) or the
    unmasked instance of ``csrc/gla.cu``."""
    extra = () if lengths is None else (lengths,)
    _build.require_cuda(name, q, k, v, log_a, initial_state, *extra)
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if (tuple(k.shape) != (B, H, S, dk) or tuple(v.shape[:3]) != (B, H, S)
            or tuple(log_a.shape) != (B, H, S)
            or tuple(initial_state.shape) != (B, H, dk, dv)
            or (lengths is not None and tuple(lengths.shape) != (B,))):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    for t in (log_a, initial_state):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: log_a and state must be float32")
    if lengths is not None and lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    if dk > 256:
        raise ValueError(f"{name}: key dim {dk} exceeds 256")
    o = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if state.numel() == 0:
        return o, state
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr())
    tail = (initial_state.data_ptr(), o.data_ptr(), state.data_ptr(), B, H,
            S, dk, dv, _build.dtype_code(q), _build.stream_ptr(q))
    if lengths is None:
        err = lib.prfaas_gla_chunked(*ptrs, *tail)
    else:
        err = lib.prfaas_gla_fused(*ptrs, lengths.data_ptr(), *tail)
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return o, state


def gla_chunked_fused(q, k, v, log_a, lengths, initial_state):
    """The CUDA kernel, masked instance: the chunked scan in one launch.
    q, k, v contiguous CUDA tensors of one dtype (float32 or bfloat16);
    log_a and initial_state float32; lengths int32.  Rows at or past
    lengths[b] are neutralized by selection (k, v -> 0, log_a -> 0), so the
    final state is the state after each row's real tokens; output rows
    there are unspecified, as in the TPU kernel."""
    return _launch("gla_chunked_fused", q, k, v, log_a, lengths,
                   initial_state)


def gla_chunked(q, k, v, log_a, initial_state):
    """The CUDA kernel, unmasked instance (the TPU kernel
    ``src/repro/kernels/gla.py::gla_chunked``): every row valid, as in
    training.  Same tensors as :func:`gla_chunked_fused` without
    ``lengths``; its plain version is :func:`gla_chunked_ref`."""
    return _launch("gla_chunked", q, k, v, log_a, None, initial_state)


def gla_step_ref(q, k, v, log_a, state):
    """One decode step (plain PyTorch; the reference has no kernel for it).
    q, k: (B, H, dk); v: (B, H, dv); log_a: (B, H); state (B, H, dk, dv)
    float32.  Returns (o in q's dtype, new state)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = a * state + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    o = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return o.to(q.dtype), state
