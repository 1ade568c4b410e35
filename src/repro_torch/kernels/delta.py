"""Chunked gated delta rule: the plain PyTorch version and the CUDA
kernel's wrapper.

The kernel (``csrc/delta.cu``) has two instances:
:func:`delta_chunked_fused` replaces the TPU kernel
``src/repro/kernels/delta.py::delta_chunked_fused`` (rows past ``lengths``
masked: serving prefill) and :func:`delta_chunked` replaces
``delta_chunked`` there (no mask: training and unpadded evaluation).  Their
plain versions are :func:`mask_padded` followed by
:func:`delta_chunked_ref`, and :func:`delta_chunked_ref` alone, which follow
``src/repro/kernels/ops.py::_mask_padded`` and
``src/repro/models/chunked_attention.py::delta_chunked_jnp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build

# chunk length of both paths; csrc/delta.cu compiles it in (its C)
CHUNK = 64


def mask_padded(lengths, S: int, log_a, k, beta=None):
    """Neutralize rows at or past each row's valid length (decay -> 1,
    key and beta -> 0), exactly as the fused kernels do in-kernel.
    Returns (log_a, k), and beta after them when given."""
    mask = torch.arange(S, device=k.device)[None, :] < lengths.to(k.device)[:, None]
    log_a = torch.where(mask[:, None, :], log_a, 0.0)
    k = torch.where(mask[:, None, :, None], k, torch.zeros((), dtype=k.dtype))
    if beta is None:
        return log_a, k
    return log_a, k, torch.where(mask[:, None, :], beta, 0.0)


def delta_chunked_ref(q, k, v, log_a, beta, initial_state):
    """WY-form chunked delta rule, float32 state.  q, k: (B, H, S, dk);
    v: (B, H, S, dv); log_a, beta: (B, H, S); initial_state (B, H, dk, dv).
    Returns (o (B, H, S, dv) in q's dtype, final state float32).  Chunks
    are ``CHUNK`` rows (fewer when S is shorter); the per-chunk
    unit-lower-triangular inverse is the reference's Neumann product."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    dtype = q.dtype
    chunk = min(CHUNK, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_a, beta = (F.pad(x, (0, pad)) for x in (log_a, beta))
    nc = (S + pad) // chunk

    def split(x):
        return x.reshape(B, H, nc, chunk, -1).float()

    qc, kc, vc = split(q), split(k), split(v)
    lac = log_a.reshape(B, H, nc, chunk).float()
    bc = beta.reshape(B, H, nc, chunk).float()
    idx = torch.arange(chunk, device=q.device)
    strict = idx[None, :] < idx[:, None]
    incl = idx[None, :] <= idx[:, None]
    eye = torch.eye(chunk, dtype=torch.float32, device=q.device)
    steps = max(1, (chunk - 1).bit_length())
    state = initial_state.float()
    outs = []
    for c in range(nc):
        qb, kb, vb = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        la, bb = lac[:, :, c], bc[:, :, c]
        csum = torch.cumsum(la, dim=-1)
        gamma = torch.exp(csum)[..., None]
        diff = csum[..., :, None] - csum[..., None, :]
        dstrict = torch.where(strict, torch.exp(torch.where(strict, diff, 0.0)), 0.0)
        dincl = torch.where(incl, torch.exp(torch.where(incl, diff, 0.0)), 0.0)
        kkt = kb @ kb.transpose(-1, -2)
        m = -(bb[..., :, None] * (kkt * dstrict))
        r = eye + m
        for _ in range(steps - 1):
            m = m @ m
            r = r + r @ m
        rhs = bb[..., None] * (vb - (kb * gamma) @ state)
        u = r @ rhs
        qkt = qb @ kb.transpose(-1, -2)
        outs.append((qb * gamma) @ state + (qkt * dincl) @ u)
        g_c = torch.exp(csum[..., -1:])[..., None]
        kscale = torch.exp(csum[..., -1:] - csum)[..., None]
        state = g_c * state + (kb * kscale).transpose(-1, -2) @ u
    o = torch.stack(outs, dim=2).reshape(B, H, S + pad, dv)[:, :, :S]
    return o.to(dtype), state


def _launch(name, q, k, v, log_a, beta, lengths, initial_state):
    """Validate, allocate and launch the masked (``lengths`` given) or the
    unmasked instance of ``csrc/delta.cu``."""
    extra = () if lengths is None else (lengths,)
    _build.require_cuda(name, q, k, v, log_a, beta, initial_state, *extra)
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if (tuple(k.shape) != (B, H, S, dk) or tuple(v.shape[:3]) != (B, H, S)
            or tuple(log_a.shape) != (B, H, S)
            or tuple(beta.shape) != (B, H, S)
            or tuple(initial_state.shape) != (B, H, dk, dv)
            or (lengths is not None and tuple(lengths.shape) != (B,))):
        raise ValueError(f"{name}: inconsistent shapes")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    for t in (log_a, beta, initial_state):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: log_a, beta and state must be float32")
    if lengths is not None and lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    if dk > 256:
        raise ValueError(f"{name}: key dim {dk} exceeds 256")
    o = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if state.numel() == 0:
        return o, state
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            beta.data_ptr())
    tail = (initial_state.data_ptr(), o.data_ptr(), state.data_ptr(), B, H,
            S, dk, dv, _build.dtype_code(q), _build.stream_ptr(q))
    if lengths is None:
        err = lib.prfaas_delta_chunked(*ptrs, *tail)
    else:
        err = lib.prfaas_delta_fused(*ptrs, lengths.data_ptr(), *tail)
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return o, state


def delta_chunked_fused(q, k, v, log_a, beta, lengths, initial_state):
    """The CUDA kernel, masked instance: the chunked delta rule in one
    launch.  q, k, v contiguous CUDA tensors of one dtype (float32 or
    bfloat16); log_a, beta, initial_state float32; lengths int32.  Output
    rows at positions >= lengths[b] are computed from the neutralized rows,
    as the TPU kernel computes them."""
    return _launch("delta_chunked_fused", q, k, v, log_a, beta, lengths,
                   initial_state)


def delta_chunked(q, k, v, log_a, beta, initial_state):
    """The CUDA kernel, unmasked instance (the TPU kernel
    ``src/repro/kernels/delta.py::delta_chunked``): every row valid, as in
    training.  Same tensors as :func:`delta_chunked_fused` without
    ``lengths``; its plain version is :func:`delta_chunked_ref`."""
    return _launch("delta_chunked", q, k, v, log_a, beta, None,
                   initial_state)


def delta_step_ref(q, k, v, log_a, beta, state):
    """One gated-delta decode step (plain PyTorch; the reference has no
    kernel for it).  q, k: (B, H, dk); v: (B, H, dv); log_a, beta: (B, H);
    state (B, H, dk, dv) float32.  Returns (o in q's dtype, new state)."""
    kf, vf = k.float(), v.float()
    a = torch.exp(log_a.float())[..., None, None]
    b = beta.float()[..., None, None]
    kS = torch.einsum("bhk,bhkv->bhv", kf, state)
    state = a * (state - b * torch.einsum("bhk,bhv->bhkv", kf, kS))
    state = state + b * torch.einsum("bhk,bhv->bhkv", kf, vf)
    o = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return o.to(q.dtype), state
