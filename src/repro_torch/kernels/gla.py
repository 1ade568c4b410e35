"""Chunked gated linear attention (scalar per-head decay): the plain
PyTorch version, a plain mirror of the CUDA kernel's three phases, and the
kernel's wrapper.

    S_t = exp(log_a_t) S_{t-1} + k_t v_t^T ,   o_t = q_t S_t

It serves Mamba2 (SSD), GLA (Lightning) and mLSTM.  The kernel
(``csrc/gla.cu``; bf16 over the core ``csrc/gla_hopper.cuh``) has two
instances: :func:`gla_chunked_fused` replaces the TPU kernel
``src/repro/kernels/gla.py::gla_chunked_fused`` (rows past ``lengths``
masked: serving prefill) and :func:`gla_chunked` replaces ``gla_chunked``
there (no mask: training and unpadded evaluation).  Their plain versions
are :func:`mask_padded` followed by :func:`gla_chunked_ref`, and
:func:`gla_chunked_ref` alone, which follow
``src/repro/kernels/ops.py::_mask_padded`` and
``src/repro/models/chunked_attention.py::gla_chunked_jnp``.

The bf16 core runs the scan in three phases, mirrored here on the CPU:
:func:`chunk_factors` (every chunk at once: its state increment and
decay), :func:`state_pass` (the chunks in order, elementwise: the state
entering each chunk) and :func:`chunk_outputs` (every chunk at once: the
outputs against the state entering it).  With ``emulate=True`` the
products round where the kernel's bf16 tensor-core products do
(:func:`~repro_torch.kernels.delta.split_matmul`, ``PARTS``), so the CPU
tests can hold that precision before any card runs it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels.delta import _matmul, mask_padded, split_matmul

__all__ = ["CHUNK", "PARTS", "MAX_DK", "mask_padded", "gla_chunked_ref",
           "chunk_factors", "state_pass", "chunk_outputs", "kernel_parts",
           "gla_chunked_fused", "gla_chunked", "gla_step_ref"]

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


# bf16 parts of each float32 operand of the bf16 core's tensor-core
# products (csrc/gla_hopper.cuh: PK, PA, PS; :func:`kernel_parts` reads
# them from the built library): k . kscale in the state increment, A = Q
# K^T . D in the intra-chunk output, and the state entering a chunk in
# q S.  q, k and v are bf16 and are taken whole.
PARTS = {"K": 3, "A": 3, "S": 3}


def kernel_parts() -> dict:
    """The built kernel's own part counts, keyed as :data:`PARTS` (builds
    the library: card only)."""
    out = (ctypes.c_int * 3)()
    _build.library().prfaas_gla_parts(out)
    return dict(zip(("K", "A", "S"), out))


class ChunkFactors(NamedTuple):
    """Phase 1's output and what phase 3 reads, per chunk of ``CHUNK``
    rows (leading dims B, H, chunk): the chunk's neutralized rows ``q``,
    ``k`` (C, dk) and ``v`` (C, dv); ``cs`` the inclusive cumulative log
    decay (C,); ``dS`` = (K . kscale)^T V (dk, dv) with kscale = exp(cs_C -
    cs); ``g`` = exp(cs_C); ``S``: the rows before chunk padding."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    cs: torch.Tensor
    dS: torch.Tensor
    g: torch.Tensor
    S: int


def chunk_factors(q, k, v, log_a, lengths=None, *, emulate=False):
    """Phase 1 of the bf16 core, plain: for every chunk at once, its state
    increment and decay.  Same inputs as :func:`gla_chunked_fused` (any
    device; ``lengths`` None for the unmasked instance).  Rows at or past a
    length are neutralized as the kernel does it, by selection (k, v, log_a
    -> 0; q kept), rows past S are zero, and chunks are always ``CHUNK``
    rows.  With ``emulate`` the increment is :func:`split_matmul`'s with k
    . kscale in ``PARTS["K"]`` bf16 parts and v whole, as on the tensor
    cores (so q, k, v are taken as bf16 values, as the core takes them)."""
    B, H, S, _ = q.shape
    pad = (-S) % CHUNK
    nc = (S + pad) // CHUNK
    dev = q.device
    pos = torch.arange(S + pad, device=dev)
    lens = (torch.full((B,), S, device=dev) if lengths is None
            else lengths.to(dev).clamp(max=S))
    valid = (pos[None, :] < lens[:, None])[:, None]            # (B, 1, Sp)

    def rows(x, keep):
        x = F.pad(x.float(), (0, 0, 0, pad))
        return torch.where(keep[..., None], x, 0.0).reshape(
            B, H, nc, CHUNK, -1)

    qc = rows(q, (pos < S)[None, None])
    kc, vc = rows(k, valid), rows(v, valid)
    la = torch.where(valid, F.pad(log_a.float(), (0, pad)), 0.0).reshape(
        B, H, nc, CHUNK)
    cs = torch.cumsum(la, dim=-1)
    ks = kc * torch.exp(cs[..., -1:] - cs)[..., None]
    mm = split_matmul if emulate else _matmul
    dS = mm(ks.transpose(-1, -2), vc, PARTS["K"], 1)
    return ChunkFactors(qc, kc, vc, cs, dS, torch.exp(cs[..., -1]), S)


def state_pass(f: ChunkFactors, initial_state):
    """Phase 2 of the bf16 core, plain: the chunks in order, S <- g S +
    dS, elementwise over the state's cells.  Returns (the state entering
    each chunk (B, H, chunk, dk, dv), the final state), float32."""
    state = initial_state.float()
    entering = []
    for c in range(f.dS.shape[2]):
        entering.append(state)
        state = f.g[:, :, c, None, None] * state + f.dS[:, :, c]
    return torch.stack(entering, dim=2), state


def chunk_outputs(f: ChunkFactors, entering, *, emulate=False):
    """Phase 3 of the bf16 core, plain: for every chunk at once, o = (Q
    K^T . D) V + gamma . (Q S) against the state S entering it, D[i, j] =
    exp(cs_i - cs_j) for j <= i, else 0, and gamma = exp(cs).  With
    ``emulate`` A = Q K^T . D takes ``PARTS["A"]`` bf16 parts and S
    ``PARTS["S"]``, as on the tensor cores.  Returns o (B, H, S, dv)
    float32."""
    mm = split_matmul if emulate else _matmul
    idx = torch.arange(CHUNK, device=f.q.device)
    incl = idx[None, :] <= idx[:, None]
    diff = f.cs[..., :, None] - f.cs[..., None, :]
    decay = torch.where(incl, torch.exp(torch.where(incl, diff, 0.0)), 0.0)
    a = (f.q @ f.k.transpose(-1, -2)) * decay
    o = (torch.exp(f.cs)[..., None] * mm(f.q, entering, 1, PARTS["S"])
         + mm(a, f.v, PARTS["A"], 1))
    B, H = o.shape[:2]
    return o.reshape(B, H, -1, o.shape[-1])[:, :, :f.S]


# the bf16 core's key dim is padded to a multiple of 64, at most MAX_DK
MAX_DK = 256


def _launch(name, q, k, v, log_a, lengths, initial_state):
    """Validate, allocate the output, state and workspace, and launch the
    masked (``lengths`` given) or the unmasked instance of ``csrc/gla.cu``
    (all phases, one count)."""
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
    if dk > MAX_DK:
        raise ValueError(f"{name}: key dim {dk} exceeds {MAX_DK}")
    o = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if state.numel() == 0:
        return o, state
    lib = _build.library()
    code = _build.dtype_code(q)
    nbytes = lib.prfaas_gla_workspace_bytes(B, H, S, dk, dv, code)
    ws = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr())
    tail = (initial_state.data_ptr(), o.data_ptr(), state.data_ptr(),
            ws.data_ptr(), nbytes, B, H, S, dk, dv, code,
            _build.stream_ptr(q))
    if lengths is None:
        err = lib.prfaas_gla_chunked(*ptrs, *tail)
    else:
        err = lib.prfaas_gla_fused(*ptrs, lengths.data_ptr(), *tail)
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return o, state


def gla_chunked_fused(q, k, v, log_a, lengths, initial_state):
    """The CUDA kernel, masked instance: the chunked scan (bf16: the three
    phases of ``csrc/gla_hopper.cuh``; float32: one SIMT kernel).
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
