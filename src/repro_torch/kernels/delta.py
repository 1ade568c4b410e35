"""Chunked gated delta rule: the plain PyTorch version, a plain mirror of
the CUDA kernel's two phases, and the kernel's wrapper.

The kernel (``csrc/delta.cu`` over the core ``csrc/delta_hopper.cuh``)
has two instances: :func:`delta_chunked_fused` replaces the TPU kernel
``src/repro/kernels/delta.py::delta_chunked_fused`` (rows past ``lengths``
masked: serving prefill) and :func:`delta_chunked` replaces
``delta_chunked`` there (no mask: training and unpadded evaluation).  Their
plain versions are :func:`mask_padded` followed by
:func:`delta_chunked_ref`, and :func:`delta_chunked_ref` alone, which follow
``src/repro/kernels/ops.py::_mask_padded`` and
``src/repro/models/chunked_attention.py::delta_chunked_jnp``.

The kernel runs the WY form in two phases, mirrored here on the CPU:
:func:`wy_factors` (phase 1, every chunk at once: what depends only on
the chunk's own rows) and :func:`state_pass` (phase 2, the chunks in
order: what depends on the state).  With ``emulate=True`` both round where
the kernel does (:func:`split_bf16`, :func:`split_matmul`), so the CPU
tests can hold the tensor-core precision against the tolerances before
any card runs it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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


# bf16 parts of each float32 operand of the kernel's tensor-core products
# (csrc/delta_hopper.cuh: PT, PW, PM, PS, PU; :func:`kernel_parts` reads
# them from the built library): T in phase 1's W and U, the stored W and M,
# the state S, and u (and kscale . u).  q, k and v take one part in bf16
# (exact) and two in float32.
PARTS = {"T": 3, "W": 2, "M": 3, "S": 2, "u": 3}


def kernel_parts() -> dict:
    """The built kernel's own part counts, keyed as :data:`PARTS` (builds
    the library: card only)."""
    out = (ctypes.c_int * 5)()
    _build.library().prfaas_delta_parts(out)
    return dict(zip(("T", "W", "M", "S", "u"), out))


def split_bf16(x, parts=2):
    """``x`` (float32) as ``parts`` bf16 values, each the rounding of what
    the earlier ones leave, returned as float32: two keep ~16 of float32's
    24 significand bits, three all of them."""
    out = []
    for _ in range(parts):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return tuple(out)


def split_matmul(a, b, parts_a=2, parts_b=2):
    """``a @ b`` as the kernel computes it on bf16 tensor cores with float32
    accumulators: each operand in its bf16 parts (:func:`split_bf16`; one
    part for a value exact in bf16), and the part products i, j with
    i + j < max(parts_a, parts_b) summed (two parts each: hi.hi + hi.lo +
    lo.hi).  Products of bf16 values are exact in float32; the card's
    tensor cores sum them in another order and with their own rounding, and
    its outputs round to another bf16 value ~3x as often as this
    emulation's (``tests/test_torch_gpu.py::test_delta_core_rounds_like_float32``
    holds the card's rate)."""
    n = max(parts_a, parts_b)
    out = 0
    for i, x in enumerate(split_bf16(a, parts_a)):
        for j, y in enumerate(split_bf16(b, parts_b)):
            if i + j < n:
                out = out + x @ y
    return out


def _matmul(a, b, parts_a=2, parts_b=2):
    return a @ b


class WYFactors(NamedTuple):
    """Phase 1's output, per chunk of ``CHUNK`` rows (leading dims B, H,
    chunk): the chunk's neutralized rows ``q``, ``k`` (C, dk); ``W`` =
    T diag(beta) (K . gamma) (C, dk); ``U`` = T diag(beta) V (C, dv);
    ``M`` = Q K^T . D_incl (C, C); ``gamma`` = exp(cs), ``kscale`` =
    exp(cs_C - cs) (C,); ``g`` = exp(cs_C); T = (I + A)^-1.  ``exact``:
    q, k and v hold bf16 values (the kernel takes them in one part, else
    two); ``S``: the rows before chunk padding."""
    q: torch.Tensor
    k: torch.Tensor
    W: torch.Tensor
    U: torch.Tensor
    M: torch.Tensor
    gamma: torch.Tensor
    kscale: torch.Tensor
    g: torch.Tensor
    exact: bool
    S: int


def wy_factors(q, k, v, log_a, beta, lengths=None, *, emulate=False):
    """Phase 1 of the kernel, plain: for every chunk at once, what depends
    only on its rows.  Same inputs as :func:`delta_chunked_fused` (any
    device; ``lengths`` None for the unmasked instance).  Rows at or past
    a length are neutralized as the kernel does it (k, v, beta, log_a ->
    0; q kept), rows past S are zero, and chunks are always ``CHUNK`` rows.
    T = (I + A)^-1 by a triangular solve; with ``emulate`` the products are
    :func:`split_matmul`'s with the kernel's ``PARTS`` and W and M are
    rounded to their stored bf16 parts, as in the kernel's workspace."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    exact = q.dtype == torch.bfloat16
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
    bt = torch.where(valid, F.pad(beta.float(), (0, pad)), 0.0).reshape(
        B, H, nc, CHUNK)
    mm = split_matmul if emulate else _matmul
    pin = 1 if exact else 2
    cs = torch.cumsum(la, dim=-1)
    idx = torch.arange(CHUNK, device=dev)
    incl = idx[None, :] <= idx[:, None]
    diff = cs[..., :, None] - cs[..., None, :]
    d_incl = torch.where(incl, torch.exp(torch.where(incl, diff, 0.0)), 0.0)
    d_strict = torch.where(idx[None, :] < idx[:, None], d_incl, 0.0)
    kt = kc.transpose(-1, -2)
    A = bt[..., :, None] * (mm(kc, kt, pin, pin) * d_strict)
    eye = torch.eye(CHUNK, device=dev)
    T = torch.linalg.solve_triangular(eye + A, eye.expand_as(A), upper=False,
                                      unitriangular=True)
    gamma = torch.exp(cs)
    W = mm(T * (bt * gamma)[..., None, :], kc, PARTS["T"], pin)
    U = mm(T * bt[..., None, :], vc, PARTS["T"], pin)
    M = mm(qc, kt, pin, pin) * d_incl
    if emulate:
        W = sum(split_bf16(W, PARTS["W"]))
        M = sum(split_bf16(M, PARTS["M"]))
    return WYFactors(qc, kc, W, U, M, gamma, torch.exp(cs[..., -1:] - cs),
                     torch.exp(cs[..., -1]), exact, S)


def state_pass(f: WYFactors, initial_state, *, emulate=False):
    """Phase 2 of the kernel, plain: the chunks of :func:`wy_factors`'s
    output in order, per chunk u = U - W S, o = gamma . (Q S) + M u, S <-
    g S + K^T (kscale . u).  With ``emulate`` every product is
    :func:`split_matmul`'s, as on the tensor cores.  Returns (o (B, H, S,
    dv) float32, final state float32)."""
    mm = split_matmul if emulate else _matmul
    pin = 1 if f.exact else 2
    ps, pu = PARTS["S"], PARTS["u"]
    state = initial_state.float()
    outs = []
    for c in range(f.q.shape[2]):
        u = f.U[:, :, c] - mm(f.W[:, :, c], state, PARTS["W"], ps)
        o = f.gamma[:, :, c, :, None] * mm(f.q[:, :, c], state, pin, ps)
        outs.append(o + mm(f.M[:, :, c], u, PARTS["M"], pu))
        state = f.g[:, :, c, None, None] * state + mm(
            f.k[:, :, c].transpose(-1, -2), f.kscale[:, :, c, :, None] * u,
            pin, pu)
    B, H = state.shape[:2]
    o = torch.stack(outs, dim=2).reshape(B, H, -1, state.shape[-1])
    return o[:, :, :f.S], state


# the kernel's tiles (csrc/delta_hopper.cuh): the key dim padded to a
# multiple of 64, at most MAX_DK; value columns in slices of 32
MAX_DK = 256


def _launch(name, q, k, v, log_a, beta, lengths, initial_state):
    """Validate, allocate the output, state and workspace, and launch the
    masked (``lengths`` given) or the unmasked instance of
    ``csrc/delta.cu`` (both phases, one count)."""
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
    if dk > MAX_DK:
        raise ValueError(f"{name}: key dim {dk} exceeds {MAX_DK}")
    o = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if state.numel() == 0:
        return o, state
    lib = _build.library()
    nbytes = lib.prfaas_delta_workspace_bytes(B, H, S, dk, dv,
                                              _build.dtype_code(q))
    ws = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            beta.data_ptr())
    tail = (initial_state.data_ptr(), o.data_ptr(), state.data_ptr(),
            ws.data_ptr(), nbytes, B, H, S, dk, dv, _build.dtype_code(q),
            _build.stream_ptr(q))
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
