"""Kernel dispatch: each op runs its hand-written CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors.

The path follows the device of the tensors given, never a global switch:
a CUDA tensor always reaches the kernel, which raises if it cannot build or
launch (there is no fallback).  ``use_kernel=False`` on the model's ops
selects the plain version on any device; only tests and ``chip_smoke.py``'s
comparison phase pass it.

The ops that training reaches (``attention``, ``gla``, ``delta``) are
differentiable on both paths.  On the CPU autograd runs through the plain
version.  On CUDA they are :class:`RecomputeGrad`: the forward launches
the kernel and keeps only its inputs, and the backward recomputes the
plain version and takes its gradient, as the reference's ``custom_vjp``s
do (``src/repro/kernels/ops.py:55-78, 133-150, 216-233``; no TPU kernel
has a backward kernel).  The decode, paged and quantize ops are serving
only and have no backward.

On DTensors (the sharded train step, ``distributed/spmd.py``) the three
training ops run in a ``local_map`` (:func:`_on_shards`): the batch dim
over ("pod", "data") and the head dim over "model", where they divide, so
each rank's kernel (or plain version) sees whole heads of its own batch
rows; inputs laid out otherwise are redistributed first.  The local
tensor's device then picks the kernel or the plain version, as above.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import delta as _delta
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import gla as _gla
from repro_torch.kernels import paged_decode_attn as _pdecode
from repro_torch.kernels import paged_prefill_attn as _pprefill
from repro_torch.kernels import quantize as _quant
from repro_torch.models import chunked_attention as _chunked


def _plain(use_kernel: bool, x) -> bool:
    """The plain version runs for ``use_kernel=False`` and for CPU and
    ``meta`` tensors (the dry run counts a step's work on ``meta``, as the
    reference's lowers every op to its plain version on host devices); a
    CUDA tensor always reaches its kernel."""
    return not use_kernel or x.device.type in ("cpu", "meta")


def _run_plain(plain, *inputs):
    """``plain(*inputs)``: every kernel op runs its plain version through
    this one call, the seam where ``analysis/counting.py`` counts a kernel
    op's bytes at its kernel's boundary while it counts a step."""
    return plain(*inputs)


def _on_shards(op, args, n_out: int, **kw):
    """``op(*args, **kw)`` on each rank's shards of the DTensor ``args``
    (B, H, ...) (None entries pass through): every input and the ``n_out``
    outputs are placed with the batch dim over the data axes when it
    divides them (``batch_pspec``) and the head dim over "model" when every
    input's heads divide it, else replicated there.  A plain tensor among
    ``args`` (a zero state built from the global shape) is taken as
    replicated."""
    from repro_torch.distributed.local_map import local_map
    from repro_torch.distributed.sharding import (axis_sizes, batch_pspec,
                                                  to_placements)

    mesh = args[0].device_mesh
    model = axis_sizes(mesh).get("model", 1)
    pl = to_placements((batch_pspec(tuple(args[0].shape), mesh)[0],
                        "model" if all(a.shape[1] % model == 0 for a in args
                                       if a is not None) else None), mesh)
    return local_map(lambda *a: op(*a, **kw), mesh,
                     tuple(None if a is None else pl for a in args),
                     (pl,) * n_out)(*args)


class RecomputeGrad(torch.autograd.Function):
    """``forward(kernel, plain, *inputs)`` returns ``kernel(*inputs)`` and
    saves only the inputs; ``backward`` recomputes ``plain(*inputs)`` with
    autograd and returns its gradient for the inputs that need one.
    ``kernel`` and ``plain`` take the same tensors and return a tensor or a
    tuple of tensors of the same shapes; non-tensor arguments are bound
    into them."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, need)]
            outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [x for x, n in zip(xs, need) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs],
                                           wrt, [g for _, g in pairs],
                                           allow_unused=True)
                       if pairs and wrt else [None] * len(wrt))
        return (None, None, *(next(got) if n else None for n in need))


# at most this many keys, the plain attention is the quadratic version
SMALL_SEQ = 1024


def plain_attention_route(Sq: int, Sk: int, *, causal: bool,
                          window: int) -> str:
    """Which plain attention runs at these shapes, as the reference's
    ``_attention_jnp`` (``src/repro/kernels/ops.py:92-101``) picks it:
    ``"quadratic"`` (``flash_attention_ref``) up to ``SMALL_SEQ`` keys,
    ``"swa_banded"`` for a causal window over at least two windows of
    self-attention, ``"mea"`` (``mea_attention``) otherwise."""
    if Sk <= SMALL_SEQ:
        return "quadratic"
    if window > 0 and causal and Sq == Sk and Sk >= 2 * window:
        return "swa_banded"
    return "mea"


def attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                    q_offset=0):
    """The plain attention of :func:`plain_attention_route`'s choice: the
    CPU path, and the backward recompute of the kernel on CUDA."""
    route = plain_attention_route(q.shape[2], k.shape[2], causal=causal,
                                  window=window)
    if route == "quadratic":
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, scale=scale,
                                          q_offset=q_offset)
    if route == "swa_banded":
        return _chunked.swa_banded(q, k, v, window=window, scale=scale)
    return _chunked.mea_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, q_offset=q_offset)


def attention(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
              use_kernel=True):
    """Full attention (GQA/MQA/MHA/SWA). q: (B,Hq,Sq,Dk); k, v:
    (B,Hkv,Sk,Dk/Dv).  ``q_offset`` is explicit: the position of q row 0
    minus that of k row 0 (the chunked-prefill suffix passes the prior
    length).  The plain version is :func:`attention_plain`."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if isinstance(q, DTensor):
        return _on_shards(attention, (q, k, v), 1, use_kernel=use_kernel,
                          **kw)

    def plain(q, k, v):
        return attention_plain(q, k, v, **kw)

    if _plain(use_kernel, q):
        return _run_plain(plain, q, k, v)

    def kernel(q, k, v):
        return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), **kw)

    return RecomputeGrad.apply(kernel, plain, q, k, v)


def _training_only(lengths):
    if lengths is not None:
        raise NotImplementedError("the sharded scans take no lengths: a "
                                  "sharded prefill is not ported")


def _zeros_state(q, dv):
    B, H, _, dk = q.shape
    return torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)


def delta(q, k, v, log_a, beta, initial_state=None, *, lengths=None,
          use_kernel=True):
    """Gated delta rule, in chunks of ``delta.CHUNK`` on both paths.
    Returns (o, final_state).

    ``lengths`` (B,): valid rows per batch row of a right-padded batch.
    Rows at or past it are neutralized (decay -> 1, k/beta -> 0): in-kernel
    on CUDA, by :func:`delta.mask_padded` before the plain chunked form.
    Without it every row is valid (training): the unmasked kernel, or the
    plain chunked form alone, which on DTensors runs on each rank's
    shards."""
    if isinstance(q, DTensor):
        _training_only(lengths)
        return _on_shards(delta, (q, k, v, log_a, beta, initial_state), 2,
                          use_kernel=use_kernel)
    if initial_state is None:
        initial_state = _zeros_state(q, v.shape[-1])
    S = q.shape[2]
    if lengths is None:
        plain = _delta.delta_chunked_ref

        def kernel(q, k, v, log_a, beta, s0):
            return _delta.delta_chunked(
                q.contiguous(), k.contiguous(), v.contiguous(),
                log_a.contiguous(), beta.contiguous(), s0.contiguous())
    else:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()

        def plain(q, k, v, log_a, beta, s0):
            log_a, k, beta = _delta.mask_padded(lengths, S, log_a, k, beta)
            return _delta.delta_chunked_ref(q, k, v, log_a, beta, s0)

        def kernel(q, k, v, log_a, beta, s0):
            return _delta.delta_chunked_fused(
                q.contiguous(), k.contiguous(), v.contiguous(),
                log_a.contiguous(), beta.contiguous(), lengths,
                s0.contiguous())
    args = (q, k, v, log_a, beta, initial_state)
    if _plain(use_kernel, q):
        return _run_plain(plain, *args)
    return RecomputeGrad.apply(kernel, plain, q, k, v, log_a.float(),
                          beta.float(), initial_state.float())


def gla(q, k, v, log_a, initial_state=None, *, lengths=None,
        use_kernel=True):
    """Gated linear attention (scalar per-head decay), in chunks of
    ``gla.CHUNK`` on both paths.  Returns (o, final_state).

    ``lengths`` (B,): valid rows per batch row of a right-padded batch.
    Rows at or past it are neutralized (decay -> 1, k -> 0): in-kernel on
    CUDA, by :func:`gla.mask_padded` before the plain chunked form.
    Without it every row is valid (training): the unmasked kernel, or the
    plain chunked form alone, which on DTensors runs on each rank's
    shards."""
    if isinstance(q, DTensor):
        _training_only(lengths)
        return _on_shards(gla, (q, k, v, log_a, initial_state), 2,
                          use_kernel=use_kernel)
    if initial_state is None:
        initial_state = _zeros_state(q, v.shape[-1])
    S = q.shape[2]
    if lengths is None:
        plain = _gla.gla_chunked_ref

        def kernel(q, k, v, log_a, s0):
            return _gla.gla_chunked(q.contiguous(), k.contiguous(),
                                    v.contiguous(), log_a.contiguous(),
                                    s0.contiguous())
    else:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()

        def plain(q, k, v, log_a, s0):
            log_a, k = _gla.mask_padded(lengths, S, log_a, k)
            return _gla.gla_chunked_ref(q, k, v, log_a, s0)

        def kernel(q, k, v, log_a, s0):
            return _gla.gla_chunked_fused(
                q.contiguous(), k.contiguous(), v.contiguous(),
                log_a.contiguous(), lengths, s0.contiguous())
    if _plain(use_kernel, q):
        return _run_plain(plain, q, k, v, log_a, initial_state)
    return RecomputeGrad.apply(kernel, plain, q, k, v, log_a.float(),
                          initial_state.float())


def decode_attention(q, k_cache, v_cache, lengths, *, window=0, scale=None,
                     use_kernel=True):
    """One-query attention over a dense cache. q: (B,Hq,Dk); caches
    (B,Hkv,S,Dk/Dv); lengths (B,) keys per row (context + 1).  The kernel
    reads the caches in place where their key rows allow it
    (:func:`decode_attn.cache_rows`: GQA's (B, S, Hkv, D) buffers through a
    transpose); other views are copied first."""
    if _plain(use_kernel, q):
        return _run_plain(lambda *a: _decode.decode_attention_ref(
            *a, window=window, scale=scale), q, k_cache, v_cache, lengths)
    if _decode.cache_rows(k_cache, v_cache) is None:
        k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    return _decode.decode_attention(
        q.contiguous(), k_cache, v_cache,
        lengths.to(device=q.device, dtype=torch.int32).contiguous(),
        window=window, scale=scale)


def verify_attention(q, k_cache, v_cache, lengths, *, scale=None,
                     use_kernel=True):
    """Speculative-verify attention over Q candidate positions. q:
    (B,Hq,Q,Dk); caches (B,Hkv,S,Dk/Dv); position j sees ``min(lengths +
    j, S)`` keys (``lengths`` = context + 1, the first position's count).
    The plain version scores all Q positions in one masked pass; the
    kernel path makes Q calls of the flash-decode kernel (row 2), as the
    reference's kernel path does (``src/repro/kernels/ops.py:296-314``),
    so the card's numerics are the one-token decode's."""
    if _plain(use_kernel, q):
        return _run_plain(lambda *a: _decode.verify_attention_ref(
            *a, scale=scale), q, k_cache, v_cache, lengths)
    S = k_cache.shape[2]
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    return torch.stack([
        decode_attention(q[:, :, j], k_cache, v_cache,
                         torch.clamp(lengths + j, max=S), scale=scale)
        for j in range(q.shape[2])], dim=2)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           window=0, scale=None, use_kernel=True):
    """One-query attention over a shared page pool. q: (B,Hq,Dk); pools
    (Hkv,P,T,Dk/Dv); tables (B,N) physical page ids; lengths (B,) keys per
    row (context + 1)."""
    if _plain(use_kernel, q):
        return _run_plain(lambda *a: _pdecode.paged_decode_attention_ref(
            *a, window=window, scale=scale), q, k_pages, v_pages, tables,
            lengths)
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
        return _run_plain(lambda *a: _pprefill.paged_prefill_attention_ref(
            *a, scale=scale), q, k_pages, v_pages, tables, k_suf, v_suf)
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


def quantize_wire_leaves(leaves):
    """Per-tensor symmetric int8 of each :class:`quantize.WireLeaf`, read
    in place -> ``[(q int8, scale float32 0-d, scale in the leaf's dtype
    0-d)]``, byte-identical on both paths; on CUDA one launch pair for
    all of them."""
    if leaves and leaves[0].x.device.type == "cpu":
        return _quant.quantize_int8_wire_ref(leaves)
    return _quant.quantize_int8_wire(leaves)


# single-step recurrent updates: plain PyTorch on every device, as in the
# reference (which has no kernel for them)
delta_step = _delta.delta_step_ref
gla_step = _gla.gla_step_ref
