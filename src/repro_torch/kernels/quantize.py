"""Per-tensor symmetric int8 wire encode: the plain PyTorch version and the
CUDA kernel's wrapper.

The kernel (``csrc/quantize.cu``) replaces the TPU kernel
``src/repro/kernels/quantize.py::quantize_int8_fused``; the plain version
follows ``src/repro/kernels/ref.py::quantize_int8_ref``.  The two are
byte-identical: same max, IEEE divide, round-half-even and clip.

The kernel encodes a table of leaves in one launch pair, each read where
it lies: a :class:`WireLeaf` names ``segments`` runs of ``length``
contiguous elements, ``stride`` elements apart, in a bf16 or float32
tensor.  :func:`request_leaf` names request ``idx``'s rows of an
``(R, B, S, ...)`` prefill-cache leaf that way, so the trimmed leaf is
never copied; :func:`gather` is the plain torch view of the same elements.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build as _build

MAX_LEAVES = 16        # leaves a launch pair takes (kMaxLeaves in the source)
BLOCK_ELEMS = 8192     # least elements a block covers (256 threads x 4 x 8)
BLOCKS_PER_SM = 16     # the leaves take about this many blocks an SM


class WireLeaf(NamedTuple):
    """``segments`` runs of ``length`` contiguous elements of ``x``, the
    first ``offset`` elements from ``x``'s first element, ``stride``
    elements apart; encoded, they form a contiguous leaf of ``shape``."""
    x: torch.Tensor
    offset: int
    segments: int
    stride: int
    length: int
    shape: Tuple[int, ...]


def request_leaf(x, idx: int, rows: int) -> WireLeaf:
    """Request ``idx``'s rows ``[0, rows)`` of an ``(R, B, S, ...)`` cache
    leaf, in place: the leaf ``x[:, idx:idx + 1, :rows]``.  Its dims from
    the third on must be contiguous (as the prefill caches are)."""
    shape, stride = x.shape, x.stride()
    if not (0 <= idx < shape[1] and 0 <= rows <= shape[2]):
        raise ValueError(f"request {idx}, rows {rows} outside the leaf's "
                         f"{shape[1]} x {shape[2]}")
    width = 1
    for d in range(x.ndim - 1, 1, -1):
        if shape[d] != 1 and stride[d] != width:
            raise ValueError(f"leaf {tuple(shape)} with strides {stride}: "
                             "rows are not contiguous")
        if d > 2:
            width *= shape[d]
    return WireLeaf(x, idx * stride[1], shape[0], stride[0], rows * width,
                    (shape[0], 1, rows) + tuple(shape[3:]))


def whole_leaf(x) -> WireLeaf:
    """All of a contiguous tensor, as one segment."""
    if not x.is_contiguous():
        raise ValueError("whole_leaf takes a contiguous tensor")
    n = x.numel()
    return WireLeaf(x, 0, 1, n, n, tuple(x.shape))


def gather(leaf: WireLeaf):
    """The elements ``leaf`` names, in its shape (plain torch)."""
    x = leaf.x
    rows = torch.as_strided(x, (leaf.segments, leaf.length), (leaf.stride, 1),
                            x.storage_offset() + leaf.offset)
    return rows.reshape(leaf.shape)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(leaves, sms: int):
    """Pass 1's blocks: ``[(first block, blocks, elements a block)]`` for
    each leaf and the number in all.  One block size for all leaves, a
    multiple of 16 elements and at least ``BLOCK_ELEMS``, such that the
    leaves take about ``BLOCKS_PER_SM`` blocks an SM; every leaf has at
    least one block."""
    totals = [leaf.segments * leaf.length for leaf in leaves]
    per = max(BLOCK_ELEMS, _cdiv(_cdiv(sum(totals), sms * BLOCKS_PER_SM),
                                 16) * 16)
    out, b0 = [], 0
    for t in totals:
        nb = max(1, _cdiv(t, per))
        out.append((b0, nb, per))
        b0 += nb
    return out, b0


def quantize_int8_ref(x):
    """x float32 -> (q int8 of x's shape, scale float32 0-d tensor)."""
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_wire_ref(leaves):
    """Plain version of :func:`quantize_int8_wire`: each leaf gathered, cast
    to float32 and encoded by :func:`quantize_int8_ref`."""
    out = []
    for leaf in leaves:
        q, scale = quantize_int8_ref(gather(leaf).float())
        out.append((q, scale, scale.to(leaf.x.dtype)))
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quantize_int8_wire(leaves):
    """The CUDA kernel: encode every leaf in place, ``MAX_LEAVES`` to a
    launch pair.  Returns per leaf ``(q int8 of the leaf's shape, scale
    float32 0-d, scale in the leaf's dtype 0-d)``, byte-identical to
    :func:`quantize_int8_wire_ref`."""
    name = "quantize_int8_fused"
    leaves = list(leaves)
    if not leaves:
        return []
    _build.require_cuda(name, *(leaf.x for leaf in leaves), contiguous=False)
    out = []
    for i in range(0, len(leaves), MAX_LEAVES):
        out += _launch(name, leaves[i:i + MAX_LEAVES])
    return out


def wire_table(leaves, qs, scales, scales16, blocks):
    """The kernel's table, 11 int64 a leaf as ``prfaas_quantize_wire``
    reads it: the address of segment 0's first element, of the codes
    ``qs[i]``, of the float32 scale ``scales[i]`` and of the bf16 scale
    ``scales16[i]``, the dtype code, segments, stride and length in
    elements, then the leaf's first block, blocks and elements a block
    (``blocks``, from :func:`plan`)."""
    table = []
    for i, (leaf, (b0, nb, per)) in enumerate(zip(leaves, blocks)):
        x = leaf.x
        table += [x.data_ptr() + leaf.offset * x.element_size(),
                  qs[i].data_ptr(), scales.data_ptr() + 4 * i,
                  scales16.data_ptr() + 2 * i, _build.dtype_code(x),
                  leaf.segments, leaf.stride, leaf.length, b0, nb, per]
    return table


def _launch(name, leaves):
    dev = leaves[0].x.device
    n = len(leaves)
    blocks, nblocks = plan(leaves, _sms(dev.index))
    # one allocation: float32 scales, bf16 scales, pass 1's partials
    half = _cdiv(n, 2)
    work = torch.empty((n + half + nblocks,), dtype=torch.float32, device=dev)
    scales, scales16 = work[:n], work[n:n + half].view(torch.bfloat16)
    qs = [torch.empty(leaf.shape, dtype=torch.int8, device=dev)
          for leaf in leaves]
    table = wire_table(leaves, qs, scales, scales16, blocks)
    err = _build.library().prfaas_quantize_wire(
        (ctypes.c_longlong * len(table))(*table), n,
        scales.data_ptr() + 4 * (n + half), nblocks,
        _build.stream_ptr(leaves[0].x))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    s32, s16 = scales.unbind(), scales16.unbind()
    return [(q, s32[i], s16[i] if leaf.x.dtype == torch.bfloat16 else s32[i])
            for i, (q, leaf) in enumerate(zip(qs, leaves))]


def quantize_int8_fused(x):
    """One contiguous float32 or bf16 CUDA tensor through the kernel: same
    contract as :func:`quantize_int8_ref` on ``x.float()``."""
    q, scale, _ = quantize_int8_wire([whole_leaf(x)])[0]
    return q, scale
