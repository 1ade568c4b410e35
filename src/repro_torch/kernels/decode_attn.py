"""Flash-decode: the plain PyTorch version and the CUDA kernel's wrapper.

The kernel (``csrc/decode_attn.cu``) replaces the TPU kernel
``src/repro/kernels/decode_attn.py::decode_attention``; the plain version
follows ``src/repro/kernels/ref.py::decode_attention_ref``.  bfloat16 runs
the Hopper core ``csrc/decode_hopper.cuh`` (:func:`require_bf16_decode`),
float32 the SIMT core ``csrc/decode_core.cuh``; :func:`split_plan` is the
launch plan of both and :func:`tile_runs` the bf16 core's split of the
live keys, as the kernels derive it on the device.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build as _build

_KEYS_PER_SPLIT = 512   # float32: fewest keys worth a split of their own
TC_GROUP = 16           # bf16: query heads a cache head from which the
                        # tensor cores take the group (64 rows a tile)
_SMEM_MAX = 232448      # shared memory of a block on the H100
_TC_SMEM_FIXED = 1024 + 64
_STREAM_WARPS = 4       # bf16 stream: workers (warps) a block
_STREAM_BLOCKS_PER_SM = 3


def decode_attention_ref(q, k_cache, v_cache, lengths, *, window: int = 0,
                         scale: float | None = None):
    """q: (B, Hq, Dk); caches: (B, Hkv, S, Dk/Dv); lengths: (B,) int.

    Request b sees keys [max(0, L_b - window), L_b), L_b = lengths[b] (the
    cache already holds the current token).  Returns (B, Hq, Dv) in q's
    dtype.  The group of query heads sharing a cache head contracts against
    it in one batched product, without a repeated copy of the cache."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    scores = torch.einsum("bngd,bnkd->bngk", qf, k_cache.float())
    kpos = torch.arange(S, device=q.device)[None, :]
    lengths = lengths.to(q.device)
    mask = kpos < lengths[:, None]
    if window > 0:
        mask &= kpos >= (lengths[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bngk,bnkd->bngd", probs, v_cache.float())
    return out.reshape(B, Hq, Dv).to(q.dtype)


def _heads_per_block(group: int, Dv: int) -> int:
    for g in (16, 8, 4, 2, 1):
        if group % g == 0 and g * Dv <= 8192:
            return g
    raise ValueError(f"value dim {Dv} exceeds 8192")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stream_shape(Dk: int, Dv: int):
    """The bf16 stream's (C, XC): C lanes (8, 16 or 32) share a key row,
    XC 16-byte chunks (1, 2 or 4) a lane."""
    ch = _cdiv(max(Dk, Dv), 8)
    C = 8
    while C < ch and C < 32:
        C *= 2
    XC = 1
    while 32 * XC < ch:
        XC *= 2
    return C, XC


def tc_tile(Dk: int, Dv: int) -> int:
    """The bf16 tensor-core tile: 32 keys where two stages fit beside the
    64-row Q in shared memory, else 16."""
    KP, NVP = _cdiv(Dk, 64), _cdiv(Dv, 64)
    fits = _TC_SMEM_FIXED + KP * 8192 + 2 * (KP + NVP) * 32 * 128
    return 32 if fits <= _SMEM_MAX else 16


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How a decode call is launched.

    ``core``: "simt" (float32, ``decode_core.cuh``), "wgmma" (bf16, G >=
    ``TC_GROUP``) or "stream" (bf16, smaller groups).  ``heads``: query
    heads a block (simt) or a worker (stream), 64 rows (wgmma).
    ``workers``: key splits per row (simt), workers per head tile (bf16).
    ``tile``: keys a tile."""
    core: str
    heads: int
    workers: int
    tile: int

    def scratch(self, B: int, Hq: int, Dv: int, device):
        """The float32 partials: (accumulator, max/sum) of each split of
        each row (simt) or of each of the workers + B - 1 segments
        (bf16)."""
        lead = ((B, Hq, self.workers) if self.core == "simt"
                else (self.workers + B - 1, Hq))
        return (torch.empty((*lead, Dv), dtype=torch.float32, device=device),
                torch.empty((*lead, 2), dtype=torch.float32, device=device))


def split_plan(B: int, Hq: int, Hkv: int, Dk: int, Dv: int, S: int, dtype,
               sms: int, window: int = 0) -> DecodePlan:
    """Launch plan shared by the dense and paged decode kernels, from the
    shapes and the device's SM count alone (the lengths stay on the
    device).

    float32: G query heads a block and each row's live keys cut into
    ``workers`` runs (about two blocks per SM, none shorter than
    ``_KEYS_PER_SPLIT`` of the S positions).  bfloat16: the live tiles of
    all rows are split evenly over ``workers`` per head tile (one block an
    SM at the tensor cores; ``_STREAM_BLOCKS_PER_SM`` blocks of four warp
    workers on the stream), never more than the tiles the rows could hold
    (``window`` caps them), see :func:`tile_runs`."""
    G = Hq // Hkv
    if dtype == torch.float32:
        g = _heads_per_block(G, Dv)
        blocks = B * (Hq // g)
        splits = max(1, min(_cdiv(2 * sms, max(blocks, 1)),
                            _cdiv(S, _KEYS_PER_SPLIT)))
        return DecodePlan("simt", g, splits, 16)
    live = min(S, window) if window > 0 else S   # most live keys a row
    if G >= TC_GROUP:
        tile = tc_tile(Dk, Dv)
        want = sms // (Hkv * _cdiv(G, 64))
        return DecodePlan("wgmma", 64,
                          max(1, min(want, B * _cdiv(live, tile))), tile)
    C, XC = stream_shape(Dk, Dv)
    heads, tile = min(G, 8 // XC), (4 // XC) * (32 // C)
    # one wave: a second, partial one would double the time of its blocks
    want = _STREAM_BLOCKS_PER_SM * sms // (Hkv * _cdiv(G, heads))
    blocks = max(1, min(want, _cdiv(B * _cdiv(live, tile), _STREAM_WARPS)))
    return DecodePlan("stream", heads, _STREAM_WARPS * blocks, tile)


def tile_runs(lengths, S: int, window: int, tile: int, workers: int):
    """The bf16 core's split of the live keys, as each kernel block derives
    it from ``lengths`` on the device: row b's live keys [max(0, L_b -
    window), min(L_b, S)) are cut into tiles of ``tile`` keys, the tiles of
    all rows are numbered in row order, and each of the W workers takes a
    run of T // W of them, one more for the first T % W (worker i starts
    at i (T // W) + min(i, T % W)).  Returns, for each worker, its (row,
    first key, end key) segments; the segment of worker i on row b is
    partial i + b."""
    spans = []
    for L in lengths:
        L = max(int(L), 0)
        n = min(L, S)
        lo = max(0, L - window) if window > 0 else 0
        spans.append((lo, n, _cdiv(n - lo, tile) if n > lo else 0))
    total = sum(c for _, _, c in spans)
    q, rem = divmod(total, workers)
    runs = []
    for i in range(workers):
        t0 = i * q + min(i, rem)
        t1 = t0 + q + (i < rem)
        segs, first = [], 0
        for b, (lo, n, c) in enumerate(spans):
            a, e = max(t0, first), min(t1, first + c)
            if a < e:
                segs.append((b, lo + (a - first) * tile,
                             min(n, lo + (e - first) * tile)))
            first += c
        runs.append(segs)
    return runs


def row_workers(first: int, count: int, total: int, workers: int):
    """The workers whose runs (:func:`tile_runs`) meet a row's tiles
    [first, first + count) of ``total``, as the combine kernel finds them:
    from the worker of its first tile to that of its last."""
    if count <= 0:
        return range(0)
    q, rem = divmod(total, workers)

    def worker_of(x):
        big = rem * (q + 1)
        return x // (q + 1) if x < big else rem + (x - big) // q

    return range(worker_of(first), worker_of(first + count - 1) + 1)


def require_bf16_decode(name: str, Dk: int, Dv: int, *tensors):
    """What the bf16 decode core takes (``csrc/decode_hopper.cuh``): head
    dims that are multiples of 8 (16-byte chunks) with Dk <= 1024 and Dv
    <= 512, and 16-byte aligned tensors."""
    for d, top in ((Dk, 1024), (Dv, 512)):
        if d % 8 or not 0 < d <= top:
            raise ValueError(f"{name}: a bfloat16 head dim must be a "
                             f"multiple of 8 up to {top}, got {d}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 tensors must be 16-byte "
                             f"aligned, got data_ptr {t.data_ptr():#x}")


def cache_rows(k_cache, v_cache):
    """(rB, rH, rS) such that key j of (row b, head h) starts at element
    (b * rB + h * rH + j * rS) * D of both caches (D = Dk for k, Dv for
    v), or None when the two views cannot be read so.  A contiguous
    (B, Hkv, S, D) cache gives (Hkv * S, S, 1); the (B, S, Hkv, D) buffer
    seen through ``transpose(1, 2)`` gives (S * Hkv, 1, Hkv)."""
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        return None
    Dk, Dv = k_cache.shape[-1], v_cache.shape[-1]
    rows = []
    for dim in range(3):
        if k_cache.shape[dim] == 1:
            rows.append(0)
            continue
        ks, vs = k_cache.stride(dim), v_cache.stride(dim)
        if ks % Dk or vs % Dv or ks // Dk != vs // Dv:
            return None
        rows.append(ks // Dk)
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The device's streaming multiprocessors (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     scale: float | None = None):
    """The CUDA kernel: same contract as :func:`decode_attention_ref`, on
    CUDA tensors (q and caches of one dtype, int32 lengths).  q and lengths
    are contiguous; the caches are read in place wherever
    :func:`cache_rows` finds their key rows (a contiguous cache, or the
    model's (B, S, Hkv, D) buffers through a transpose)."""
    name = "decode_attention"
    _build.require_cuda(name, q, lengths)
    _build.require_cuda(name, q, k_cache, v_cache, contiguous=False)
    B, Hq, Dk = q.shape
    Bk, Hkv, S, Dk2 = k_cache.shape
    Dv = v_cache.shape[-1]
    if ((Bk, Dk2) != (B, Dk) or v_cache.shape[:3] != k_cache.shape[:3]
            or Hq % Hkv or tuple(lengths.shape) != (B,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    if not (k_cache.dtype == v_cache.dtype == q.dtype):
        raise TypeError(f"{name}: q and cache dtypes differ")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    if Dk > 1024 or Dv > 512:
        raise ValueError(f"{name}: head dims Dk {Dk}, Dv {Dv} too large")
    rows = cache_rows(k_cache, v_cache)
    if rows is None:
        raise ValueError(f"{name}: k and v key rows must be contiguous and "
                         f"share their strides, got {k_cache.stride()} and "
                         f"{v_cache.stride()}")
    if q.dtype == torch.bfloat16:
        require_bf16_decode(name, Dk, Dv, q, k_cache, v_cache)
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = split_plan(B, Hq, Hkv, Dk, Dv, S, q.dtype, sm_count(q.device),
                      int(window))
    part_acc, part_ml = plan.scratch(B, Hq, Dv, q.device)
    lib = _build.library()
    err = lib.prfaas_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), *rows, B, Hq, Hkv, S, Dk, Dv, plan.heads,
        int(window), float(scale), plan.workers, plan.tile,
        _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return out
