"""Flash-decode: the plain PyTorch version and the CUDA kernel's wrapper.

The kernel (``csrc/decode_attn.cu``) replaces the TPU kernel
``src/repro/kernels/decode_attn.py::decode_attention``; the plain version
follows ``src/repro/kernels/ref.py::decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build

_KEYS_PER_SPLIT = 512   # fewest keys worth a split of their own


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


def split_plan(q, Hkv: int, Dv: int, S: int):
    """Launch plan shared by the dense and paged decode kernels: G query
    heads per block, the number of key splits per row (about two blocks per
    SM, none shorter than ``_KEYS_PER_SPLIT`` of the S key positions), and
    the float32 (accumulator, max/sum) scratch of the splits."""
    B, Hq, _ = q.shape
    G = _heads_per_block(Hq // Hkv, Dv)
    blocks = B * (Hq // G)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = max(1, min(-(-2 * sms // max(blocks, 1)),
                        -(-S // _KEYS_PER_SPLIT)))
    part_acc = torch.empty((B, Hq, splits, Dv), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hq, splits, 2), dtype=torch.float32,
                          device=q.device)
    return G, splits, part_acc, part_ml


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     scale: float | None = None):
    """The CUDA kernel: same contract as :func:`decode_attention_ref`, on
    contiguous CUDA tensors (q and caches of one dtype, int32 lengths)."""
    name = "decode_attention"
    _build.require_cuda(name, q, k_cache, v_cache, lengths)
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
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    G, splits, part_acc, part_ml = split_plan(q, Hkv, Dv, S)
    lib = _build.library()
    err = lib.prfaas_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), B, Hq, Hkv, S, Dk, Dv, G, int(window),
        float(scale), splits, _build.dtype_code(q),
        _build.stream_ptr(q))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return out
