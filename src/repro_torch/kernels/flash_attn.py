"""Flash attention: the plain PyTorch version and the CUDA kernel's wrapper.

The kernel (``csrc/flash_attn.cu``) replaces the TPU kernel
``src/repro/kernels/flash_attn.py::flash_attention``; the plain version
follows ``src/repro/kernels/ref.py::flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0):
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv) ->
    (B, Hq, Sq, Dv), float32 softmax, output in q's dtype.

    ``q_offset``: global position of q row 0 minus that of k row 0.  The
    Hq / Hkv query heads of a group share their K/V head through a batched
    product (no repeated copy of K/V), which sums the same terms as the
    reference's repeat-then-einsum."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = (q.float() * scale).reshape(B, Hkv, G, Sq, D)
    scores = torch.einsum("bngqd,bnkd->bngqk", qf, k.float())
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows with no visible key give NaN -> 0 (padded rows only)
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v.float())
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def require_bf16_core(name: str, dims, *tensors):
    """What the bf16 tensor-core core takes (``csrc/flash_wgmma.cuh``):
    head dims that are multiples of 8 up to 256 (TMA rows are whole
    16-byte units) and 16-byte aligned tensors."""
    for d in dims:
        if d % 8 or not 0 < d <= 256:
            raise ValueError(f"{name}: a bfloat16 head dim must be a "
                             f"multiple of 8 up to 256, got {d}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 tensors must be 16-byte "
                             f"aligned, got data_ptr {t.data_ptr():#x}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0):
    """The CUDA kernel: same contract as :func:`flash_attention_ref`, on
    contiguous CUDA tensors of one dtype: float32 (the SIMT core) or
    bfloat16 (the tensor-core core, see :func:`require_bf16_core`)."""
    name = "flash_attention"
    _build.require_cuda(name, q, k, v)
    B, Hq, Sq, Dk = q.shape
    Bk, Hkv, Sk, Dk2 = k.shape
    Dv = v.shape[-1]
    if (Bk, Dk2) != (B, Dk) or v.shape[:3] != k.shape[:3] or Hq % Hkv:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    if Dk > 256 or Dv > 256:
        raise ValueError(f"{name}: head dims Dk {Dk}, Dv {Dv} exceed 256")
    if q_offset < 0 or window < 0:
        raise ValueError(f"{name}: q_offset and window must be >= 0")
    if q.dtype == torch.bfloat16:
        require_bf16_core(name, (Dk, Dv), q, k, v)
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.prfaas_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        Sq, Sk, Dk, Dv, int(q_offset), int(bool(causal)), int(window),
        float(scale), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return out
