"""Memory-efficient plain attention for training: scans over query blocks
whose float32 scores are recomputed in the backward.

Counterpart of ``src/repro/models/chunked_attention.py:100-201``
(``swa_banded``, ``mea_attention``).  :func:`repro_torch.kernels.ops
.attention` takes them as its plain version above ``SMALL_SEQ`` keys, so
they are the CPU path and the backward recompute of the flash kernel on
CUDA.  Each query block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint(body)``): the backward keeps the blocks'
inputs, never a whole (Sq, Sk) score matrix.  The masks are the
reference's, and a row with no valid key gives 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _masked_probs(s, mask):
    """Softmax of the float32 scores ``s`` (..., bq, bk) over ``mask``
    (bq, bk); rows with no valid key give 0."""
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(-1)[:, None], p, 0.0)


def swa_banded(q, k, v, *, window: int, scale: float | None = None,
               block_q: int = 512):
    """Causal sliding-window attention, q: (B, Hq, S, Dk), k: (B, Hkv, S,
    Dk), v: (B, Hkv, S, Dv) -> (B, Hq, S, Dv) in q's dtype.  Each block of
    ``block_q`` queries attends only its (window + block_q)-key band, so
    the work is linear in S."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    block_q = min(block_q, S)
    pad = (-S) % block_q
    nq = (S + pad) // block_q
    band = window + block_q
    # K / V left-padded by a band so every block's slice is in range
    kp = F.pad(k, (0, 0, band, pad))
    vp = F.pad(v, (0, 0, band, pad))
    qf = (F.pad(q, (0, 0, 0, pad)).float() * scale).reshape(
        B, Hkv, G, nq, block_q, D)
    dev = q.device

    def body(qb, kb, vb, start):
        # kb covers absolute positions [start - window, start + block_q)
        s = torch.einsum("bngqd,bnkd->bngqk", qb, kb.float())
        qpos = start + torch.arange(block_q, device=dev)[:, None]
        kpos = start - window + torch.arange(band, device=dev)[None, :]
        mask = ((kpos >= 0) & (kpos <= qpos) & (kpos > qpos - window)
                & (kpos < S) & (qpos < S))
        p = _masked_probs(s, mask)
        return torch.einsum("bngqk,bnkd->bngqd", p, vb.float())

    out = torch.stack([checkpoint(
        body, qf[:, :, :, i], kp.narrow(2, (i + 1) * block_q, band),
        vp.narrow(2, (i + 1) * block_q, band), i * block_q,
        use_reentrant=False) for i in range(nq)], dim=3)
    return out.reshape(B, Hq, S + pad, -1)[:, :, :S].to(q.dtype)


def mea_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int = 0,
                  block_q: int = 512):
    """Attention over every key, q: (B, Hq, Sq, Dk), k: (B, Hkv, Sk, Dk),
    v: (B, Hkv, Sk, Dv) -> (B, Hq, Sq, Dv) in q's dtype, scanned over
    blocks of ``block_q`` queries.  ``q_offset``: the position of q row 0
    minus that of k row 0; as in the reference, 0 with ``causal`` and
    Sq != Sk aligns the queries with the last keys (bottom right)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q_offset == 0 and causal and Sq != Sk:
        q_offset = Sk - Sq
    block_q = min(block_q, Sq)
    pad = (-Sq) % block_q
    nq = (Sq + pad) // block_q
    qf = (F.pad(q, (0, 0, 0, pad)).float() * scale).reshape(
        B, Hkv, G, nq, block_q, D)
    kf, vf = k.float(), v.float()
    dev = q.device
    kpos = torch.arange(Sk, device=dev)[None, :]

    def body(qb, kf, vf, start):
        s = torch.einsum("bngqd,bnkd->bngqk", qb, kf)
        qpos = q_offset + start + torch.arange(block_q, device=dev)[:, None]
        mask = ((qpos - q_offset) < Sq).expand(block_q, Sk)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        return torch.einsum("bngqk,bnkd->bngqd", _masked_probs(s, mask), vf)

    out = torch.stack([checkpoint(body, qf[:, :, :, i], kf, vf, i * block_q,
                                  use_reentrant=False)
                       for i in range(nq)], dim=3)
    return out.reshape(B, Hq, Sq + pad, -1)[:, :, :Sq].to(q.dtype)
