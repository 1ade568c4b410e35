"""Gradient compression with error feedback, and the global norm.

Counterpart of ``src/repro/distributed/collectives.py``: int8 +
per-tensor-scale quantization of each gradient leaf with an error-feedback
residual (``g' = Q(g + r)``, ``r' = (g + r) - g'``), used by the train step
when ``TrainConfig.compress_grads`` is set.  This is the optimizer-side
quantizer in plain PyTorch, not the KV wire kernel
(``kernels/quantize.py``): its scale is a reciprocal multiply, as the
reference's.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import tree_flatten_with_path, tree_map


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale
    float32 0-d): scale = max(|x|max, 1e-30) * (1/127), q = round(x /
    scale) clipped to +-127 (round half to even, as ``jnp.round``)."""
    absmax = x.abs().max()
    scale = torch.clamp(absmax, min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_grads_with_feedback(grads, residuals):
    """Error-feedback compression of a gradient tree.  Returns (the
    dequantized gradients in each leaf's dtype, the new float32
    residuals)."""
    def one(g, r):
        gf = g.float() + r
        deq = dequantize_int8(*quantize_int8(gf))
        return deq.to(g.dtype), gf - deq

    return _unzip(tree_map(one, grads, residuals))


def _unzip(tree):
    """A tree of (a, b) leaves -> (tree of a, tree of b)."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in parts.items()},
                {k: b for k, (_, b) in parts.items()})
    if isinstance(tree, list):
        parts = [_unzip(v) for v in tree]
        return [a for a, _ in parts], [b for _, b in parts]
    return tree


def zeros_like_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, summed in the
    reference's leaf order."""
    leaves = [torch.sum(torch.square(x.float()))
              for _, x in tree_flatten_with_path(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))
