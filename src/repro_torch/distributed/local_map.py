"""``local_map`` for the port's DTensor code, and the head-layout fixes
the model's DTensor backward needs.

Imports nothing of the port, so the model's modules can use it (the
sharded step itself, ``spmd.py``, imports the model).  On DTensors
(``distributed/spmd.py``) the kernel ops and the capacity MoE run each
rank's shards through :func:`local_map`, and the model's head splits pass
their gradient through :func:`contiguous_grad` after :func:`splittable`;
on plain tensors none of them changes anything.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def _contiguous(x):
    """The DTensor ``x`` with a contiguous local tensor: DTensor may
    declare a contiguous layout over a local tensor that is not, and its
    ``contiguous()`` then reads the declaration and copies nothing."""
    return DTensor.from_local(
        x.to_local().contiguous(), x.device_mesh, x.placements,
        run_check=False, shape=x.shape,
        stride=torch.empty(x.shape, device="meta").stride())


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on its gradient contiguous, its local
    tensor included, and (``parts``) :func:`splittable` into that many
    heads."""

    @staticmethod
    def forward(ctx, x, parts):
        ctx.parts = parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _contiguous(splittable(g, ctx.parts) if ctx.parts else g), \
            None


def contiguous_grad(x, parts: int = 0):
    """``x``; on a DTensor, its gradient is made contiguous on the way
    back, and with ``parts``, :func:`splittable` into that many heads.
    The model splits heads as ``reshape`` then ``transpose``: the
    transpose's backward hands a transposed gradient to the reshape's
    ``view``, which DTensor may first redistribute and then cannot view;
    it merges them as ``transpose`` then ``reshape``, whose backward views
    the (B, S, H * D) gradient as heads."""
    return _ContiguousGrad.apply(x, parts) if isinstance(x, DTensor) else x


def splittable(x, parts: int):
    """``x``; a DTensor whose last dim is sharded over mesh dims that do
    not divide ``parts`` (the heads that dim is about to be split into)
    is first gathered over those dims, since DTensor refuses to unflatten
    a dim unevenly (e.g. 2 heads' features over a "model" axis of 16)."""
    if not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == last
            and parts % mesh.size(i) else pl
            for i, pl in enumerate(x.placements)]
    return x if want == list(x.placements) else x.redistribute(mesh, want)


def local_map(fn, device_mesh, in_placements, out_placements,
              in_grad_placements=None):
    """``torch.distributed.tensor.experimental.local_map`` that
    redistributes each DTensor argument to its ``in_placements`` and takes
    a plain tensor argument as replicated (it was built from a DTensor's
    global shape)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map as _lm

    def wrap(a):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
            return DTensor.from_local(a, device_mesh,
                                      [Replicate()] * device_mesh.ndim,
                                      run_check=False)
        return a

    mapped = _lm(fn, out_placements=out_placements,
                 in_placements=in_placements,
                 in_grad_placements=in_grad_placements,
                 device_mesh=device_mesh, redistribute_inputs=True)
    return lambda *args: mapped(*(wrap(a) for a in args))
