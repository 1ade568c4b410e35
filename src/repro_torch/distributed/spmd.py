"""The sharded train step: params, AdamW state and batch as DTensors on a
``DeviceMesh``, placed by the port's own rules.

Counterpart of the reference's ``jax.jit(step, in_shardings=(ps, opt_sh,
bs), out_shardings=(ps, opt_sh, None))`` (``src/repro/launch/dryrun.py:
101-116``): FSDP over "data" and TP over "model".  The reference needs no
model change to shard, since GSPMD propagates the placements and inserts
the collectives; here DTensor's sharding propagation plays that part, and
the functional ``Model`` runs on DTensor leaves as it runs on tensors.
What is stated by hand:

  * FSDP's gather (:class:`Gathered`): each microbatch's forward sees every
    param gathered over the data axes, its "model" shards kept, and the
    gradient goes back to the shards by a reduce-scatter;
  * the kernel ops that training reaches (``kernels/ops.py``: attention,
    delta, gla) run in a ``local_map``, so each rank's CUDA kernel (or
    plain version on the CPU) sees whole heads of its own batch rows;
  * the capacity MoE (``models/layers.py:moe_train``) runs in a
    ``local_map`` with the reference's global dispatch: the block's
    tokens are gathered before routing, the expert ``d_ff`` stays over
    "model";
  * the model's head splits and merges pass their DTensor gradients
    through ``local_map.contiguous_grad`` (DTensor's ``view`` in the
    backward refuses a transposed local tensor and an uneven head split).

The embedding lookup, the vocab-sharded logits and the exact chunked
cross-entropy are DTensor's own, which gathers what it must.

The step runs under ``implicit_replication``: a plain tensor the model
builds inside (positions, masks, zero states, the aux accumulator) is
taken as replicated, which is right because each is built from a DTensor's
global shape.  Params and AdamW state keep the placements they came in
with (the update is in place); gradients are brought to their param's
placements before they are summed (the reduce-scatter of FSDP, the
all-reduce of data parallelism); the metrics come out as plain replicated
scalars.

Every rank holds the same global tree (drawn from one seed, or restored
from one checkpoint) and the same global batch, so each keeps its own
shard without a scatter (``src_data_rank=None``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (batch_pspec, leaf_name,
                                              param_pspec, to_placements)
from repro_torch.models.tree import tree_leaves, tree_map, tree_map_with_path


def _distribute(x, device_mesh, spec):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.as_tensor(x).detach(), device_mesh,
                             to_placements(spec, device_mesh),
                             src_data_rank=None)


def check_placements(params, device_mesh, fsdp: bool = True):
    """Raise ``ValueError`` naming the first leaf of ``params`` that is not
    a DTensor on ``device_mesh`` in its rule's placements."""
    def check(path, x):
        want = to_placements(param_pspec(leaf_name(path), tuple(x.shape),
                                         device_mesh, fsdp=fsdp),
                             device_mesh)
        if getattr(x, "device_mesh", None) != device_mesh \
                or tuple(x.placements) != want:
            raise ValueError(f"param {leaf_name(path)} is not placed by the "
                             f"rules (fsdp={fsdp}): want {want}")

    tree_map_with_path(check, params)


def shard_params(params, device_mesh, fsdp: bool = True):
    """Each leaf as a DTensor placed by ``param_pspec`` (FSDP: also over
    "data")."""
    return tree_map_with_path(lambda path, x: _distribute(
        x, device_mesh, param_pspec(leaf_name(path), tuple(x.shape),
                                    device_mesh, fsdp=fsdp)), params)


def shard_opt_state(opt_state, device_mesh, fsdp: bool = True):
    """The AdamW state: ``step`` replicated, ``mu`` / ``nu`` / ``master``
    (and compression ``residuals``) by their params' specs, as
    ``dryrun.py:106-110``."""
    out = {}
    for key, tree in opt_state.items():
        if key == "step":
            out[key] = _distribute(tree, device_mesh, ())
        else:
            out[key] = shard_params(tree, device_mesh, fsdp)
    return out


def shard_batch(batch, device_mesh):
    """Each leaf's leading batch dim over ("pod", "data") when it divides
    (``batch_pspec``), else replicated."""
    return {k: _distribute(v, device_mesh, batch_pspec(
        tuple(torch.as_tensor(v).shape), device_mesh))
        for k, v in batch.items()}


def layout_of(tree):
    """A tree like ``tree`` of each DTensor leaf's ``(device_mesh,
    placements)``: the ``shardings`` that ``CheckpointManager.restore``
    re-shards a checkpoint onto."""
    return tree_map(lambda x: (x.device_mesh, x.placements), tree)


def is_sharded(tree) -> bool:
    """Whether the tree's leaves are DTensors (a sharded run's tree is one
    throughout)."""
    return isinstance(tree_leaves(tree)[0], DTensor)


def writes_here(tree) -> bool:
    """Whether this rank writes what is saved of ``tree``: rank 0 of its
    leaves' mesh, or the one process of a tree of tensors."""
    leaf = tree_leaves(tree)[0]
    if not isinstance(leaf, DTensor):
        return True
    mesh = leaf.device_mesh
    return mesh.get_rank() == int(mesh.mesh.flatten()[0])


def gather_tree(tree):
    """Every DTensor leaf as its full (replicated) tensor; a collective,
    so every rank of the mesh calls it."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def gather_data(p):
    """A param as the model uses it under FSDP: gathered over the data
    axes ("pod", "data"), its "model" shards kept.  Differentiable: its
    gradient goes back to the param's shards by a reduce-scatter."""
    from torch.distributed.tensor import Replicate, Shard
    names = p.device_mesh.mesh_dim_names
    want = [Replicate() if isinstance(pl, Shard) and n in ("pod", "data")
            else pl for n, pl in zip(names, p.placements)]
    return p if want == list(p.placements) else p.redistribute(
        p.device_mesh, want)


class Gathered:
    """``model`` with its params gathered over the data axes at each
    ``train_loss`` (:func:`gather_data`): FSDP's all-gather once a
    microbatch, for the whole tree, before the forward (not layer by
    layer), and its reduce-scatter of the gradients in the backward.  The
    sharded step's model; ``training.loss_and_grads`` takes it on sharded
    params and batch under ``implicit_replication``."""

    def __init__(self, model):
        self.model = model

    def train_loss(self, params, batch):
        return self.model.train_loss(tree_map(gather_data, params), batch)


def make_sharded_train_step(model, tc, device_mesh, fsdp: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of ``training.train_loop.make_train_step`` on DTensors.
    ``params`` / ``opt_state``: as :func:`shard_params` /
    :func:`shard_opt_state` give them (params requiring grad); ``batch``:
    the global host batch, each microbatch placed by :func:`shard_batch`.
    ``fsdp``: the layout the params must have been placed with, checked
    leaf by leaf at the first call (where the reference's ``in_shardings``
    would reshard, this step refuses)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.training.train_loop import make_train_step

    step = make_train_step(Gathered(model), tc,
                           place=lambda b: shard_batch(b, device_mesh))
    checked = False

    def train_step(params, opt_state, batch):
        nonlocal checked
        if not checked:
            check_placements(params, device_mesh, fsdp)
            checked = True
        with implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step
