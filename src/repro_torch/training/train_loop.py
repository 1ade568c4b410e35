"""The train step and the fault-tolerant train loop.

Counterpart of ``src/repro/training/train_loop.py``.  ``make_train_step``
builds a step with:
  * gradient accumulation over microbatches (the batch split along its
    first axis), summed into float32 buffers and divided by the count;
  * per-repeat remat when the model has it (``Model(remat=True)``);
  * optional int8 error-feedback gradient compression before the
    optimizer (``residuals`` in the optimizer state);
  * AdamW, applied in place (``training/optimizer.py``).

``TrainLoop`` adds checkpoint/restart (asynchronous, atomic), a straggler
hook (per-step wall time against its EWMA), crash recovery (exact, since
batch ``i`` is a pure function of the seed and ``i``) and an injected
node failure for the tests.  Step times are taken after
``torch.cuda.synchronize()`` on the card, the counterpart of
``block_until_ready``.

``TrainConfig`` has the reference's fields less ``remat`` and ``unroll``.
Remat is ``Model(remat=...)``: the reference's step also takes it from
its model and never reads ``TrainConfig.remat``.  ``unroll`` only shapes
the reference's traced microbatch scan, which an eager loop has no
counterpart of.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import spmd
from repro_torch.distributed.collectives import (compress_grads_with_feedback,
                                                 zeros_like_residuals)
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.params import requires_grad
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    checkpoint_every: int = 50
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_async: bool = True
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0     # step slower than EWMA x this => flag


def _like_param(g, p):
    """The gradient ``g`` of ``p`` laid out as ``p``: zeros where no path
    reaches ``p``; a DTensor gradient brought to its param's placements
    (FSDP's reduce-scatter, data parallelism's all-reduce)."""
    if g is None:
        return torch.zeros_like(p)
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.train_loss`` on ``batch``; the
    grads form a tree like ``params``, in each leaf's dtype and layout (a
    leaf no path reaches gets zeros)."""
    leaves = tree_leaves(params)
    loss, metrics = model.train_loss(params, batch)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(_like_param(g, p) for g, p in zip(got, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, cfg: TrainConfig, place=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``params``' leaves must require grad
    (``params.requires_grad``); the batch's first axis must divide by
    ``cfg.microbatches``.  ``place(microbatch) -> microbatch`` lays each
    microbatch's tensors out for the step: onto the params' device unless
    given (the sharded step, ``distributed/spmd.py``, shards them)."""

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        put = place or (lambda b: {k: v.to(device) for k, v in b.items()})
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        n = cfg.microbatches
        if n > 1:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = 0.0
            for i in range(n):
                mb = put({k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                          for k, v in batch.items()})
                l_i, _, g_i = loss_and_grads(model, params, mb)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                del g_i
                loss = loss + l_i
            for acc in tree_leaves(grads):
                acc.div_(n)
            loss = loss / n
        else:
            loss, _, grads = loss_and_grads(model, params, put(batch))

        if cfg.compress_grads:
            grads, residuals = compress_grads_with_feedback(
                grads, opt_state["residuals"])
            opt_state = {**opt_state, "residuals": residuals}

        inner = {k: v for k, v in opt_state.items() if k != "residuals"}
        params, inner, om = opt.apply_updates(params, grads, inner, cfg.adamw)
        if cfg.compress_grads:
            inner["residuals"] = opt_state["residuals"]
        return params, inner, {"loss": loss, **om}

    return train_step


def init_opt_state(params, cfg: TrainConfig):
    state = opt.init_state(params)
    if cfg.compress_grads:
        state["residuals"] = zeros_like_residuals(params)
    return state


@dataclass
class TrainLoop:
    model: Model
    cfg: TrainConfig
    data: object                       # .batch(step) -> dict
    mesh_fingerprint: str = ""
    on_straggler: Optional[Callable[[int, float], None]] = None
    fail_at_step: Optional[int] = None   # fault injection (tests)

    def run(self, params, opt_state, num_steps: int,
            start_step: Optional[int] = None):
        """Train from the latest checkpoint (or ``start_step``, or 0) to
        ``num_steps``.  Returns (params, opt_state, history), one
        ``{"step", "loss", "time_s", "grad_norm"}`` per step run.  Params
        and state as DTensors placed by the rules with FSDP (the
        launcher's layout, ``distributed/spmd.py``) take the sharded step,
        and a checkpoint restores onto their placements; every rank of the
        mesh runs this together."""
        sharded = spmd.is_sharded(params)
        if sharded:
            step_fn = spmd.make_sharded_train_step(
                self.model, self.cfg, tree_leaves(params)[0].device_mesh)
        else:
            step_fn = make_train_step(self.model, self.cfg)
        ckpt = CheckpointManager(self.cfg.checkpoint_dir,
                                 keep=self.cfg.keep_checkpoints)

        if start_step is None:
            start_step = 0
            if ckpt.latest_step() is not None:
                like = {"params": params, "opt": opt_state}
                restored, manifest = ckpt.restore(
                    like, shardings=spmd.layout_of(like) if sharded
                    else None)
                params, opt_state = restored["params"], restored["opt"]
                start_step = manifest["step"]
        requires_grad(params)
        device = tree_leaves(params)[0].device

        ewma = None
        history = []
        for step in range(start_step, num_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected node failure at step {step}")
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            # straggler mitigation hook: flag steps far above the EWMA
            if ewma is None:
                ewma = dt
            else:
                if dt > self.cfg.straggler_factor * ewma \
                        and self.on_straggler is not None:
                    self.on_straggler(step, dt / ewma)
                ewma = 0.9 * ewma + 0.1 * dt
            history.append({"step": step, "loss": float(metrics["loss"]),
                            "time_s": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if (step + 1) % self.cfg.checkpoint_every == 0 \
                    or step + 1 == num_steps:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          self.mesh_fingerprint,
                          blocking=not self.cfg.checkpoint_async)
        ckpt.wait()
        if sharded:
            # the writer's last checkpoint is published before any rank
            # goes on (a run that follows reads the latest step)
            torch.distributed.barrier()
        return params, opt_state, history
