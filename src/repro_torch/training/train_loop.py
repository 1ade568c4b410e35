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


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.train_loss`` on ``batch``; the
    grads form a tree like ``params``, in each leaf's dtype (a leaf no
    path reaches gets zeros)."""
    leaves = tree_leaves(params)
    loss, metrics = model.train_loss(params, batch)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(got, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, cfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``params``' leaves must require grad
    (``params.requires_grad``); the batch's first axis must divide by
    ``cfg.microbatches``."""

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        n = cfg.microbatches
        if n > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(model, params, mb)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                del g_i
                loss = loss + l_i
            for acc in tree_leaves(grads):
                acc.div_(n)
            loss = loss / n
        else:
            loss, _, grads = loss_and_grads(model, params, batch)

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
        ``{"step", "loss", "time_s", "grad_norm"}`` per step run."""
        step_fn = make_train_step(self.model, self.cfg)
        ckpt = CheckpointManager(self.cfg.checkpoint_dir,
                                 keep=self.cfg.keep_checkpoints)

        if start_step is None:
            start_step = 0
            if ckpt.latest_step() is not None:
                restored, manifest = ckpt.restore(
                    {"params": params, "opt": opt_state})
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
        return params, opt_state, history
