"""AdamW with float32 master weights, global-norm clipping and a
warmup + cosine learning-rate schedule.

Counterpart of ``src/repro/training/optimizer.py``.  State:
``{"step", "mu", "nu", "master"}``, each a tree of float32 tensors shaped
like the params (``master`` a float32 copy of them).  Unlike the
reference, which returns new trees, :func:`apply_updates` updates ``mu``,
``nu``, ``master`` and the params in place under ``torch.no_grad()`` and
returns the same trees: at 1.3 B params the float32 state is 12 B a param
(16 GB), and a second copy of it would crowd out the activations on one
card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.collectives import global_norm
from repro_torch.models.tree import tree_flatten_with_path, tree_map

# substrings of a leaf's path that exempt it from weight decay (norms,
# biases, gates), as the reference's ``_decay_mask``
NO_DECAY = ("norm", "ln", "bias", "b_gates", "A_log", "dt_bias", "D_skip")


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (an integer tensor), float32 0-d on its
    device: linear warmup over ``warmup_steps``, then a cosine from ``lr``
    down to ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_state(params):
    """Zero moments, step 0, and a float32 copy of the params as master
    weights (a copy even of float32 params: the update writes both)."""
    device = tree_flatten_with_path(params)[0][1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                       copy=True), params)}


def _decay_mask(path: str) -> bool:
    """Weight decay for matrices only: no leaf whose path names a norm, a
    bias or a gate."""
    return not any(k in path for k in NO_DECAY)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place (see the module docstring).  Returns
    (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    trees = [tree_flatten_with_path(t) for t in
             (params, grads, state["mu"], state["nu"], state["master"])]
    for (path, p), (_, g), (_, mu), (_, nu), (_, ma) in zip(*trees):
        gf = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * gf)
        nu.copy_(b2 * nu + (1 - b2) * gf * gf)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if _decay_mask(path):
            upd = upd + cfg.weight_decay * ma
        ma.sub_(lr * upd)
        p.copy_(ma)
    return params, {**state, "step": step}, {"grad_norm": gn, "lr": lr}
