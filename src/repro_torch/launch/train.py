"""Training launcher on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --smoke --device cpu --steps 50 --batch 8 --seq 128

The flags of the reference's ``launch/train.py``, plus ``--device``
(default ``cuda``).  Weights are drawn from seed 0; the run checkpoints
into ``--ckpt-dir`` and resumes from its latest checkpoint.
Prints ``{"first_loss", "final_loss", "steps", "mean_step_s"}``.

The model is ``Model(cfg, use_kernels=True, remat=True)``.  The
reference's launcher passes ``use_kernels=False`` only because its Pallas
kernels run in slow interpret mode on a CPU; the port's ops follow the
tensors' device instead, so ``--device cpu`` runs the plain versions and
computes what the reference's launcher computes, and ``--device cuda`` runs
the CUDA kernels.  Without ``--production-mesh`` the step runs on this one
device, and each checkpoint carries that layout's fingerprint,
``data=1xmodel=1``.

``--production-mesh`` builds the (16, 16) ("data", "model") ``DeviceMesh``
over the process group the caller launched (256 ranks, one per GPU,
``launch/mesh.py``; it raises ``RuntimeError`` with another world size)
and trains on it sharded, as the reference's ``with mesh:`` run of its
jitted step: every rank draws the same params from seed 0, keeps its
shard of them and of the AdamW state by the sharding rules with FSDP (the
reference's ``baseline`` variant), and runs ``TrainLoop`` through
``distributed/spmd.py``'s sharded step.  Its checkpoints are gathered and
written by the mesh's rank 0 under ``data=16xmodel=16``; rank 0 prints the
summary.

Every token architecture trains, the MoE ones (kimi-linear-1t,
llama4-scout, mixtral-8x22b) on the capacity MoE with its load-balance
loss.  Like the reference's, the launcher feeds ``SyntheticLM`` tokens
alone: an encoder-decoder or a VLM needs frames or patches it does not
make, so train those through ``make_train_step`` with a batch that has
them.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import AbstractMesh, abstract_mesh
from repro_torch.launch.mesh import make_production_mesh, mesh_fingerprint
from repro_torch.models import Model
from repro_torch.params import init_params
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                  TrainConfig, TrainLoop, init_opt_state)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.production_mesh:
        mesh = make_production_mesh(
            device_type=torch.device(args.device).type)
    else:
        mesh = abstract_mesh((1, 1), ("data", "model"))
    return _train(args, mesh)[0]


def _train(args, mesh):
    """Train as ``args`` say on ``mesh``: an ``AbstractMesh`` (one device)
    or a ``DeviceMesh`` (sharded, every rank of it calling).  Returns (the
    summary, the trained params)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    model = Model(cfg, use_kernels=True, remat=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    tc = TrainConfig(
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                          total_steps=args.steps),
        checkpoint_every=max(10, args.steps // 4),
        checkpoint_dir=args.ckpt_dir)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch))
    opt_state = init_opt_state(params, tc)
    if not isinstance(mesh, AbstractMesh):
        params = spmd.shard_params(params, mesh, fsdp=True)
        opt_state = spmd.shard_opt_state(opt_state, mesh, fsdp=True)
    loop = TrainLoop(model, tc, data, mesh_fingerprint=mesh_fingerprint(mesh))
    params, _, hist = loop.run(params, opt_state, args.steps)
    summary = {"first_loss": hist[0]["loss"], "final_loss": hist[-1]["loss"],
               "steps": len(hist),
               "mean_step_s": sum(h["time_s"] for h in hist) / len(hist)}
    if spmd.writes_here(params):
        print(json.dumps(summary, indent=1))
    return summary, params


if __name__ == "__main__":
    main()
