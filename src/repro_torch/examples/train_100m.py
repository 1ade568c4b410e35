"""Train a hybrid LM (KDA:MLA 3:1, the paper's architecture family) with
the port's training stack: AdamW, remat, gradient accumulation,
asynchronous atomic checkpoints, straggler detection, crash-resume.

A copy of the reference's ``examples/train_100m.py`` on the port, with
``--device`` (default ``cuda``).  Two scales:
  * --scale 8m   (default): a CPU-feasible demo (~60 steps);
  * --scale 100m: the reference's recipe (53.7 M params, 12 layers, a few
    hundred steps of 32 x 1024 tokens), sized for an accelerator.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_100m --scale 100m

On CUDA the KDA mixers run the unmasked delta-rule kernel and the MLA
blocks the flash kernel; the backward recomputes their plain versions.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, LinearSpec, ModelConfig)
from repro_torch.models import Model
from repro_torch.params import init_params
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                  TrainConfig, TrainLoop, init_opt_state)


def hybrid_lm(scale: str) -> ModelConfig:
    if scale == "100m":
        d, dk, heads, dff, vocab, reps = 512, 64, 8, 2048, 8192, 3
    else:                                    # ~8M (1-core friendly)
        d, dk, heads, dff, vocab, reps = 256, 32, 4, 1024, 4096, 2
    kda = LinearSpec(kind="kda", heads=heads, key_dim=dk, value_dim=dk,
                     conv_kernel=4)
    mla = AttentionSpec(kind="mla", q_heads=heads, kv_heads=heads,
                        head_dim=dk, mla_kv_rank=2 * dk, mla_rope_dim=dk // 2)
    ffn = FFNSpec(kind="dense", d_ff=dff, activation="swiglu")
    return ModelConfig(
        name=f"hybrid-{scale}", family="hybrid", d_model=d, vocab_size=vocab,
        groups=(GroupSpec(blocks=(BlockSpec(kda, ffn), BlockSpec(kda, ffn),
                                  BlockSpec(kda, ffn), BlockSpec(mla, ffn)),
                          repeats=reps),),
        tie_embeddings=True, dtype="float32")


def defaults(scale: str):
    """(steps, batch, seq) of the recipe at ``scale``."""
    return (60, 4, 128) if scale == "8m" else (300, 32, 1024)


def run(scale: str, steps, batch, seq, device, ckpt_dir: str):
    """Train the recipe (None for a step count or shape takes the scale's
    default), checkpointing into ``ckpt_dir``, emptied first; returns
    (config, history, straggler flags)."""
    d_steps, d_batch, d_seq = defaults(scale)
    steps, batch, seq = steps or d_steps, batch or d_batch, seq or d_seq
    cfg = hybrid_lm(scale)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.n_layers} layers (KDA:MLA 3:1), "
          f"{steps} steps x {batch}x{seq} tokens", flush=True)
    device = torch.device(device)
    model = Model(cfg, use_kernels=True, remat=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    stragglers = []
    tc = TrainConfig(
        microbatches=2,
        adamw=AdamWConfig(lr=1e-3, warmup_steps=max(5, steps // 15),
                          total_steps=steps),
        checkpoint_every=max(20, steps // 4), checkpoint_dir=ckpt_dir)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch))
    loop = TrainLoop(model, tc, data,
                     on_straggler=lambda s, r: stragglers.append((s, r)))
    _, _, hist = loop.run(params, init_opt_state(params, tc), steps)
    return cfg, hist, stragglers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="8m", choices=["8m", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt = os.path.join(tempfile.gettempdir(),
                        f"repro_torch_hybrid-{args.scale}_ckpt")
    _, hist, stragglers = run(args.scale, args.steps, args.batch, args.seq,
                              args.device, ckpt)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{len(hist)} steps "
          f"({sum(h['time_s'] for h in hist)/len(hist)*1e3:.0f} ms/step)")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3, "training failed"
    print(f"straggler flags: {len(stragglers)}; checkpoints in {ckpt}")


if __name__ == "__main__":
    main()
