"""The port's fault-tolerant train loop, checkpoints and training launcher,
on the CPU: the counterparts of ``tests/test_training_serving.py::
TestTraining``, run on ``zamba2-1.2b`` at smoke size (the port has no
qwen2.5 yet) with the same loop settings.

  * the loss decreases over 10 steps;
  * a run that fails at step 6 resumes from its step-4 checkpoint and ends
    bit-identical to an uninterrupted run (losses and params);
  * the straggler hook fires;
  * checkpoints restore bit-exactly (bfloat16 leaves through their bits),
    publish atomically, and keep the newest ``keep``;
  * ``python -m repro_torch.launch.train --smoke --device cpu`` runs and
    prints the reference launcher's summary; ``--production-mesh`` refuses
    a process without the production mesh's 256 ranks.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.models.tree import tree_leaves
from repro_torch.params import init_params
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  SyntheticLM, TrainConfig, TrainLoop,
                                  init_opt_state)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _params(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture()
def tiny(tmp_path):
    cfg = get_smoke_config("zamba2-1.2b")
    model = Model(cfg, use_kernels=True, remat=True)
    tc = TrainConfig(microbatches=2, checkpoint_every=4,
                     checkpoint_dir=str(tmp_path / "ckpt"),
                     adamw=AdamWConfig(lr=1e-3, warmup_steps=4,
                                       total_steps=50))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=48,
                                  global_batch=8, seed=0))
    return cfg, model, tc, data


def test_loss_decreases(tiny):
    cfg, model, tc, data = tiny
    params = _params(cfg)
    _, _, hist = TrainLoop(model, tc, data).run(
        params, init_opt_state(params, tc), 10)
    assert [h["step"] for h in hist] == list(range(10))
    assert all(math.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_crash_and_resume_exact(tiny):
    """An injected failure at step 6; the restart resumes from the step-4
    checkpoint and ends where an uninterrupted run ends, bit for bit
    (stateless data, deterministic CPU arithmetic)."""
    cfg, model, tc, data = tiny
    p0 = _params(cfg)
    ref = dataclasses.replace(tc, checkpoint_dir=tc.checkpoint_dir + "-ref")
    want_params, _, want = TrainLoop(model, ref, data).run(
        p0, init_opt_state(p0, ref), 8)

    p1 = _params(cfg)
    crash = TrainLoop(model, tc, data, fail_at_step=6)
    with pytest.raises(RuntimeError, match="injected node failure"):
        crash.run(p1, init_opt_state(p1, tc), 8)
    assert CheckpointManager(tc.checkpoint_dir).latest_step() == 4
    p2 = _params(cfg, seed=1)          # overwritten by the restore
    got_params, _, got = TrainLoop(model, tc, data).run(
        p2, init_opt_state(p2, tc), 8)
    assert got[0]["step"] == 4
    assert [h["loss"] for h in got] == [h["loss"] for h in want[4:]]
    for a, b in zip(tree_leaves(got_params), tree_leaves(want_params)):
        assert torch.equal(a, b)


def test_straggler_hook_fires(tiny):
    cfg, model, tc, data = tiny
    flagged = []
    tc2 = dataclasses.replace(tc, straggler_factor=0.0001,
                              checkpoint_dir=tc.checkpoint_dir + "2")
    params = _params(cfg)
    TrainLoop(model, tc2, data, on_straggler=lambda s, r: flagged.append(s)
              ).run(params, init_opt_state(params, tc2), 4)
    assert flagged == [1, 2, 3]                  # every step "slow"


def test_checkpoint_round_trip_bit_exact(tmp_path):
    """Leaves of every dtype come back bit-exact on their like's device, an
    asynchronous save publishes atomically (no tmp- directory left), and
    the manifest carries the step, the keys and the mesh fingerprint."""
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(5, 3, generator=g).bfloat16(),
                       "ln": torch.randn(3, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": [torch.randn(4, generator=g)]}}
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    mgr.save(3, tree, "single:cpu", blocking=False)
    mgr.wait()
    assert os.listdir(tmp_path / "m") == ["step-00000003"]
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                       "ln": torch.zeros(3)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "mu": [torch.zeros(4)]}}
    restored, manifest = mgr.restore(like)
    assert manifest["step"] == 3 and manifest["mesh"] == "single:cpu"
    assert manifest["keys"] == sorted(["['params']['w']", "['params']['ln']",
                                       "['opt']['step']", "['opt']['mu'][0]"])
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b)


def _bytes(t):
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_retention_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3)}, blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.save_count == 4


def test_train_cli_runs(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-1.2b", "--smoke", "--device", "cpu", "--steps", "4",
         "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "c")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout)
    assert summary["steps"] == 4
    assert np.isfinite([summary["first_loss"], summary["final_loss"],
                        summary["mean_step_s"]]).all()
    assert CheckpointManager(str(tmp_path / "c")).latest_step() == 4
    # the one-device layout's fingerprint, as the reference's launcher
    # writes it for a 1 x 1 mesh
    manifest = tmp_path / "c" / "step-00000004" / "manifest.json"
    assert json.loads(manifest.read_text())["mesh"] == "data=1xmodel=1"


def test_train_cli_refuses_production_mesh(tmp_path):
    with pytest.raises(RuntimeError, match="256 ranks"):
        train_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                        "cpu", "--production-mesh",
                        "--ckpt-dir", str(tmp_path)])
