"""One rank of ``tests/test_torch_spmd.py``'s four-rank (2, 2) ("data",
"model") mesh on ``gloo``.  Imports ``torch`` and ``repro_torch`` only.

    python tests/_torch_spmd_rank.py JOB_DIR RANK WORLD

reads ``JOB_DIR/job.json`` and the reference's params (``<arch>.npz``,
keyed by ``tree_flatten_with_path`` paths), joins the group through
``file://JOB_DIR/store`` and runs, in order:

  * each ``steps`` case: ``train_loss`` of batch 0 on the sharded params
    (ce, aux), then two steps of ``make_sharded_train_step`` (two
    microbatches), the first under a byte-counting ``CommDebugMode``; the
    placements of every param and AdamW leaf after the steps against the
    rules'; rank 0 writes the gathered params, ``mu``, ``nu`` and
    ``master`` to ``<case>.out.npz``;
  * the ``launcher`` case: ``launch.train._train`` on the mesh for two
    steps into one directory (rank 0 writes the gathered params to
    ``launcher.out.npz``), resumed there to four steps, and four steps
    unbroken into another.

Rank 0 writes every number to ``JOB_DIR/result.json``.
"""
import json
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (leaf_name,  # noqa: E402
                                              param_pspec, to_placements)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.tree import (tree_flatten_with_path,  # noqa: E402
                                     tree_map_with_path)
from repro_torch.params import init_params, requires_grad  # noqa: E402
from repro_torch.training import (AdamWConfig, DataConfig,  # noqa: E402
                                  SyntheticLM, TrainConfig, init_opt_state)

# the train steps of tests/test_torch_train_step.py
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=20)
SEQ, BATCH, MICROBATCHES, STEPS = 32, 4, 2, 2


class ByteCommMode(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes on
    this rank, by kind (as ``tests/test_torch_dtensor.py`` does)."""

    KINDS = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}

    def __init__(self):
        super().__init__()
        self.nbytes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self.KINDS.get(func._overloadpacket.__name__)
        if kind is not None and out is not NotImplemented:
            self.nbytes[kind] = (self.nbytes.get(kind, 0)
                                 + out.numel() * out.element_size())
        return out


def load_tree(path, like):
    """The npz's arrays (keyed by path) as a tree like ``like``."""
    with np.load(path) as data:
        return tree_map_with_path(
            lambda p, _: torch.from_numpy(data["".join(
                f"[{k!r}]" for k in p)].copy()), like)


def flat_numpy(prefix, tree):
    return {f"{prefix}{k}": v.detach().numpy()
            for k, v in tree_flatten_with_path(spmd.gather_tree(tree))}


def misplaced(tree, mesh, fsdp):
    """Paths of the DTensor leaves of ``tree`` not in their rule's
    placements."""
    bad = []

    def check(path, x):
        want = to_placements(param_pspec(leaf_name(path), tuple(x.shape),
                                         mesh, fsdp=fsdp), mesh)
        if x.device_mesh != mesh or tuple(x.placements) != want:
            bad.append(leaf_name(path))

    tree_map_with_path(check, tree)
    return bad


def run_steps(job, case, mesh):
    cfg = get_smoke_config(case["arch"])
    fsdp = case["fsdp"]
    like = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = load_tree(os.path.join(job, f"{case['arch']}.npz"), like)
    tc = TrainConfig(microbatches=MICROBATCHES, adamw=AdamWConfig(**ADAMW))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH))
    model = Model(cfg, remat=True)
    state = spmd.shard_opt_state(init_opt_state(params, tc), mesh, fsdp)
    params = requires_grad(spmd.shard_params(params, mesh, fsdp))
    out = {}
    from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication():
        _, m = model.train_loss(params, spmd.shard_batch(data.batch(0), mesh))
        out.update({k: float(v.full_tensor() if hasattr(v, "full_tensor")
                             else v) for k, v in m.items()})
    step = spmd.make_sharded_train_step(model, tc, mesh, fsdp)
    out["steps"] = []
    for i in range(STEPS):
        if i == 0:
            with ByteCommMode() as comm:
                params, state, m = step(params, state, data.batch(i))
            out["comm_bytes"] = comm.nbytes
        else:
            params, state, m = step(params, state, data.batch(i))
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["step"] = int(state["step"].full_tensor())
    out["step_placements"] = [str(p) for p in state["step"].placements]
    out["misplaced"] = misplaced(params, mesh, fsdp) + [
        f"{key}/{p}" for key in ("mu", "nu", "master")
        for p in misplaced(state[key], mesh, fsdp)]
    arrays = flat_numpy("params", params)
    for key in ("mu", "nu", "master"):
        arrays.update(flat_numpy(key, state[key]))
    if dist.get_rank() == 0:
        np.savez(os.path.join(job, f"{case['name']}.out.npz"), **arrays)
    return out


def run_launcher(job, case, mesh):
    from repro_torch.launch import train as train_cli

    def train(steps, ckpt):
        args = train_cli.build_parser().parse_args(
            ["--arch", case["arch"], "--smoke", "--device", "cpu",
             "--steps", str(steps), "--batch", str(BATCH), "--seq", str(SEQ),
             "--ckpt-dir", os.path.join(job, ckpt)])
        return train_cli._train(args, mesh)

    first, params = train(2, "ckpt_a")
    arrays = flat_numpy("", params)
    out = {"first": first, "dirs_after_first": sorted(os.listdir(
        os.path.join(job, "ckpt_a")))}
    if dist.get_rank() == 0:
        np.savez(os.path.join(job, "launcher.out.npz"), **arrays)
    resumed, _ = train(4, "ckpt_a")
    unbroken, _ = train(4, "ckpt_b")
    out.update(resumed=resumed, unbroken=unbroken)
    return out


def main(job, rank, world):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with open(os.path.join(job, "job.json")) as f:
        spec = json.load(f)
    result, seconds = {}, {}
    for case in spec["steps"]:
        t0 = time.perf_counter()
        result[case["name"]] = run_steps(job, case, mesh)
        seconds[case["name"]] = time.perf_counter() - t0
    if spec.get("launcher"):
        t0 = time.perf_counter()
        result["launcher"] = run_launcher(job, spec["launcher"], mesh)
        seconds["launcher"] = time.perf_counter() - t0
    result["seconds"] = seconds
    if rank == 0:
        with open(os.path.join(job, "result.json"), "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
