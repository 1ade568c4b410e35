"""Fault-tolerant checkpointing: atomic, asynchronous, keyed by path.

The design of ``src/repro/training/checkpoint.py`` in the port's own
format (it does not read the reference's checkpoints):

  * a save snapshots every leaf to host memory at once (so training may
    update its tensors in place right after), then writes them, on a
    background thread when asked;
  * leaves go into one ``leaves.npz`` keyed by their
    ``tree_flatten_with_path`` path, bfloat16 leaves as their uint16 bits
    so they restore bit-exactly, beside a JSON manifest with the step, the
    keys, each key's dtype and the mesh fingerprint;
  * writes go to ``<dir>/tmp-<step>-<pid>`` and are published by an atomic
    ``rename`` to ``step-<n>``: a crash mid-write never leaves a partial
    checkpoint under a step name;
  * a retention policy keeps the newest ``keep`` checkpoints;
  * a sharded tree (DTensor leaves, ``distributed/spmd.py``) is gathered
    whole by every rank before the writer starts, and only the mesh's rank
    0 writes; ``restore(shardings=)`` re-shards it onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.spmd import writes_here
from repro_torch.models.tree import tree_flatten_with_path, tree_map

def _to_host(x):
    """A leaf as (numpy array that owns its bytes, dtype name); a DTensor
    leaf is gathered whole first (a collective: every rank of its mesh
    calls it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if isinstance(x, DTensor):
            x = x.full_tensor()
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        arr = x.cpu().numpy().copy()
        return (arr.view(np.uint16) if name == "bfloat16" else arr), name
    arr = np.array(x, copy=True)
    return arr, arr.dtype.name


def _from_host(arr, dtype: str, like):
    """The stored array as a leaf like ``like`` (a tensor on its device,
    or a numpy array)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(like.device)


def _unflatten(like, values, path: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, f"{path}[{i}]")
                          for i, v in enumerate(like))
    return values[path]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, mesh_fingerprint: str = "",
             blocking: bool = True):
        """Snapshot ``tree`` to host memory now, then write it (on a
        background thread unless ``blocking``).  A tree of DTensors is
        gathered on every rank of its mesh, synchronously, and written by
        the mesh's rank 0 alone."""
        host = {path: _to_host(x) for path, x in tree_flatten_with_path(tree)}
        if not writes_here(tree):
            return

        def _write():
            tmp = os.path.join(self.dir, f"tmp-{step}-{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "leaves.npz"),
                     **{k: a for k, (a, _) in host.items()})
            manifest = {"step": step, "keys": sorted(host),
                        "dtypes": {k: d for k, (_, d) in host.items()},
                        "mesh": mesh_fingerprint, "time": time.time()}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step-{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                  # atomic publish
            self._retain()
            self.save_count += 1

        if blocking:
            _write()
        else:
            self.wait()                            # one async save in flight
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                try:
                    out.append(int(name.split("-")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None,
                shardings=None):
        """The checkpoint of ``step`` (the latest when None) in the
        structure of ``like_tree``, each tensor leaf on its like's device.
        ``shardings``: a tree like ``like_tree`` of ``(DeviceMesh,
        placements)`` pairs (``distributed.sharding.device_shardings``);
        each leaf is then re-sharded onto its mesh with
        ``distribute_tensor``, so a checkpoint written on one mesh restores
        onto another.  Returns (tree, manifest), or (None, None) with no
        checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step-{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        with np.load(os.path.join(path, "leaves.npz")) as data:
            for key, like in tree_flatten_with_path(like_tree):
                values[key] = _from_host(data[key],
                                         manifest["dtypes"][key], like)
        tree = _unflatten(like_tree, values)
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            tree = tree_map(lambda x, s: distribute_tensor(x, *s), tree,
                            shardings)
        return tree, manifest
