"""Sharding rules: map every param / batch / cache leaf to a partition spec.

The rules of ``src/repro/distributed/sharding.py`` as plain Python over a
mesh's axis sizes.  A spec is a tuple with one entry per tensor dim:
``None`` (replicated), an axis name, or a tuple of names (the dim split
over those axes in that order), as ``jax.sharding.PartitionSpec`` holds
them.  A mesh is an :class:`AbstractMesh` (sizes and names only, no
process group) or a ``torch.distributed.device_mesh.DeviceMesh``; the
rules read only its ordered axis sizes.

Mesh axes (``launch/mesh.py``):
  * "pod"   — data parallelism across pods (multi-pod only)
  * "data"  — data parallelism within a pod
  * "model" — tensor parallelism (heads / d_ff / expert d_ff / vocab)

Rules (derived from a leaf's path and shape):
  * embed / unembed: the vocab dim over "model"
  * attention and linear-mixer input projections: output features over
    "model" when divisible, else replicated; ``wo``: input features
  * FFN w1 / w3: d_ff over "model"; w2: d_ff (its input) over "model"
  * MoE w1 / w3 / w2: the d_ff dim over "model"; the router replicated
  * norms, biases, gates, convs: replicated
  * with ``fsdp``, the largest dim not yet sharded also over "data"
  * batch dims of inputs and caches: over ("pod", "data") when divisible

The rules match a leaf by the reference's slash spelling of its path
(``groups/0/stacked/b0/mixer/wq/w``, :func:`leaf_name`), not by the
``keystr`` spelling of ``models/tree.py``.

:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
``Replicate()`` on the others.  A dim split over two mesh dims, as
``("pod", "data")``, is split over the first as the outer factor, which
is the layout JAX gives it.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional

from repro_torch.models.tree import tree_map_with_path


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh as its axis sizes and names only (no devices)."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names=None) -> AbstractMesh:
    """``abstract_mesh((16, 16))`` -> ("data", "model");
    ``abstract_mesh((2, 16, 16))`` -> ("pod", "data", "model")."""
    if axis_names is None:
        axis_names = ("pod", "data", "model")[-len(axis_sizes):]
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def axis_sizes(mesh) -> dict:
    """Ordered {axis name: size} of an :class:`AbstractMesh` or a
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _divisible(dim: int, sizes: dict, axis: str) -> bool:
    return axis in sizes and dim % sizes[axis] == 0 and dim > 0


def _data_axes(sizes: dict):
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return axes if axes else None


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_factor(spec, mesh) -> int:
    """How many pieces a spec cuts a leaf into on ``mesh``."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for e in spec for a in spec_axes(e))


def leaf_name(path) -> str:
    """The reference's ``_leaf_name``: a path of keys / indices joined by
    "/"."""
    return "/".join(str(p) for p in path)


def _with_fsdp(spec, shape, mesh):
    """ZeRO-3-style: the largest dim not already sharded, if it divides and
    is at least twice the "data" axis, also split over "data"."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        return spec
    specs = list(spec) + [None] * (len(shape) - len(spec))
    cands = [(shape[d], d) for d in range(len(shape))
             if specs[d] is None and _divisible(shape[d], sizes, "data")
             and shape[d] >= 2 * sizes["data"]]
    if not cands:
        return spec
    _, d = max(cands)
    specs[d] = "data"
    return tuple(specs)


def param_pspec(path: str, shape, mesh, fsdp: bool = False) -> tuple:
    """The spec of a parameter leaf, from its slash path and shape."""
    spec = _param_pspec_base(path, shape, mesh)
    if fsdp:
        spec = _with_fsdp(spec, shape, mesh)
    return spec


def _param_pspec_base(path: str, shape, mesh) -> tuple:
    sizes = axis_sizes(mesh)
    nd = len(shape)
    last = path.rsplit("/", 1)[-1]
    none = (None,) * nd

    def model_ok(d):
        return _divisible(shape[d], sizes, "model")

    def model_at(d):
        specs = [None] * nd
        if model_ok(d):
            specs[d] = "model"
        return tuple(specs)

    # embeddings: the vocab dim
    if last == "unembed" and nd == 2:              # (d, V)
        return model_at(1)
    if last == "embed" and nd == 2:                # (V, d)
        return model_at(0)
    # MoE experts (E, d, f) / (E, f, d), stacked (R, E, ...): d_ff
    if re.search(r"ffn/w[13]$", path) and nd in (3, 4):
        return model_at(nd - 1)
    if path.endswith("ffn/w2") and nd in (3, 4):
        return model_at(nd - 2)
    if "router" in path:
        return none
    # dense FFN (d, f) / (f, d), possibly stacked (R, ...)
    if re.search(r"(ffn|shared)/w[13]$", path):
        return model_at(nd - 1)
    if re.search(r"(ffn|shared)/w2$", path):
        return model_at(nd - 2)
    # attention / linear-mixer projections
    if re.search(r"w(q|k|v|q_a|q_b|kv_a|kv_b)(/w)?$", path) or \
            re.search(r"(g_proj|i_proj|f_proj|a_proj|b_proj|w_gates)/w$",
                      path):
        return model_at(nd - 1)                    # output features
    if re.search(r"wo/w$", path):
        return model_at(nd - 2)                    # input features
    return none


def params_shardings(params, mesh, fsdp: bool = False):
    """A tree of specs like ``params`` (tensors on any device, ``meta``
    included)."""
    return tree_map_with_path(lambda path, leaf: param_pspec(
        leaf_name(path), tuple(leaf.shape), mesh, fsdp=fsdp), params)


def batch_pspec(shape, mesh, seq_axis: Optional[int] = None,
                shard_seq_over_data: bool = False) -> tuple:
    """The leading batch dim over ("pod", "data") when it divides; else,
    optionally, a sequence axis over "data" (long-context decode at batch
    1)."""
    sizes = axis_sizes(mesh)
    axes = _data_axes(sizes)
    specs = [None] * len(shape)
    if axes:
        total = math.prod(sizes[a] for a in axes)
        if shape[0] % total == 0 and shape[0] >= total:
            specs[0] = axes if len(axes) > 1 else axes[0]
    if (shard_seq_over_data and seq_axis is not None and specs[0] is None
            and "data" in sizes and shape[seq_axis] % sizes["data"] == 0):
        specs[seq_axis] = "data"
    return tuple(specs)


def batch_shardings(batch, mesh):
    return tree_map_with_path(
        lambda path, leaf: batch_pspec(tuple(leaf.shape), mesh), batch)


def cache_pspec(name: str, shape, mesh, shard_seq_over_data: bool = False,
                shard_headdim: bool = False) -> tuple:
    """A decode cache leaf (R, B, S, ...) named ``name``: the batch (axis
    1) over the data axes when it divides, else (with
    ``shard_seq_over_data``) an attention leaf's sequence over "data"; kv
    heads over "model" when they divide (else, with ``shard_headdim``, the
    head dim); a linear state's heads (axis 2) over "model"."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    specs = [None] * nd
    axes = _data_axes(sizes)
    if axes and nd >= 2:
        total = math.prod(sizes[a] for a in axes)
        if shape[1] % total == 0 and shape[1] >= total:
            specs[1] = axes if len(axes) > 1 else axes[0]
        elif (shard_seq_over_data and name in ("k", "v", "ckv", "kpe")
              and nd >= 3 and "data" in sizes
              and shape[2] % sizes["data"] == 0):
            specs[2] = "data"
    if name in ("k", "v") and nd >= 4 and _divisible(shape[3], sizes,
                                                     "model"):
        specs[3] = "model"
    elif (shard_headdim and name in ("k", "v") and nd >= 5
            and _divisible(shape[4], sizes, "model")):
        specs[4] = "model"
    if name == "state" and nd >= 3 and _divisible(shape[2], sizes, "model"):
        specs[2] = "model"
    return tuple(specs)


def cache_shardings(caches, mesh, shard_seq_over_data: bool = False,
                    shard_headdim: bool = False):
    """A tree of specs like the decode ``caches`` (R, B, S, ...)."""
    return tree_map_with_path(lambda path, leaf: cache_pspec(
        str(path[-1]), tuple(leaf.shape), mesh, shard_seq_over_data,
        shard_headdim), caches)


def to_placements(spec, device_mesh) -> tuple:
    """DTensor placements on ``device_mesh`` for ``spec`` (see the module
    docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} splits a dim in another "
                             f"order than the mesh's {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def device_shardings(specs, device_mesh):
    """A tree of specs -> the same tree of ``(device_mesh, placements)``
    pairs (what ``CheckpointManager.restore(shardings=)`` takes)."""
    def is_spec(x):
        return isinstance(x, tuple) and all(
            e is None or isinstance(e, (str, tuple)) for e in x)

    def walk(node):
        if is_spec(node):
            return (device_mesh, to_placements(node, device_mesh))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(specs)
