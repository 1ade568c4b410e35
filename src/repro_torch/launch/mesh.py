"""Production and local device meshes (``src/repro/launch/mesh.py``).

Single-pod: (16, 16) -> ("data", "model")          = 256 GPUs
Multi-pod : (2, 16, 16) -> ("pod", "data", "model") = 512 GPUs

Functions only: importing this module touches no device and no process
group.  :func:`make_production_mesh` builds its mesh on the process group
the caller launched (``torchrun`` or ``init_process_group``), one rank
per GPU.
"""
from __future__ import annotations

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh`` over the launched process group.
    Raises ``RuntimeError`` when there is no group or its world size is
    not 256 (512 with ``multi_pod``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(names, shape))} needs a process "
            f"group of {need} ranks, one per GPU; this process has "
            f"{have or 'no group'} (launch with torchrun --nproc-per-node "
            f"on every host)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_fingerprint(mesh) -> str:
    """``data=16xmodel=16``: the axis sizes in order, as the reference's."""
    from repro_torch.distributed.sharding import axis_sizes
    return "x".join(f"{k}={v}" for k, v in axis_sizes(mesh).items())


def make_local_mesh(device="cuda"):
    """A 1 x 1 ("data", "model") ``DeviceMesh`` on this process's one
    device, for a caller that places params as DTensors there (e.g.
    ``CheckpointManager.restore(shardings=)``); a fingerprint alone needs
    only ``distributed.sharding.abstract_mesh((1, 1))``.  With no process
    group yet, starts a world-1 group on an in-memory store (``nccl`` for
    CUDA, ``gloo`` otherwise)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
