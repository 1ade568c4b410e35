"""The port's specs on real ``DeviceMesh``es, in one process on a fake
process group (``torch.testing``'s ``FakeStore``, no communication):

  * each placement ``to_placements`` gives has the local shard shape its
    spec implies, for every parameter leaf of three smoke architectures,
    with FSDP on and off, and a dim split over ("pod", "data") is laid out
    pod-major, as JAX lays it out;
  * each collective rule of ``analysis/roofline.py`` equals the result
    bytes that DTensor's own collective records (``CommDebugMode``) for the
    same redistribution;
  * a checkpoint written on one CPU device restores onto a (2, 2) mesh
    with the local shapes its specs give (``restore(shardings=)``);
  * ``make_local_mesh`` builds the 1 x 1 ("data", "model") mesh;
  * on 256 ranks the train launcher's ``--production-mesh`` builds the
    (16, 16) mesh and refuses to train, writing nothing.
"""
import math

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.debug import CommDebugMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.analysis import roofline
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, mesh_fingerprint
from repro_torch.params import init_params
from repro_torch.training import CheckpointManager

torch.set_num_threads(1)
NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def fake_mesh(shape, rank=0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=NAMES[len(shape)])


@pytest.fixture
def mesh22():
    yield fake_mesh((2, 2))
    dist.destroy_process_group()


class ByteCommMode(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes per
    device, by kind (the reference counts HLO result shapes so)."""

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


def _redistribute(d, placements):
    with ByteCommMode() as cm:
        d.redistribute(d.device_mesh, placements).to_local()
    return cm.nbytes


def _leaves(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    elif isinstance(tree, list):
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)
    else:
        yield tree, specs


def _local_shape(shape, spec, sizes):
    return tuple(n // math.prod(sizes[a] for a in sh.spec_axes(e))
                 for n, e in zip(shape, spec))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", ["kimi-linear-1t", "mistral-nemo-12b",
                                  "zamba2-1.2b"])
def test_placements_give_local_shapes(mesh22, arch, fsdp):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = sh.params_shardings(params, mesh22, fsdp=fsdp)
    sizes = sh.axis_sizes(mesh22)
    sharded = 0
    for leaf, spec in _leaves(params, specs):
        d = distribute_tensor(leaf, mesh22, sh.to_placements(spec, mesh22))
        want = _local_shape(leaf.shape, spec, sizes)
        assert tuple(d.to_local().shape) == want, spec
        sharded += want != tuple(leaf.shape)
    assert sharded > 0


def test_pod_data_split_is_pod_major():
    """(("pod", "data"), "model") on a (2, 2, 2) mesh: rank 5 (pod 1,
    data 0, model 1) holds row block 2 of 4 and column block 1 of 2."""
    mesh = fake_mesh((2, 2, 2), rank=5)
    try:
        spec = (("pod", "data"), "model")
        pl = sh.to_placements(spec, mesh)
        assert pl == (Shard(0), Shard(0), Shard(1))
        assert compute_local_shape_and_global_offset((8, 6), mesh, pl) \
            == ((2, 3), (4, 3))
        with pytest.raises(ValueError):
            sh.to_placements((("data", "pod"),), mesh)
    finally:
        dist.destroy_process_group()


def test_fsdp_gather_rule(mesh22):
    x = torch.randn(8, 6)
    spec = ("data", "model")
    d = distribute_tensor(x, mesh22, sh.to_placements(spec, mesh22))
    got = _redistribute(d, (Replicate(), Shard(1)))
    want = roofline.fsdp_gather_bytes(x.numel() * 4, spec,
                                      sh.axis_sizes(mesh22))
    assert got == {"all-gather": want} and want == 96


def test_fsdp_reduce_scatter_rule(mesh22):
    spec = ("data", "model")
    # a gradient: partial sums over "data", laid out over "model"
    g = DTensor.from_local(torch.randn(8, 3), mesh22, (Partial(), Shard(1)))
    got = _redistribute(g, sh.to_placements(spec, mesh22))
    want = roofline.local_shard_bytes(8 * 6 * 4, spec,
                                      sh.axis_sizes(mesh22))
    assert got == {"reduce-scatter": want} and want == 48


def test_data_parallel_allreduce_rule(mesh22):
    spec = (None, "model")               # a leaf not sharded over "data"
    g = DTensor.from_local(torch.randn(8, 3), mesh22, (Partial(), Shard(1)))
    got = _redistribute(g, sh.to_placements(spec, mesh22))
    want = roofline.local_shard_bytes(8 * 6 * 4, spec,
                                      sh.axis_sizes(mesh22))
    assert got == {"all-reduce": want} and want == 96


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tp_allreduce_rule(mesh22, dtype):
    """A row-parallel product's (rows, d) output: partial over "model",
    rows over "data"."""
    rows, d = 5, 6
    y = DTensor.from_local(torch.randn(rows, d).to(dtype), mesh22,
                           (Shard(0), Partial()))
    got = _redistribute(y, (Shard(0), Replicate()))
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert got == {"all-reduce": roofline.activation_allreduce_bytes(
        rows, d, itemsize)}


def test_logits_gather_rule(mesh22):
    rows, vocab = 3, 10
    z = DTensor.from_local(torch.randn(rows, vocab // 2), mesh22,
                           (Shard(0), Shard(1)))
    got = _redistribute(z, (Shard(0), Replicate()))
    assert got == {"all-gather": roofline.logits_gather_bytes(rows, vocab)}


def test_seq_sharded_decode_combine_rule(mesh22):
    """Batch 1 with its cache's sequence over "data": each attention
    layer's (B * H, D + 2) float32 partial outputs are all-reduced."""
    B, H, D = 1, 4, 8
    o = DTensor.from_local(torch.randn(B * H, D + 2), mesh22,
                           (Partial(), Replicate()))
    got = _redistribute(o, (Replicate(), Replicate()))
    assert got == {"all-reduce": roofline.activation_allreduce_bytes(
        B * H, D + 2, 4)}


def test_collective_plan_on_a_smoke_model():
    """The plan on a (2, 2) mesh: FSDP gathers and gradient
    reduce-scatters only in training with FSDP, TP all-reduces in every
    kind."""
    cfg = get_smoke_config("mistral-nemo-12b")
    mesh = sh.abstract_mesh((2, 2))
    train = roofline.collective_bytes(cfg, "train", 4, 64, mesh, mb=2)
    prefill = roofline.collective_bytes(cfg, "prefill", 4, 64, mesh)
    no_fsdp = roofline.collective_bytes(cfg, "train", 4, 64, mesh,
                                        fsdp=False)
    assert train["reduce-scatter"] > 0 and train["all-gather"] > 0
    assert prefill["reduce-scatter"] == 0 and prefill["all-reduce"] > 0
    assert no_fsdp["reduce-scatter"] == 0
    for c in (train, prefill, no_fsdp):
        assert c["total"] == sum(c[k] for k in roofline.COLLECTIVES)


def test_checkpoint_restores_onto_a_mesh(mesh22, tmp_path):
    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(2, params, "data=1xmodel=1", blocking=True)
    specs = sh.params_shardings(params, mesh22, fsdp=True)
    tree, manifest = mgr.restore(
        params, shardings=sh.device_shardings(specs, mesh22))
    assert manifest["step"] == 2 and manifest["mesh"] == "data=1xmodel=1"
    sizes = sh.axis_sizes(mesh22)
    for (leaf, spec), (orig, _) in zip(_leaves(tree, specs),
                                       _leaves(params, specs)):
        assert isinstance(leaf, DTensor)
        assert tuple(leaf.shape) == tuple(orig.shape)
        local = leaf.to_local()
        assert tuple(local.shape) == _local_shape(orig.shape, spec, sizes)
        # rank 0 holds the first block of every split dim
        assert torch.equal(local, orig[tuple(slice(0, n)
                                             for n in local.shape)])


def test_make_local_mesh_cpu():
    mesh = make_local_mesh("cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh_fingerprint(mesh) == "data=1xmodel=1"
    finally:
        dist.destroy_process_group()


def test_train_cli_production_mesh_builds_then_refuses(tmp_path):
    """The port has no sharded train step: the launcher builds the
    production mesh on its 256 ranks, then refuses before it draws a
    param or writes a checkpoint."""
    from repro_torch.launch import train as train_cli
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        with pytest.raises(NotImplementedError,
                           match="data=16xmodel=16 is built"):
            train_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                            "cpu", "--production-mesh",
                            "--ckpt-dir", str(tmp_path / "c")])
    finally:
        dist.destroy_process_group()
    assert not (tmp_path / "c").exists()
