"""The port's sharding rules (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against the reference's, on abstract
meshes (no devices): every parameter leaf of all eleven architectures, on
the (16, 16) and (2, 16, 16) production meshes, with FSDP on and off; the
batch specs of every dry-run cell; the decode cache specs of every decode
cell; the cases of the reference's ``TestParamShardingRules``; the mesh
fingerprint, and that importing the mesh module touches no device."""
import functools
import importlib

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.launch import input_specs as jspecs
from repro_torch.configs import ARCH_BUILDERS, SHAPES, get_config
from repro_torch.distributed.sharding import (_with_fsdp, abstract_mesh,
                                              batch_pspec, cache_shardings,
                                              leaf_name, param_pspec,
                                              params_shardings)
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as specs
from repro_torch.launch.mesh import mesh_fingerprint

torch.set_num_threads(1)
MESH = abstract_mesh((16, 16), ("data", "model"))
MESH3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
JMESHES = {2: jsh.abstract_mesh((16, 16), ("data", "model")),
           3: jsh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {2: MESH, 3: MESH3}


def _jflat(tree):
    """{slash name: leaf} of a reference pytree."""
    return {jsh._leaf_name(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree, path=()):
    """{slash name: leaf} of a port tree (spec tuples are leaves)."""
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items()
                for n, x in _tflat(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {n: x for i, v in enumerate(tree)
                for n, x in _tflat(v, path + (i,)).items()}
    return {leaf_name(path): tree}


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (jspecs.params_specs(jax_config(arch)),
            specs.params_specs(get_config(arch)))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("nd", [2, 3], ids=["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCH_BUILDERS))
def test_param_specs_match_reference(arch, nd, fsdp):
    jp, tp = _params(arch)
    want = {name: tuple(jsh.param_pspec(name, x.shape, JMESHES[nd],
                                        fsdp=fsdp))
            for name, x in _jflat(jp).items()}
    got = _tflat(params_shardings(tp, MESHES[nd], fsdp=fsdp))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    # every leaf's shape as the reference's eval_shape gives it
    tl = _tflat(tp)
    assert {n: tuple(x.shape) for n, x in tl.items()} == \
        {n: tuple(x.shape) for n, x in _jflat(jp).items()}


@pytest.mark.parametrize("nd", [2, 3], ids=["single", "multi"])
def test_batch_specs_match_reference(nd):
    for arch, sname in dryrun.cell_list(include_paper_model=True):
        cfg, shape = get_config(arch), SHAPES[sname]
        batches = [specs.train_batch_specs(cfg, shape),
                   specs.prefill_batch_specs(cfg, shape),
                   {"t": specs.decode_specs(cfg, shape)[0]}]
        for batch in batches:
            for name, leaf in batch.items():
                want = tuple(jsh.batch_pspec(tuple(leaf.shape),
                                             JMESHES[nd]))
                assert batch_pspec(tuple(leaf.shape), MESHES[nd]) == want
        # long-context decode at batch 1: the sequence over "data"
        want = tuple(jsh.batch_pspec((1, shape.seq_len), JMESHES[nd],
                                     seq_axis=1, shard_seq_over_data=True))
        assert batch_pspec((1, shape.seq_len), MESHES[nd], seq_axis=1,
                           shard_seq_over_data=True) == want


@pytest.mark.parametrize("headdim", [False, True], ids=["heads", "headdim"])
@pytest.mark.parametrize("nd", [2, 3], ids=["single", "multi"])
def test_cache_specs_match_reference(nd, headdim):
    for arch, sname in dryrun.cell_list(include_paper_model=True):
        shape = SHAPES[sname]
        if shape.kind != "decode":
            continue
        B = shape.global_batch
        jc = jspecs.decode_specs(jax_config(arch), JSHAPES[sname])[1]
        tc = specs.decode_specs(get_config(arch), shape)[1]
        want = {n: tuple(s.spec) for n, s in _jflat(jsh.cache_shardings(
            jc, JMESHES[nd], shard_seq_over_data=(B == 1),
            shard_headdim=headdim)).items()}
        got = _tflat(cache_shardings(tc, MESHES[nd],
                                     shard_seq_over_data=(B == 1),
                                     shard_headdim=headdim))
        assert got == want, (arch, sname)
        assert {n: tuple(x.shape) for n, x in _tflat(tc).items()} == \
            {n: tuple(x.shape) for n, x in _jflat(jc).items()}


# the reference's TestParamShardingRules, on the port's rules
def test_ffn_tp():
    assert param_pspec("groups/0/stacked/b0/ffn/w1", (56, 6144, 16384),
                       MESH) == (None, None, "model")
    assert param_pspec("groups/0/stacked/b0/ffn/w2", (56, 16384, 6144),
                       MESH) == (None, "model", None)


def test_moe_expert_dff_tp():
    assert param_pspec("groups/0/stacked/b0/ffn/w1", (56, 8, 6144, 16384),
                       MESH) == (None, None, None, "model")
    assert param_pspec("groups/0/stacked/b0/ffn/w2", (56, 8, 16384, 6144),
                       MESH) == (None, None, "model", None)


def test_attention_projections():
    assert param_pspec("groups/0/stacked/b0/mixer/wq/w", (56, 6144, 6144),
                       MESH) == (None, None, "model")
    assert param_pspec("groups/0/stacked/b0/mixer/wo/w", (56, 6144, 6144),
                       MESH) == (None, "model", None)


def test_indivisible_replicates():
    assert param_pspec("g/mixer/wk/w", (24, 2560, 640), MESH) \
        == (None, None, "model")
    assert param_pspec("g/mixer/wk/w", (24, 2560, 200), MESH) \
        == (None, None, None)


def test_norms_replicated():
    assert param_pspec("groups/0/stacked/b0/ln1", (56, 6144), MESH) \
        == (None, None)


def test_embed_vocab_sharded():
    assert param_pspec("embed", (32768, 6144), MESH) == ("model", None)
    assert param_pspec("unembed", (6144, 32768), MESH) == (None, "model")


def test_fsdp_adds_data_axis():
    spec = param_pspec("groups/0/stacked/b0/ffn/w1", (56, 6144, 16384),
                       MESH, fsdp=True)
    assert "data" in spec and "model" in spec
    assert spec == tuple(jsh.param_pspec(
        "groups/0/stacked/b0/ffn/w1", (56, 6144, 16384), JMESHES[2],
        fsdp=True))


def test_fsdp_skips_small():
    assert _with_fsdp((None,), (8,), MESH) == (None,)
    assert jsh._with_fsdp(P(None), (8,), JMESHES[2]) == P(None)


def test_mesh_fingerprint_matches_reference():
    for nd in (2, 3):
        want = "x".join(f"{k}={v}" for k, v in JMESHES[nd].shape.items())
        assert mesh_fingerprint(MESHES[nd]) == want
    assert mesh_fingerprint(MESH) == "data=16xmodel=16"


def test_mesh_fn_no_device_state():
    """Importing the mesh module touches no device and no process group
    (the reference's ``test_mesh_fn_no_device_state``)."""
    import torch.distributed as dist

    import repro_torch.launch.mesh as m
    had_group = dist.is_initialized()
    importlib.reload(m)
    assert callable(m.make_production_mesh)
    assert dist.is_initialized() == had_group
    assert not torch.cuda.is_initialized()


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
