"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``):
one smoke ``kimi-linear-1t`` in both frameworks, the reference's params
carried into the port, and leaf-by-leaf tree comparison."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.params import from_numpy_tree

ARCH = "kimi-linear-1t"


def with_q_rank(cfg, rank: int):
    """``cfg`` (of either framework) with every MLA block's query taking
    the low-rank ``wq_a / q_norm / wq_b`` path, as the full-width model
    does (the smoke reduction sets ``mla_q_rank`` to 0)."""
    groups = tuple(
        dataclasses.replace(g, blocks=tuple(
            dataclasses.replace(b, mixer=dataclasses.replace(
                b.mixer, mla_q_rank=rank))
            if getattr(b.mixer, "kind", "") == "mla" else b
            for b in g.blocks))
        for g in cfg.groups)
    return dataclasses.replace(cfg, groups=groups)


def configs(q_rank: int = 0):
    """(reference config, port config), float32 smoke size."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    if q_rank:
        jcfg, tcfg = with_q_rank(jcfg, q_rank), with_q_rank(tcfg, q_rank)
    assert jcfg.dtype == tcfg.dtype == "float32"
    return jcfg, tcfg


def shared_params(jcfg, seed: int = 0):
    """(reference params, the same params as port tensors on the CPU)."""
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")


def to_torch(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def flatten(tree, path=""):
    """[(path, numpy leaf)] in sorted-key order, for either framework."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, f"{path}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [(path, tree.detach().cpu().numpy())]
    return [(path, np.asarray(tree))]


def assert_trees_close(jtree, ttree, atol, rtol):
    ja, ta = flatten(jtree), flatten(ttree)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=path)


def assert_trees_identical(jtree, ttree):
    """Same paths, shapes, dtypes and bytes."""
    ja, ta = flatten(jtree), flatten(ttree)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, path
        assert a.tobytes() == b.tobytes(), path
