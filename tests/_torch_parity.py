"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``):
one smoke architecture (``kimi-linear-1t`` unless named) in both
frameworks, the reference's params carried into the port, and
leaf-by-leaf tree comparison."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.params import from_numpy_tree, init_params

ARCH = "kimi-linear-1t"
ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def configs(q_rank: int = 0, arch: str = ARCH):
    """(reference config, port config) of ``arch``, float32 smoke size."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if q_rank:
        jcfg, tcfg = with_q_rank(jcfg, q_rank), with_q_rank(tcfg, q_rank)
    assert jcfg.dtype == tcfg.dtype == "float32"
    return jcfg, tcfg


def profile_configs(name: str):
    """(reference config, port config) of the paper's profile model
    ``name`` (``configs/profiles.py::PROFILE_MODELS``), float32 smoke
    size."""
    from repro.configs import profiles as jprofiles
    from repro.configs.base import reduce_for_smoke as jax_reduce
    from repro_torch.configs import profiles
    from repro_torch.configs.base import reduce_for_smoke
    jcfg = jax_reduce(jprofiles.PROFILE_MODELS[name]())
    tcfg = reduce_for_smoke(profiles.PROFILE_MODELS[name]())
    assert jcfg.dtype == tcfg.dtype == "float32"
    return jcfg, tcfg


def nonzero_mamba2_gates(tree, seed: int = 0):
    """The numpy param tree with every Mamba2 mixer's ``A_log``,
    ``dt_bias`` and ``D_skip`` drawn from a seed (the reference inits them
    to zeros, which leaves the skip term out and the decay softplus-only).
    Other mixers are left as they are."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "D_skip" in node:
                node = dict(node)
                for name, lo, hi in (("A_log", 0.0, 1.5),
                                     ("dt_bias", -2.0, 0.0),
                                     ("D_skip", 0.5, 1.5)):
                    x = node[name]
                    node[name] = rng.uniform(lo, hi, x.shape).astype(x.dtype)
                return node
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(tree)


def shared_params(jcfg, seed: int = 0):
    """(reference params, the same params as port tensors on the CPU).
    Mamba2 gate parameters are made nonzero (:func:`nonzero_mamba2_gates`)
    in the numpy tree both frameworks receive."""
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(seed))
    tree = nonzero_mamba2_gates(jax.tree.map(np.asarray, jparams), seed)
    return jax.tree.map(jnp.asarray, tree), from_numpy_tree(tree, "cpu")


def drawn_params(tcfg, seed: int = 0):
    """(reference params, the same params as port tensors on the CPU),
    drawn by the port's ``init_params`` from a seed: the trees have the
    same keys and shapes, and the numpy leaves go to both frameworks.
    Cheaper than :func:`shared_params` (the reference's init compiles for
    ~10 s a smoke config on one core) where the draw itself is not under
    test."""
    tparams = init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    return to_jax(tparams), tparams


def to_jax(tree):
    """A port tree (dicts and lists of tensors) as the reference's, leaf
    by leaf through numpy (bf16 bit for bit)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax(v) for v in tree]
    return jnp.asarray(flatten(tree)[0][1])


def to_torch(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def flatten(tree, path=""):
    """[(path, numpy leaf)] in sorted-key order, for either framework."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, f"{path}/{i}")]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:         # numpy's bfloat16, same bits
            return [(path, t.view(torch.int16).numpy().view(jnp.bfloat16))]
        return [(path, t.numpy())]
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


def reference_recipe(scale: str):
    """The reference's KDA:MLA training recipe config,
    ``examples/train_100m.py::hybrid_lm(scale)`` (a script, loaded by
    path)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_100m", ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hybrid_lm(scale)


def train_batch(cfg, B: int, S: int, seed: int = 0):
    """A training batch of numpy arrays, as the reference's
    ``tests/test_models_smoke.py::make_batch`` makes one: ``tokens`` (B,
    S + 1), with ``patches`` (B, num_image_patches, d_model) for a VLM and
    ``frames`` (B, S, encoder_input_dim) for an encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))
             .astype(np.int32)}
    if cfg.num_image_patches:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_groups is not None:
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.encoder_input_dim)).astype(np.float32)
    return batch


def reference_train_loss(jcfg, jparams, batch):
    """(total, ce, aux, gradients as a numpy tree) of the reference's
    ``jax.value_and_grad(Model(cfg, use_kernels=False, remat=True)
    .train_loss)`` on a numpy ``batch``."""
    fn = jax.jit(jax.value_and_grad(
        JaxModel(jcfg, use_kernels=False, remat=True).train_loss,
        has_aux=True))
    (total, m), grads = fn(jparams, jax.tree.map(jnp.asarray, batch))
    return (float(total), float(m["ce"]), float(m["aux"]),
            jax.tree.map(np.asarray, grads))


def assert_train_matches(ref, got, atol=1e-4, rtol=1e-3, of_largest=0.0):
    """The port's ``loss_and_grads`` result ``got`` against
    :func:`reference_train_loss`'s ``ref``: total, ce and aux within 1e-5
    relative, every gradient leaf finite and within ``atol`` (or
    ``of_largest`` times the leaf's largest |gradient|, where larger) /
    ``rtol``."""
    import pytest
    total, ce, aux, jgrads = ref
    loss, metrics, grads = got
    assert float(loss) == pytest.approx(total, rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(ce, rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(aux, rel=1e-5, abs=1e-7)
    ja, ta = flatten(jgrads), flatten(grads)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape and np.isfinite(b).all(), path
        np.testing.assert_allclose(
            b, a, atol=max(atol, of_largest * float(np.abs(a).max())),
            rtol=rtol, err_msg=path)
