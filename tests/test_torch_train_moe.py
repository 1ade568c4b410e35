"""The port's training MoE against the reference's, on the CPU, float32:

  * ``moe_capacity`` over a sweep of token counts;
  * the capacity ``apply_moe`` (the reference's ``_apply_moe_flat`` without
    ``dropless``) at the smoke specs of llama4-scout (top-1 + a shared
    expert), mixtral-8x22b (top-2) and kimi-linear-1t (top-8 + shared),
    and at mixtral's with ``capacity_factor`` 0.5, where pairs are
    dropped;
  * ``moe_aux_loss``;
  * ``Model.train_loss`` (total, ce, aux) and every gradient leaf against
    ``jax.value_and_grad`` on the kimi, llama4 and mixtral smoke configs;
  * two ``make_train_step`` steps of kimi smoke with two microbatches
    against the reference's jitted step;
  * every architecture's ``train_loss`` at smoke size: finite, with
    non-zero gradients (the reference's ``test_smoke_train_step``).

The same numpy weights and inputs go to both frameworks.  Tolerances: MoE
outputs 1e-5 abs / rel (float32 products summed in other orders), the aux
loss 1e-6; the loss 1e-5 relative and gradient leaves 1e-4 abs / 1e-3
rel, kimi's 1e-3 of the leaf's largest |gradient| / 1e-3 rel (its KDA
mixers' delta-rule backward amplifies float32 rounding to 2e-4-1e-3 of a
leaf's largest, as the recipe's in ``tests/test_torch_train_hybrid.py``);
the train steps' loss and lr 1e-5 relative, their global gradient norm
2e-4 (it sums those KDA leaves: 3e-5 at step 0, 1e-4 at step 1), and
params, moments and master weights 1e-4 abs / 1e-3 rel but for at most
0.5 % of a leaf's elements, whose gradient rounding flipped the sign of
an Adam update (params within twice the steps' summed learning rate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_train_matches, configs, drawn_params,
                           flatten, reference_train_loss, train_batch)
from repro.models import Model as JaxModel
from repro.models import layers as jlayers
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import ARCH_BUILDERS, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import layers as tlayers
from repro_torch.models.tree import tree_leaves
from repro_torch.params import from_numpy_tree, requires_grad
from repro_torch.training import loss_and_grads
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
MOE_ARCHS = ("llama4-scout-17b-a16e", "mixtral-8x22b", "kimi-linear-1t")


def moe_specs(arch):
    """(reference FFNSpec, port FFNSpec) of ``arch``'s first MoE block at
    smoke size."""
    jcfg, tcfg = configs(arch=arch)
    return tuple(next(b.ffn for g in c.groups for b in g.blocks
                      if b.ffn.kind == "moe") for c in (jcfg, tcfg))


def moe_params(spec, d, seed=0):
    """A numpy MoE layer: float32 router, experts and the shared FFN."""
    rng = np.random.default_rng(seed)
    E, F = spec.num_experts, spec.d_ff

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    p = {"router": w(d, E), "w1": w(E, d, F), "w2": w(E, F, d),
         "w3": w(E, d, F)}
    if spec.shared_experts:
        Fs = F * spec.shared_experts
        p["shared"] = {"w1": w(d, Fs), "w2": w(Fs, d), "w3": w(d, Fs)}
    return p


@pytest.mark.parametrize("T", [1, 5, 8, 33, 100, 512, 1000, 4096, 8192])
def test_moe_capacity_matches_reference(T):
    for arch in MOE_ARCHS:
        jspec, tspec = moe_specs(arch)
        for cf in (0.5, 1.25, 2.0):
            assert tlayers.moe_capacity(
                T, dataclasses.replace(tspec, capacity_factor=cf)) == \
                jlayers.moe_capacity(
                    T, dataclasses.replace(jspec, capacity_factor=cf))


@pytest.mark.parametrize("arch,capacity_factor,drops", [
    ("llama4-scout-17b-a16e", None, False),
    ("mixtral-8x22b", None, False),
    ("kimi-linear-1t", None, False),
    ("mixtral-8x22b", 0.5, True),
    ("kimi-linear-1t", 0.5, True),
])
def test_apply_moe_matches_reference(arch, capacity_factor, drops):
    jspec, tspec = moe_specs(arch)
    if capacity_factor is not None:
        jspec = dataclasses.replace(jspec, capacity_factor=capacity_factor)
        tspec = dataclasses.replace(tspec, capacity_factor=capacity_factor)
    d = configs(arch=arch)[1].d_model
    p = moe_params(tspec, d)
    x = np.random.default_rng(1).standard_normal((2, 40, d)).astype(
        np.float32)
    want = np.asarray(jlayers.apply_moe(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), jspec))
    tp, tx = from_numpy_tree(p, "cpu"), torch.from_numpy(x)
    got = tlayers.apply_moe(tp, tx, tspec)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    se = tlayers._sorted_pairs(*tlayers._route(tp, tx.reshape(-1, d),
                                               tspec.top_k))[1]
    keep, _ = tlayers.capacity_plan(se, 80, tspec)
    assert bool((~keep).any()) == drops
    # dropping differs from the dropless form
    dropless = tlayers.apply_moe_dropless(tp, tx, tspec)
    assert (not torch.allclose(got, dropless, atol=1e-5)) == drops


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    jspec, tspec = moe_specs(arch)
    d = configs(arch=arch)[1].d_model
    p = moe_params(tspec, d, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 40, d)).astype(
        np.float32)
    want = float(jlayers.moe_aux_loss(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), jspec))
    got = tlayers.moe_aux_loss(from_numpy_tree(p, "cpu"),
                               torch.from_numpy(x), tspec)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    batch = train_batch(tcfg, 2, 48)
    ref = reference_train_loss(jcfg, jparams, batch)
    got = loss_and_grads(Model(tcfg, remat=True), requires_grad(tparams),
                         batch)
    assert ref[2] > 0
    # kimi's KDA mixers backpropagate through the delta rule's Neumann
    # inverse, which amplifies float32 rounding to ~1e-3 of a leaf's
    # largest gradient (as for the recipe, ``test_torch_train_hybrid.py``)
    assert_train_matches(ref, got, of_largest=1e-3 if arch ==
                         "kimi-linear-1t" else 0.0)


def test_train_steps_match_reference():
    """Two steps of the train step, two microbatches each, on kimi smoke,
    against the reference's jitted step: each framework computes its own
    gradients (the capacity MoE and its aux loss in both)."""
    jcfg, tcfg = configs()
    jparams, tparams = drawn_params(tcfg)
    # the port updates its params in place: the reference's (asynchronous)
    # step must not read a buffer it shares with them
    jparams = jax.tree.map(jnp.copy, jparams)
    kw = dict(microbatches=2)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jtc = jloop.TrainConfig(adamw=jopt.AdamWConfig(**adam), **kw)
    ttc = tloop.TrainConfig(adamw=topt.AdamWConfig(**adam), **kw)
    data = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4))
    jstate = jloop.init_opt_state(jparams, jtc)
    tparams = requires_grad(tparams)
    tstate = tloop.init_opt_state(tparams, ttc)
    jstep = jax.jit(jloop.make_train_step(
        JaxModel(jcfg, use_kernels=False, remat=True), jtc))
    tstep = tloop.make_train_step(Model(tcfg, remat=True), ttc)
    for step in range(2):
        batch = data.batch(step)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(batch["tokens"])})
        tparams, tstate, tm = tstep(tparams, tstate, batch)
        # the global norm sums the KDA leaves' gradients, which differ at
        # up to 1e-3 of their largest (see the module docstring)
        for key, rel in (("loss", 1e-5), ("grad_norm", 2e-4), ("lr", 1e-5)):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=rel)
    lr_sum = sum(float(topt.lr_at(ttc.adamw, s)) for s in range(2))
    for jtree, ttree, bound in ((jparams, tparams, 2 * lr_sum),
                                (jstate["master"], tstate["master"],
                                 2 * lr_sum),
                                (jstate["mu"], tstate["mu"], None),
                                (jstate["nu"], tstate["nu"], None)):
        assert_mostly_close(jax.tree.map(np.asarray, jtree), ttree, bound)


def assert_mostly_close(jtree, ttree, bound, atol=1e-4, rtol=1e-3,
                        share=5e-3):
    """Every leaf within ``atol`` / ``rtol`` but for at most ``share`` of
    its elements, and those within ``bound`` where given.  An element
    whose gradient is within float32 rounding of 0 can take Adam's
    normalised update either way: up to ``lr`` a step, twice that apart
    (measured: 0.02-0.2 % of a leaf's elements, 1.6e-3 at most, against
    2 x 1.5e-3)."""
    ja, ta = flatten(jtree), flatten(ttree)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape and np.isfinite(b).all(), path
        diff = np.abs(b - a)
        off = diff > atol + rtol * np.abs(a)
        assert off.mean() <= share, (path, off.mean())
        if bound is not None:
            assert diff.max() <= bound, (path, diff.max())


@pytest.mark.parametrize("arch", sorted(ARCH_BUILDERS))
def test_smoke_train_step(arch):
    """Every architecture trains at smoke size: a finite scalar loss and
    non-zero, finite gradients (the reference's ``test_smoke_train_step``
    on the port)."""
    from repro_torch.params import init_params
    cfg = get_smoke_config(arch)
    params = requires_grad(init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu"))
    loss, metrics, grads = loss_and_grads(Model(cfg), params,
                                          train_batch(cfg, 2, 32))
    assert loss.shape == () and torch.isfinite(loss)
    assert torch.isfinite(metrics["aux"])
    moe = any(b.ffn.kind == "moe" for g in cfg.groups for b in g.blocks)
    assert (float(metrics["aux"]) > 0) == moe
    gn = sum(float(g.abs().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0
