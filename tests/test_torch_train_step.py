"""The port's optimizer, gradient compression, synthetic data and train
step against the reference's, on the CPU, with the same trees handed to
both as numpy:

  * ``SyntheticLM`` batches (and shards) byte-identical;
  * ``lr_at`` over a warmup + cosine schedule;
  * the set of leaves AdamW decays, by path, on zamba2 and on the
    KDA:MLA recipe;
  * one ``apply_updates`` on shared gradients (params in float32 and
    bfloat16, ``mu``, ``nu``, ``master``, ``grad_norm``, ``lr``);
  * the int8 error-feedback compression of shared gradients, byte for byte;
  * two steps of ``make_train_step`` on zamba2 (smoke size) with two
    microbatches (with compressed gradients:
    ``tests/test_torch_train_compress.py``).

Tolerances: the learning rate 1e-6 relative (float32 cosines); one AdamW
update 1e-6 abs / 1e-5 rel (float32 sums in another order for the norm);
bfloat16 params must round to the same bits or to a neighbour (the master
weights differ by float32 rounding).  Train steps where each framework
computes its own gradients: loss, grad norm and lr 1e-5 relative, params,
moments and master weights 1e-4 abs / 1e-3 rel: the gradients differ at
~1e-5 of their scale, and Adam's normalised update turns that into up to
~5 % of a step (lr = 1e-3) for an element whose gradient is near eps
(1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, configs, flatten,
                           reference_recipe, shared_params)
from repro.distributed import collectives as jcoll
from repro.models import Model as JaxModel
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.distributed import collectives as tcoll
from repro_torch.examples.train_100m import hybrid_lm
from repro_torch.models import Model
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.params import from_numpy_tree, init_params, requires_grad
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _random_like(tree, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (scale * r.standard_normal(x.shape))
                        .astype(np.float32), tree)


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 48, 8),
                                                  (3, 4096, 128, 4)])
def test_synthetic_batches_byte_identical(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = jdata.SyntheticLM(jdata.DataConfig(**kw))
    port = tdata.SyntheticLM(tdata.DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ref.batch(step)["tokens"], port.batch(step)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    a, b = ref.shard(5, 1, 2)["tokens"], port.shard(5, 1, 2)["tokens"]
    assert a.tobytes() == b.tobytes()


def test_lr_schedule_matches_reference():
    for cfg_kw in (dict(lr=1e-3, warmup_steps=4, total_steps=20),
                   dict(lr=3e-4, warmup_steps=2, total_steps=4)):
        jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
        for step in range(0, 25):
            want = float(jopt.lr_at(jcfg, jnp.int32(step)))
            got = float(topt.lr_at(tcfg, torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6), (cfg_kw, step)


def _reference_decayed(jcfg):
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]
            if jopt._decay_mask(p)]


@pytest.mark.parametrize("which", ["zamba2-1.2b", "kimi-linear-1t",
                                   "hybrid-8m"])
def test_decayed_leaves_match_reference(which):
    """AdamW decays the same leaves, named the same way (``keystr``)."""
    if which == "hybrid-8m":
        jcfg, tcfg = reference_recipe("8m"), hybrid_lm("8m")
    else:
        jcfg, tcfg = configs(arch=which)
    tree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = [p for p, _ in tree_flatten_with_path(tree) if topt._decay_mask(p)]
    want = _reference_decayed(jcfg)
    assert got == want
    assert 0 < len(got) < len(tree_flatten_with_path(tree))


def _small_tree(dtype):
    r = np.random.default_rng(1)

    def w(*shape):
        return (0.1 * r.standard_normal(shape)).astype(dtype)

    return {"embed": w(16, 8), "final_norm": np.ones(8, np.float32),
            "groups": [{"shared": {}, "stacked": {"b0": {
                "ln1": np.ones((2, 8), np.float32),
                "mixer": {"wq": {"w": w(2, 8, 8)},
                          "A_log": w(2, 4).astype(np.float32)}}}}]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype):
    """One AdamW step on shared params, gradients and a state one step
    in, in each framework."""
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    tree = _small_tree(np_dtype)
    grads = _random_like(tree, 2)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=0.5)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=0.5)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init_state(jparams)
    jstate = {**jstate, "step": jnp.int32(1),
              "mu": _random_like(tree, 3, 0.1), "nu": jax.tree.map(
                  np.abs, _random_like(tree, 4, 0.01))}
    tstate = {"step": torch.tensor(1, dtype=torch.int32),
              **{k: from_numpy_tree(_numpy(jstate[k]), "cpu")
                 for k in ("mu", "nu", "master")}}
    jstate = jax.tree.map(jnp.asarray, jstate)
    jp, js, jm = jopt.apply_updates(jparams, jax.tree.map(jnp.asarray, grads),
                                    jstate, jcfg)
    tp, ts, tm = topt.apply_updates(from_numpy_tree(tree, "cpu"),
                                    from_numpy_tree(grads, "cpu"), tstate,
                                    tcfg)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for k in ("mu", "nu", "master"):
        assert_trees_close(_numpy(js[k]), ts[k], atol=1e-6, rtol=1e-5)
    for (path, a), (_, b) in zip(flatten(_numpy(jp)), flatten(tp)):
        assert a.dtype.itemsize == b.dtype.itemsize, path
        if dtype == "bfloat16" and a.dtype.itemsize == 2:
            bits = np.abs(a.view(np.int16).astype(np.int32)
                          - b.view(np.int16).astype(np.int32))
            assert bits.max() <= 1, path
        else:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-5,
                                       err_msg=path)


def test_compress_grads_byte_identical():
    """The same gradients and residuals compress to the same int8 bytes
    and scale, the same dequantized gradients and the same residuals."""
    shapes = {**_small_tree(np.float32), "unembed": np.zeros((300, 77))}
    grads, res = _random_like(shapes, 5, 1e-3), _random_like(shapes, 6, 1e-5)
    for (_, g), (_, r) in zip(flatten(grads), flatten(res)):
        jq, js = jcoll.quantize_int8(jnp.asarray(g + r))
        tq, ts = tcoll.quantize_int8(torch.from_numpy(g + r))
        assert tq.dtype == torch.int8
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jg, jr = jcoll.compress_grads_with_feedback(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    tg, tr = tcoll.compress_grads_with_feedback(
        from_numpy_tree(grads, "cpu"), from_numpy_tree(res, "cpu"))
    for a, b in ((jg, tg), (jr, tr)):
        for (path, x), (_, y) in zip(flatten(_numpy(a)), flatten(b)):
            assert x.tobytes() == y.tobytes(), path


def _step_setup(compress):
    jcfg, tcfg = configs(arch="zamba2-1.2b")
    jparams, _ = shared_params(jcfg)
    kw = dict(microbatches=2, compress_grads=compress)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jtc = jloop.TrainConfig(adamw=jopt.AdamWConfig(**adam), **kw)
    ttc = tloop.TrainConfig(adamw=topt.AdamWConfig(**adam), **kw)
    data = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4))
    tparams = requires_grad(from_numpy_tree(_numpy(jparams), "cpu"))
    return (jcfg, jparams, jtc, jloop.init_opt_state(jparams, jtc),
            Model(tcfg, remat=True), tparams, ttc,
            tloop.init_opt_state(tparams, ttc), data)


def test_train_steps_match_reference():
    """Two steps of the train step, two microbatches each (float32
    gradient sums), on zamba2 smoke, against the reference's jitted step:
    each framework computes its own gradients."""
    (jcfg, jparams, jtc, jstate, tmodel, tparams, ttc, tstate,
     data) = _step_setup(False)
    jstep = jax.jit(jloop.make_train_step(
        JaxModel(jcfg, use_kernels=False, remat=True), jtc))
    tstep = tloop.make_train_step(tmodel, ttc)
    for step in range(2):
        batch = data.batch(step)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(batch["tokens"])})
        tparams, tstate, tm = tstep(tparams, tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
    assert int(tstate["step"]) == 2
    assert_trees_close(_numpy(jparams), tparams, atol=1e-4, rtol=1e-3)
    for key in ("mu", "nu", "master"):
        assert_trees_close(_numpy(jstate[key]), tstate[key], atol=1e-4,
                           rtol=1e-3)
