"""The sharded train step (``repro_torch.distributed.spmd``) on four real
``gloo`` ranks, a (2, 2) ("data", "model") mesh on the CPU, against the
reference's jitted ``make_train_step`` on one CPU device.

A module fixture starts the four ranks once (``tests/_torch_spmd_rank.py``,
which imports ``torch`` and ``repro_torch`` only; they meet through a
``file://`` store in the test's own directory, so parallel workers never
share a port) and, while they run, computes the reference's numbers; inputs
and outputs cross as ``.npz`` files.  The ranks run:

  * zamba2-1.2b (Mamba2 + the shared MHA block: rows 1 and 6),
    kimi-linear-1t (KDA, MLA and the capacity MoE with its expert ``d_ff``
    over "model": rows 1 and 5) and mistral-nemo-12b (GQA), each with FSDP
    on and off: ``train_loss`` of one batch, then two steps of two
    microbatches from the reference's params (kimi's drawn by the port's
    ``init_params``, as its one-device steps in
    ``tests/test_torch_train_moe.py`` are: on the reference's init the
    one-device port's grad norm already misses the reference's by more
    than 2e-4);
  * the launcher's ``_train`` on the mesh (mistral-nemo-12b smoke): two
    steps with one checkpoint, resumed to four, and four unbroken.

The checks:

  * loss, grad norm and lr of both steps at 1e-5 relative, and params,
    ``mu``, ``nu`` and ``master`` at 1e-4 abs / 1e-3 rel, the tolerances
    of ``tests/test_torch_train_step.py``; kimi's at those of its
    one-device steps in ``tests/test_torch_train_moe.py`` (grad norm 2e-4,
    at most 0.5 % of a leaf's elements past 1e-4 / 1e-3 and within twice
    the summed learning rate), since its KDA backward amplifies float32
    rounding on one device already, and its step-1 grad norm at 1e-2:
    step 0's Adam update flips sign wherever a gradient is within rounding
    of 0 (the 0.5 %), and on one device already, differences that small
    in step 0's params move step 1's grad norm by more than 2e-4;
  * every param and AdamW leaf keeps its rule's placements; ``step`` is
    replicated;
  * ``ce`` and the MoE's ``aux`` of one batch at 1e-5 relative: on kimi
    that shows the dispatch is the global one, not each "data" shard's;
  * each collective kind that ``analysis/roofline.collective_bytes`` plans
    for the step is issued (``CommDebugMode``, first step): FSDP's
    all-gather and reduce-scatter with FSDP, the all-reduces of TP and of
    data parallelism; the bytes of both are printed (``pytest -s``);
  * the launcher's checkpoint is written once by rank 0 under
    ``data=2xmodel=2``, restores on one CPU device to the gathered params,
    and resumed on the mesh gives the unbroken run's losses.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, drawn_params, shared_params
from repro.models import Model as JaxModel
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.analysis import roofline
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.params import init_params
from repro_torch.training import CheckpointManager, init_opt_state
from repro_torch.training import TrainConfig

torch.set_num_threads(1)
HERE = pathlib.Path(__file__).resolve().parent
ARCHS = ("zamba2-1.2b", "kimi-linear-1t", "mistral-nemo-12b")
CASES = [(a, f) for a in ARCHS for f in (True, False)]
WORLD = 4
# after the reference's numbers (the ranks take ~90 s alone, ~2.5x that
# beside five busy test workers); a collective that hangs ends sooner, at
# the ranks' own 120 s gloo timeout
JOIN_S = 300
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=20)
SEQ, BATCH, MICROBATCHES, STEPS = 32, 4, 2, 2
LAUNCHER_ARCH = "mistral-nemo-12b"
# kimi's grad norm at steps 0 and 1 (see the module docstring)
KIMI_GRAD_NORM = (2e-4, 1e-2)


def _name(arch, fsdp):
    return f"{arch}-{'fsdp' if fsdp else 'tp'}"


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_flatten_with_path(tree)}


def _params(arch):
    """The params of ``arch`` as a numpy tree: the reference's init
    (Mamba2's gates made nonzero, ``_torch_parity.shared_params``); kimi's
    drawn by the port's ``init_params`` from seed 0, as its one-device
    steps in ``tests/test_torch_train_moe.py`` are (see the module
    docstring)."""
    jcfg, tcfg = configs(arch=arch)
    if arch == "kimi-linear-1t":
        return jax.tree.map(np.asarray, drawn_params(tcfg)[0])
    return jax.tree.map(np.asarray, shared_params(jcfg)[0])


def _reference(arch, params):
    """The reference's ``train_loss`` of batch 0 and two jitted steps from
    ``params``."""
    jcfg, _ = configs(arch=arch)
    jparams = jax.tree.map(jnp.asarray, params)
    data = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH))
    model = JaxModel(jcfg, use_kernels=False, remat=True)
    _, m = jax.jit(model.train_loss)(
        jparams, {"tokens": jnp.asarray(data.batch(0)["tokens"])})
    tc = jloop.TrainConfig(microbatches=MICROBATCHES,
                           adamw=jopt.AdamWConfig(**ADAMW))
    state = jloop.init_opt_state(jparams, tc)
    step = jax.jit(jloop.make_train_step(model, tc))
    steps = []
    for i in range(STEPS):
        jparams, state, sm = step(jparams, state, {
            "tokens": jnp.asarray(data.batch(i)["tokens"])})
        steps.append({k: float(v) for k, v in sm.items()})
    trees = {"params": _flat(jax.tree.map(np.asarray, jparams))}
    for key in ("mu", "nu", "master"):
        trees[key] = _flat(jax.tree.map(np.asarray, state[key]))
    return {"ce": float(m["ce"]), "aux": float(m["aux"]), "steps": steps,
            "trees": trees}


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    job = tmp_path_factory.mktemp("spmd")
    params = {arch: _params(arch) for arch in ARCHS}
    for arch in ARCHS:
        np.savez(job / f"{arch}.npz", **_flat(params[arch]))
    with open(job / "job.json", "w") as f:
        json.dump({"steps": [{"name": _name(a, fs), "arch": a, "fsdp": fs}
                             for a, fs in CASES],
                   "launcher": {"arch": LAUNCHER_ARCH}}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [job / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "_torch_spmd_rank.py"), str(job),
                 str(r), str(WORLD)], env=env, stdout=out,
                stderr=subprocess.STDOUT))
    try:
        refs = {arch: _reference(arch, params[arch]) for arch in ARCHS}
        deadline = time.monotonic() + JOIN_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank did not finish within {JOIN_S} s of "
                            f"the reference's numbers")
        assert all(p.returncode == 0 for p in procs), "\n".join(
            log.read_text()[-3000:] for log in logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(job / "result.json") as f:
        result = json.load(f)
    return job, refs, result


def _assert_close(ref, got, atol=1e-4, rtol=1e-3):
    assert sorted(ref) == sorted(got)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], atol=atol,
                                   rtol=rtol, err_msg=path)


def _assert_mostly_close(ref, got, bound, atol=1e-4, rtol=1e-3,
                         share=5e-3):
    """``tests/test_torch_train_moe.py::assert_mostly_close`` on flat
    trees."""
    assert sorted(ref) == sorted(got)
    for path in ref:
        a, b = ref[path], got[path]
        assert a.shape == b.shape and np.isfinite(b).all(), path
        diff = np.abs(b - a)
        off = diff > atol + rtol * np.abs(a)
        assert off.mean() <= share, (path, off.mean())
        if bound is not None:
            assert diff.max() <= bound, (path, diff.max())


@pytest.mark.parametrize("arch,fsdp", CASES,
                         ids=[_name(a, f) for a, f in CASES])
def test_sharded_steps_match_reference(spmd_run, arch, fsdp):
    job, refs, result = spmd_run
    ref, got = refs[arch], result[_name(arch, fsdp)]
    kimi = arch == "kimi-linear-1t"
    for i, (rs, gs) in enumerate(zip(ref["steps"], got["steps"])):
        for key in ("loss", "grad_norm", "lr"):
            rel = KIMI_GRAD_NORM[i] if kimi and key == "grad_norm" else 1e-5
            assert gs[key] == pytest.approx(rs[key], rel=rel), (i, key)
    assert got["step"] == STEPS
    with np.load(job / f"{_name(arch, fsdp)}.out.npz") as data:
        trees = {key: {k[len(key):]: data[k] for k in data.files
                       if k.startswith(key + "[")}
                 for key in ("params", "mu", "nu", "master")}
    lr_sum = sum(rs["lr"] for rs in ref["steps"])
    for key in ("params", "mu", "nu", "master"):
        if kimi:
            _assert_mostly_close(ref["trees"][key], trees[key],
                                 2 * lr_sum if key in ("params", "master")
                                 else None)
        else:
            _assert_close(ref["trees"][key], trees[key])


@pytest.mark.parametrize("arch,fsdp", CASES,
                         ids=[_name(a, f) for a, f in CASES])
def test_placements_kept(spmd_run, arch, fsdp):
    got = spmd_run[2][_name(arch, fsdp)]
    assert got["misplaced"] == []
    assert got["step_placements"] == ["R", "R"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_are_global(spmd_run, arch):
    """``ce`` and ``aux`` of one batch on the sharded params (FSDP) against
    the reference's on one device: kimi's capacity and load-balance loss
    are those of the whole batch."""
    ref, got = spmd_run[1][arch], spmd_run[2][_name(arch, True)]
    assert got["ce"] == pytest.approx(ref["ce"], rel=1e-5)
    assert got["aux"] == pytest.approx(ref["aux"], rel=1e-5, abs=1e-12)
    if arch == "kimi-linear-1t":
        assert got["aux"] > 0


@pytest.mark.parametrize("arch,fsdp", CASES,
                         ids=[_name(a, f) for a, f in CASES])
def test_planned_collectives_are_issued(spmd_run, arch, fsdp):
    """Every kind the roofline's plan has bytes for is issued by the first
    sharded step (``CommDebugMode``, this rank's result bytes)."""
    got = spmd_run[2][_name(arch, fsdp)]["comm_bytes"]
    plan = roofline.collective_bytes(
        get_smoke_config(arch), "train", BATCH, SEQ,
        sh.abstract_mesh((2, 2)), fsdp=fsdp, mb=MICROBATCHES)
    planned = {k for k in roofline.COLLECTIVES if plan[k] > 0}
    print(f"\n{_name(arch, fsdp)} planned "
          f"{ {k: plan[k] for k in sorted(planned)} } issued {got}")
    assert planned <= set(got), (planned, got)
    if fsdp:
        assert {"all-gather", "reduce-scatter"} <= set(got)
    assert "all-reduce" in got


def _launcher_like(cfg):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return {"params": params,
            "opt": init_opt_state(params, TrainConfig())}


def test_launcher_checkpoint_restores_on_one_device(spmd_run):
    """Two steps of ``_train`` on the (2, 2) mesh write one checkpoint,
    from rank 0, under the mesh's fingerprint; restored on one CPU device
    it holds the gathered params bit for bit."""
    job, _, result = spmd_run
    launcher = result["launcher"]
    assert launcher["first"]["steps"] == 2
    assert launcher["dirs_after_first"] == ["step-00000002"]
    mgr = CheckpointManager(str(job / "ckpt_a"))
    like = _launcher_like(get_smoke_config(LAUNCHER_ARCH))
    tree, manifest = mgr.restore(like, step=2)
    assert manifest["mesh"] == "data=2xmodel=2" and manifest["step"] == 2
    with np.load(job / "launcher.out.npz") as data:
        gathered = {k: data[k] for k in data.files}
    restored = _flat(tree["params"])
    assert sorted(restored) == sorted(gathered)
    for k in gathered:
        assert restored[k].tobytes() == gathered[k].tobytes(), k
    assert int(tree["opt"]["step"]) == 2


def test_launcher_resumes_on_the_mesh(spmd_run):
    """Resumed from that checkpoint to four steps on the mesh, ``_train``
    runs steps 2 and 3 with the unbroken four-step run's losses."""
    launcher = spmd_run[2]["launcher"]
    resumed, unbroken = launcher["resumed"], launcher["unbroken"]
    assert resumed["steps"] == 2 and unbroken["steps"] == 4
    assert resumed["final_loss"] == unbroken["final_loss"]
    assert launcher["first"]["first_loss"] == unbroken["first_loss"]
    assert np.isfinite([resumed["first_loss"], resumed["final_loss"]]).all()
