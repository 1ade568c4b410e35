"""The port's dry run against the reference's, on the CPU:

  * ``launch/input_specs.py``: every (arch x shape) cell's ``meta``
    stand-ins have the reference's ``eval_shape`` shapes and dtypes, leaf
    for leaf, and the cell list is the reference's;
  * ``analysis/counting.py``: a step's FLOPs on ``meta`` equal the same
    step's on real CPU tensors at smoke size (the MoE's even split on
    ``meta`` counts what any routing does);
  * ``analysis/counting.py``: a kernel op counts at its kernel's boundary
    only while a counter is open;
  * ``analysis/roofline.py``: ``model_flops_for`` and
    ``RooflineReport.finalize`` are the reference's arithmetic with the
    card's constants in place of the TPU's; ``as_run`` leaves out the
    lookup and the logits a step does not compute;
  * ``analysis/costfit.py``: ``basis_row`` is the reference's, the planted
    polynomial is recovered, and a fit from small ``meta`` counts predicts
    a directly counted larger cell within 1e-6;
  * ``launch/dryrun.py`` and ``analysis/report.py`` run as CLIs;
  * ``models/perf_flags.py``: the variants' flags and knobs are the
    reference's, and under ``moe_shard`` with a cap and a chunk a smoke
    batch exceeds, the port's prefill is the reference's.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import assert_trees_close, configs, drawn_params
from repro.analysis import costfit as jcostfit
from repro.analysis import roofline as jroofline
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import input_specs as jspecs
from repro.models import Model as JaxModel
from repro.models import perf_flags as jflags
from repro_torch.analysis import costfit, counting, report, roofline
from repro_torch.configs import ARCH_BUILDERS, SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as specs
from repro_torch.models import Model
from repro_torch.models.perf_flags import VARIANTS, PerfFlags
from repro_torch.params import requires_grad
from repro_torch.training import TrainConfig, init_opt_state, make_train_step

torch.set_num_threads(1)


def _flat(tree, path=""):
    """[(path, shape, dtype name)] of either framework's tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{path}/{i}")]
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name
    return [(path, tuple(tree.shape), name)]


def _ref_dryrun():
    """The reference dry run's module.  It sets ``XLA_FLAGS`` (512 host
    devices) when imported; the flag is put back at once, so the worker's
    JAX backend is left as it is."""
    import importlib
    import os
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _ref_cells(include_paper_model):
    return sorted(_ref_dryrun().cell_list(
        include_paper_model=include_paper_model))


def test_cell_list_is_the_reference():
    for paper in (False, True):
        assert sorted(dryrun.cell_list(include_paper_model=paper)) == \
            _ref_cells(paper)


@pytest.mark.parametrize("arch", list(ARCH_BUILDERS))
def test_input_specs_match_reference(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert _flat(specs.params_specs(tcfg)) == \
        _flat(jspecs.params_specs(jcfg))
    cells = [s for a, s in dryrun.cell_list(include_paper_model=True)
             if a == arch]
    assert cells
    for sname in cells:
        js, ts = JSHAPES[sname], SHAPES[sname]
        assert _flat(specs.train_batch_specs(tcfg, ts)) == \
            _flat(jspecs.train_batch_specs(jcfg, js))
        assert _flat(specs.prefill_batch_specs(tcfg, ts)) == \
            _flat(jspecs.prefill_batch_specs(jcfg, js))
        if ts.kind == "decode":
            assert _flat(specs.decode_specs(tcfg, ts)) == \
                _flat(jspecs.decode_specs(jcfg, js))


def _cpu_step(cfg, kind, B, S):
    params = drawn_params(cfg)[1]
    rng = np.random.default_rng(0)
    model = Model(cfg, remat=kind == "train")
    if kind == "train":
        tc = TrainConfig()
        step = make_train_step(model, tc)
        requires_grad(params)
        state = init_opt_state(params, tc)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32))}
        batch = specs.frontend_extras(cfg, B, S, batch)
        for k in ("patches", "frames"):
            if k in batch:
                batch[k] = torch.randn(batch[k].shape, dtype=batch[k].dtype)
        return lambda: step(params, state, batch)
    if kind == "prefill":
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))}
        batch = specs.frontend_extras(cfg, B, S, batch)
        for k in ("patches", "frames"):
            if k in batch:
                batch[k] = torch.randn(batch[k].shape, dtype=batch[k].dtype)
        return lambda: model.prefill(params, batch)
    enc = S if cfg.encoder_groups is not None else 0
    caches = model.init_cache(B, S + 64, "cpu", enc_len=enc)
    toks = torch.zeros((B,), dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32)
    return lambda: model.decode_step(params, toks, caches, lens)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["kimi-linear-1t", "mistral-nemo-12b",
                                  "zamba2-1.2b", "mixtral-8x22b",
                                  "seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_meta_flops_equal_cpu_flops(arch, kind):
    cfg = configs(arch=arch)[1]
    B, S = 2, 40
    meta = counting.count(counting.step_fn(cfg, kind, B, S))
    assert meta["flops"] == _flops(_cpu_step(cfg, kind, B, S)) > 0
    assert meta["bytes"] > 0 and meta["ops"] > 0


def test_counted_bytes_of_a_product():
    """A product reads its inputs and writes its output once; a view
    moves nothing; a gather reads the rows it gathers."""
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    idx = torch.empty((5,), dtype=torch.long, device="meta")
    c = counting.count(lambda: (a.T.T @ b, a[idx]))
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16) \
        + (5 * 8 + 2 * 5 * 32 * 4)


def test_roofline_arithmetic_matches_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.LINK_BW)
    for arch in ("mistral-nemo-12b", "kimi-linear-1t", "zamba2-1.2b"):
        jcfg, tcfg = jax_config(arch), get_config(arch)
        for sname, js in JSHAPES.items():
            ts = SHAPES[sname]
            for train in (False, True):
                assert roofline.model_flops_for(
                    tcfg, ts.kind, ts.seq_len, ts.global_batch, train) == \
                    jroofline.model_flops_for(jcfg, js.kind, js.seq_len,
                                              js.global_batch, train)
    args = dict(arch="a", shape="s", mesh="single", chips=256,
                hlo_flops=3.1e18, hlo_bytes=2.2e15, coll_bytes=7.5e13,
                model_flops=2.9e18)
    for kw in (args, {**args, "hlo_bytes": 9e17},
               {**args, "coll_bytes": 4e15}):
        got = roofline.RooflineReport(**kw).finalize().to_dict()
        want = jroofline.RooflineReport(**kw).finalize().to_dict()
        assert got == want


def test_basis_row_matches_reference():
    for kind, B, S, r, mb in (("train", 16, 4096, (3, 1), 2),
                              ("prefill", 32, 1536, (5,), 1),
                              ("decode", 128, 32768, (1, 2, 4), 1)):
        np.testing.assert_array_equal(
            costfit.basis_row(kind, B, S, r, mb),
            jcostfit.basis_row(kind, B, S, r, mb))


def test_exact_recovery_of_planted_polynomial():
    """The reference's ``test_exact_recovery_of_planted_polynomial`` on the
    port's basis and fit."""
    rng = np.random.default_rng(0)
    true = rng.uniform(1, 10, size=len(costfit.basis_row("train", 1, 1,
                                                         (1,), 1)))

    def F(B, S, r, mb):
        return float(np.dot(true, costfit.basis_row("train", B, S, r, mb)))

    plan = [(16, s, (r,), m) for s in (2048, 4096, 8192)
            for r in (1, 2) for m in (1,)]
    plan += [(32, 2048, (1,), 1), (32, 2048, (2,), 1),
             (32, 2048, (1,), 2), (32, 4096, (2,), 2)]
    A = np.stack([costfit.basis_row("train", *p) for p in plan])
    y = np.array([F(*p) for p in plan])
    c = costfit.nnls_fit(A, y)
    got = float(np.dot(c, costfit.basis_row("train", 256, 32768, (56,), 16)))
    assert abs(got / F(256, 32768, (56,), 16) - 1) < 1e-6
    np.testing.assert_allclose(c, jcostfit.nnls_fit(A, y), rtol=1e-9)


def _probe(cfg, kind, B, S, r):
    c = counting.count(counting.step_fn(costfit.scaled_config(cfg, (r,)),
                                        kind, B, S))
    return {"flops": c["flops"], "bytes": c["bytes"]}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fit_from_meta_probes_predicts_a_counted_cell(kind):
    """Counts of a smoke mistral-nemo at 1-2 layers and 1536-2560 tokens
    (batch 2, one plain attention route) predict the count of 4 layers at
    4096 tokens within 1e-6."""
    cfg = configs(arch="mistral-nemo-12b")[1]
    points = [(2, s, (r,), 1) for r in (1, 2) for s in (1536, 2048, 2560)]
    fit = costfit.fit_counts(kind, points, [
        _probe(cfg, kind, B, S, r[0]) for B, S, r, _ in points])
    big = costfit.scaled_config(cfg, (4,))
    pred = costfit.predict(fit, big, kind, 2, 4096)
    got = _probe(cfg, kind, 2, 4096, 4)
    assert pred.keys() == got.keys()
    for k in got:
        assert abs(pred[k] / got[k] - 1) < 1e-6, k


def test_dryrun_and_report_clis(tmp_path):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "mistral-nemo-12b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    rep = json.loads((out / "mistral-nemo-12b__decode_32k__single.json")
                     .read_text())
    assert rep["mesh_fingerprint"] == "data=16xmodel=16"
    assert rep["chips"] == 256 and rep["counts"]["flops"] > 0
    r = rep["roofline"]
    assert r["t_memory"] > r["t_compute"] > 0 and r["dominant"] in (
        "memory", "collective")
    assert rep["static_bytes_per_device"]["caches"] > 0
    # a second run resumes
    dryrun.main(["--arch", "mistral-nemo-12b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    cells = report.main(["--dryrun", str(out),
                         "--out", str(tmp_path / "roofline.json")])
    assert [c["shape"] for c in cells] == ["decode_32k"]
    assert cells[0]["cost_source"] == "meta-count"
    assert json.loads((tmp_path / "roofline.json").read_text()) == cells


def test_perf_variants_match_reference():
    """Each variant's MoE flags are the reference's, and its placement
    knobs are the reference launcher's; ``seqpar`` (sequence-parallel
    activations, a placement the port does not make) is refused."""
    jknobs = _ref_dryrun().VARIANT_KNOBS
    for name, var in VARIANTS.items():
        jf = jflags.VARIANTS.get(name, jflags.VARIANTS["baseline"])
        assert dataclasses.asdict(var.flags) == {
            k: getattr(jf, k) for k in dataclasses.asdict(var.flags)}
        assert (var.fsdp, var.shard_headdim) == (
            jknobs[name]["fsdp"], jknobs[name]["headdim"])
    assert set(VARIANTS) == set(jknobs) - {"seqpar"}
    assert Model(get_config("mistral-nemo-12b")).perf == PerfFlags()
    with pytest.raises(ValueError, match="seqpar"):
        dryrun.lower_cell("mistral-nemo-12b", "decode_32k", False, "seqpar")


def test_kernel_op_counted_at_its_boundary_only_while_counting():
    """Under a counter a kernel op is one op of its inputs' and output's
    bytes; the seam is put back when the counter closes."""
    q = torch.empty((1, 64, 4, 32), device="meta")
    plain = ops._run_plain
    c = counting.count(lambda: ops.attention(q, q, q))
    assert ops._run_plain is plain
    assert c["ops"] == 1 and c["bytes"] == 4 * q.numel() * 4
    assert c["flops"] > 0


@pytest.mark.parametrize("arch", ["kimi-linear-1t", "mixtral-8x22b"])
def test_moe_shard_variant_prefill_matches_reference(arch):
    """Under ``moe_shard`` with a dropless cap of 16 tokens and chunks of
    24 (a 2 x 40 batch exceeds both: three chunks, the last padded), the
    prefill takes the chunked capacity MoE in both frameworks."""
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    base_l, _ = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks)})
    with jflags.use_variant("moe_shard") as jf:
        jf.moe_dropless_max_tokens, jf.moe_chunk_tokens = 16, 24
        jl, jc = JaxModel(jcfg).prefill(jparams,
                                        {"tokens": jnp.asarray(toks)})
    perf = PerfFlags(moe_dropless_max_tokens=16, moe_chunk_tokens=24)
    tl, tc = Model(tcfg, perf=perf).prefill(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert_trees_close(jc, tc, atol=3e-4, rtol=1e-3)
    # the capacity form is not the baseline's dropless one
    assert not torch.allclose(tl, base_l, atol=1e-5)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_as_run_model_flops_are_the_counted_products(kind):
    """``model_flops_for(..., as_run=True)`` is a forward step's counted
    FLOPs without attention's scores (4 B Hq Sq Sk D a layer; the plain
    decode attention spans the whole cache) and without the norm scales,
    which are in N but do no product: the input lookup counts nothing and
    the unembedding only the rows whose logits are computed.  A train
    step's (6 N per token; the counted step also recomputes under remat)
    drops the lookup alone."""
    cfg = configs(arch="mistral-nemo-12b")[1]
    B, S = 2, 40
    train = kind == "train"
    got = roofline.model_flops_for(cfg, kind, S, B, train, as_run=True)
    full = roofline.model_flops_for(cfg, kind, S, B, train)
    vd = cfg.vocab_size * cfg.d_model
    assert not cfg.tie_embeddings
    if train:
        assert got == full - 6 * vd * B * S
        return
    counted = counting.count(counting.step_fn(cfg, kind, B, S))["flops"]
    m = cfg.groups[0].blocks[0].mixer
    sq, sk = (1, S + 64) if kind == "decode" else (S, S)
    tokens = B * sq
    scores = cfg.n_layers * 4 * B * m.q_heads * sq * sk * m.head_dim
    norms = cfg.d_model * (2 * cfg.n_layers + 1)
    assert counted == got + scores - 2 * norms * tokens
    assert got == full - 2 * vd * (2 * tokens - B)
