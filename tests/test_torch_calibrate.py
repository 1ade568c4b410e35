"""The port's measured-kernel calibration (``repro_torch.analysis``)
against the reference's ``repro.analysis.calibrate``: the checks of
``tests/test_calibration.py`` (fit recovery, a noisy fit, two points
needed, the measured points interpolated, the JSON round trip), each held
equal to the reference's ``fit_mfu_curve`` / ``CalibratedProfile`` on the
same points; and a tiny sweep on the CPU (plain attention) whose points all
lie in (0, 1] and whose file loads back."""
import json

import numpy as np
import pytest
import torch

from repro.analysis import calibrate as jcal
from repro.configs import get_config as jax_config
from repro_torch.analysis import calibrate as tcal
from repro_torch.configs import get_config
from repro_torch.core.hardware import (CHIPS, AnalyticProfile,
                                       CalibratedProfile, Calibration)

torch.set_num_threads(1)
ARCH = "kimi-linear-1t"


def _curve(l, mfu_max, l_half):
    return mfu_max * l / (l + l_half)


def test_fit_recovers_synthetic_curve():
    lens = [128, 256, 512, 1024, 4096]
    mfus = [_curve(l, 0.55, 900.0) for l in lens]
    mfu_max, l_half = tcal.fit_mfu_curve(lens, mfus)
    assert mfu_max == pytest.approx(0.55, rel=1e-3)
    assert l_half == pytest.approx(900.0, rel=1e-2)
    assert (mfu_max, l_half) == jcal.fit_mfu_curve(lens, mfus)


def test_noisy_fit_stays_sane():
    rng = np.random.default_rng(0)
    lens = [64, 128, 256, 512, 1024]
    mfus = [_curve(l, 0.4, 300.0) * float(rng.uniform(0.8, 1.25))
            for l in lens]
    mfu_max, l_half = tcal.fit_mfu_curve(lens, mfus)
    assert 0.0 < mfu_max <= 1.0 and l_half >= 0.0
    assert (mfu_max, l_half) == jcal.fit_mfu_curve(lens, mfus)


def test_fit_needs_two_points():
    for fit in (tcal.fit_mfu_curve, jcal.fit_mfu_curve):
        with pytest.raises(ValueError):
            fit([128], [0.3])


def _points():
    return [(l, _curve(l, 0.5, 500.0)) for l in (128, 512, 2048)]


def test_profile_interpolates_measured_points():
    calib = tcal.calibration_from_points(_points(), peak_flops=100e9,
                                         mem_bw=20e9)
    jcalib = jcal.calibration_from_points(_points(), peak_flops=100e9,
                                          mem_bw=20e9)
    prof = tcal.calibrated_profile(get_config(ARCH), calib, 8)
    jprof = jcal.calibrated_profile(jax_config(ARCH), jcalib, 8)
    for l, m in calib.points:
        assert prof.mfu(l) == pytest.approx(m, rel=1e-6)
    # outside the sweep: the fitted saturation curve
    assert prof.mfu(1 << 20) == pytest.approx(calib.mfu_max, rel=0.05)
    for l in (64, 128, 300, 512, 1000, 2048, 8192, 1 << 20):
        assert prof.mfu(l) == jprof.mfu(l), l
        assert prof.t_prefill(l) == jprof.t_prefill(l), l
        assert prof.s_kv(l) == jprof.s_kv(l), l


def test_t_prefill_uses_measured_peak():
    cfg = get_config(ARCH)
    calib = tcal.calibration_from_points(_points(), peak_flops=100e9,
                                         mem_bw=20e9)
    slow = tcal.calibrated_profile(cfg, calib)
    fast = CalibratedProfile(cfg, Calibration(
        peak_flops=calib.peak_flops * 10, mem_bw=calib.mem_bw * 10,
        mfu_max=calib.mfu_max, l_half=calib.l_half, points=calib.points))
    assert slow.t_prefill(512) == pytest.approx(10 * fast.t_prefill(512),
                                                rel=1e-6)
    # S_kv is model-side and must not depend on the machine
    assert slow.s_kv(512) == AnalyticProfile(cfg, CHIPS["h200"], 8).s_kv(512)


def test_json_round_trip_reads_like_the_reference(tmp_path):
    calib = tcal.calibration_from_points(_points(), peak_flops=100e9,
                                         mem_bw=20e9)
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps(
        {"machine": {}, "calibration": tcal.calibration_to_json(calib)}))
    assert tcal.load_calibration(str(path)) == calib
    back = jcal.load_calibration(str(path))
    assert (back.peak_flops, back.mem_bw, back.mfu_max, back.l_half,
            back.points, back.source) == \
        (calib.peak_flops, calib.mem_bw, calib.mfu_max, calib.l_half,
         calib.points, calib.source)
    # bare-dict form also loads
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(tcal.calibration_to_json(calib)))
    assert tcal.load_calibration(str(bare)) == calib


def test_cpu_sweep_points_lie_in_unit_interval(tmp_path):
    """The sweep's layout (``machine``, ``sweep``, ``points``,
    ``calibration``) at three short lengths on the CPU: every MFU in
    (0, 1], the denominator the larger of the probe and the best point,
    and the file loads through both packages' ``load_calibration``."""
    out_path = tmp_path / "sweep.json"
    out = tcal.sweep(str(out_path), "cpu", smoke=True, lens=(32, 64, 128))
    pts = out["points"]
    assert [p["l"] for p in pts] == [32, 64, 128]
    assert all(0.0 < p["mfu"] <= 1.0 for p in pts)
    best = max(p["achieved_flops"] for p in pts)
    m = out["machine"]
    assert m["peak_flops"] == max(m["matmul_probe_flops"], best)
    assert m["mem_bw"] > 0 and m["device"] == "cpu"
    for p in pts:
        H, D, d, l = (tcal.SWEEP_HEADS, tcal.SWEEP_DIM, tcal.SWEEP_DMODEL,
                      p["l"])
        assert p["flops"] == 2.0 * H * l * l * D + 2.0 * l * d * 4 * d * 2
    calib = tcal.load_calibration(str(out_path))
    assert calib.points == tuple((float(p["l"]), p["mfu"]) for p in pts)
    assert jcal.load_calibration(str(out_path)).mfu_max == calib.mfu_max
