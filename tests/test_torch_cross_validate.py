"""The port's launcher with ``--cross-validate`` on the CPU (smoke
``kimi-linear-1t``, 12 requests in 3 batches, frozen thresholds), for
three PD regions and for the classic two-cluster shape:

  * the replay through the port's simulator agrees on every request's
    route, and no threshold moved on either side;
  * the port's ``generate_workload`` trace equals the reference's for the
    same arguments;
  * each request's live route equals what the reference's
    ``PrfaasSimulator`` decides when it replays that trace with the
    reference launcher's settings;
  * with ``--calibration`` (a file written under ``tmp_path``) the
    deployment's profile gives the reference's ``calibrated_profile``
    ``t_prefill``, and the calibrated replay agrees as well.

The reference's own ``tests/test_cross_validate.py`` runs its launcher.
"""
import json

import pytest
import torch

from repro.analysis.calibrate import calibrated_profile as jax_profile
from repro.analysis.calibrate import load_calibration as jax_load
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import (PrfaasSimulator, SimConfig, SystemConfig,
                        ThroughputModel, Workload)
from repro.core.hardware import CHIPS, AnalyticProfile
from repro.launch import serve as jserve
from repro_torch.analysis.calibrate import (calibration_from_points,
                                            calibration_to_json)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.params import init_params
from repro_torch.serving import CrossDCDeployment, DeploymentConfig

torch.set_num_threads(1)
ARCH = "kimi-linear-1t"


def _argv(k, *extra):
    return ["--arch", ARCH, "--smoke", "--requests", "12", "--batches", "3",
            "--pd-clusters", str(k), "--threshold", "64",
            "--link-gbps", "10", "--pd-mesh-gbps", "10", "--seed", "0",
            "--wire-compression", "--freeze-thresholds", "--cross-validate",
            *extra]


def _reference_replay(args, trace, ratio):
    """The reference launcher's replay (``src/repro/launch/serve.py``
    ``cross_validate``) of ``trace`` on its own simulator, with the live
    run's measured wire compression; the simulator's requests."""
    k = args.pd_clusters
    cfg = jax_smoke_config(args.arch)
    profile = AnalyticProfile(cfg, CHIPS["h200"], 8, kv_dtype_bytes=4)
    w = Workload()
    sc = SystemConfig(1, k, k, k * args.link_gbps * 1e9 / 8,
                      float(args.threshold), kv_wire_compression=ratio)
    sim = PrfaasSimulator(ThroughputModel(profile, profile, w), sc, w,
                          SimConfig(
        arrival_rate=1.0, sim_time=trace[-1][0] + args.batch_gap_s + 60.0,
        seed=args.seed, link_gbps=args.link_gbps, pd_clusters=k,
        pd_mesh_gbps=args.pd_mesh_gbps, block_tokens=16,
        decode_block_tokens=args.decode_block_size, spec_accept_rate=0.0,
        tbt_slo_s=0.0, pool_blocks=200_000, engine="event", control_dt=0.0))
    reqs = sim.inject_trace(trace)
    sim.run()
    sim.topology.run_until_idle()
    return reqs


@pytest.mark.parametrize("k", [3, 1])
def test_frozen_routes_agree_with_the_reference_replay(k):
    targs = tserve.build_parser().parse_args(_argv(k, "--device", "cpu"))
    rep = tserve.run_serve(targs)
    cv, live = rep["cross_validate"], rep["_requests"]
    assert cv["requests"] == 12
    assert cv["route_agreement"] == 1.0 and not cv["mismatches"]
    assert set(cv["thresholds"]["live"].values()) == {64.0}
    assert set(cv["thresholds"]["sim"].values()) == {64.0}
    assert cv["spec_accept_rate"] == 0.0
    routes = {r.route for r in live}
    assert "prfaas" in routes and routes - {"prfaas"}
    assert all(len(r.tokens) > 0 for r in live)

    names = ["pd"] if k == 1 else [f"pd{i}" for i in range(k)]
    shares = None if k == 1 else tuple([1.0 / k] * k)
    jargs = jserve.build_parser().parse_args(_argv(k))
    _, trace = tserve.generate_workload(targs, get_smoke_config(ARCH),
                                        names, shares)
    _, jtrace = jserve.generate_workload(jargs, jax_smoke_config(ARCH),
                                         names, shares)
    assert trace == jtrace and len(trace) == 12

    sim = _reference_replay(jargs, jtrace, cv["kv_wire_compression"])
    assert [r.decision.target for r in live] == \
        [r.decision.target for r in sim]


def test_calibrated_profile_and_replay(tmp_path):
    path = tmp_path / "calibration.json"
    calib = calibration_from_points(
        [(l, 0.6 * l / (l + 700.0)) for l in (256, 1024, 4096)],
        peak_flops=5e14, mem_bw=3e12)
    path.write_text(json.dumps({"machine": {}, "points": [],
                                "calibration": calibration_to_json(calib)}))
    cfg = get_smoke_config(ARCH)
    dep = CrossDCDeployment(
        Model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        DeploymentConfig(calibration=str(path)))
    want = jax_profile(jax_smoke_config(ARCH), jax_load(str(path)), 8)
    for l in (16, 256, 1000, 4096, 20000):
        assert dep.profile.t_prefill(l) == want.t_prefill(l), l
    rep = tserve.run_serve(tserve.build_parser().parse_args(
        _argv(3, "--device", "cpu", "--calibration", str(path))))
    assert rep["cross_validate"]["route_agreement"] == 1.0
