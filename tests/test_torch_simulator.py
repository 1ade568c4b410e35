"""The port's copies of the cluster simulator (``repro_torch.core``:
``simulator``, ``vector_engine``, ``sim_cache``, ``autoscaler``) against
the reference's: the sources differ only in the package name, and the same
scenario on the same seed gives the same metrics, through the exact event
engine, the vectorized engine and a replayed arrival trace
(``inject_trace``, the ``--cross-validate`` path).  The port's vector
engine is held to the reference's vector engine, not to the event engine.
"""
import json
import pathlib

import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["simulator", "vector_engine",
                                  "sim_cache", "autoscaler"])
def test_copy_differs_only_in_package_name(name):
    ref = (ROOT / "src" / "repro" / "core" / f"{name}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_text()
    assert port.replace("repro_torch.core", "repro.core") == ref


def test_core_exports_the_reference_names():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)


def _metrics(core, **sim_kw):
    """One run of a congested three-region scenario with sessions and
    bursts; the metrics as JSON text (NaN compares equal there)."""
    w = core.Workload(session_prob=0.35, burst_factor=1.6)
    tm = core.ThroughputModel(core.paper_h200_profile(),
                              core.paper_h20_profile(), w)
    sc, lam, _ = tm.grid_search(4, 8, 100e9 / 8)
    sim = core.PrfaasSimulator(tm, sc, w, core.SimConfig(
        arrival_rate=0.8 * lam, sim_time=60.0, seed=7, link_gbps=25.0,
        pd_clusters=3, pd_mesh_gbps=8.0, **sim_kw))
    return json.dumps(sim.run(), sort_keys=True, default=str)


@pytest.mark.parametrize("engine", ["event", "vector"])
def test_run_equals_reference(engine):
    assert _metrics(tcore, engine=engine) == _metrics(jcore, engine=engine)


def _replay(core):
    """A hand-made arrival trace (sessions that grow, three homes)
    replayed through the event engine with frozen thresholds: each
    request's route and first-token time, and the run's metrics."""
    w = core.Workload()
    tm = core.ThroughputModel(core.paper_h200_profile(),
                              core.paper_h20_profile(), w)
    sc = core.SystemConfig(1, 3, 3, 3 * 10e9 / 8, 2048.0)
    trace = [(0.0, 900, 0, "pd0"), (0.0, 4000, 1, "pd1"),
             (0.0, 120, 2, "pd2"), (30.0, 960, 0, "pd0"),
             (30.0, 9000, 3, "pd2"), (60.0, 4050, 1, "pd1"),
             (60.0, 3000, 4, "pd0"), (90.0, 1010, 0, "pd0")]
    sim = core.PrfaasSimulator(tm, sc, w, core.SimConfig(
        arrival_rate=1.0, sim_time=200.0, seed=3, link_gbps=10.0,
        pd_clusters=3, pd_mesh_gbps=10.0, block_tokens=16,
        decode_block_tokens=8, pool_blocks=200_000, engine="event",
        control_dt=0.0))
    reqs = sim.inject_trace(trace)
    metrics = sim.run()
    sim.topology.run_until_idle()
    return ([(r.decision.target, r.first_token) for r in reqs],
            json.dumps(metrics, sort_keys=True, default=str),
            sim.topology.sent_bytes)


def test_inject_trace_replay_equals_reference():
    routes, metrics, sent = _replay(tcore)
    assert (routes, metrics, sent) == _replay(jcore)
    assert {t for t, _ in routes} == {"prfaas", "pd0", "pd1", "pd2"}
