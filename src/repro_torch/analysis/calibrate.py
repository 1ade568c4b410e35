"""Measure this machine's prefill kernels and fit them into a
``CalibratedProfile``.

The calibrated-profile flow on the port:

    python -m repro_torch.analysis.calibrate --sweep OUT.json
        (machine peak FLOP/s + bytes/s, MFU at each prefill length, the fit)
    load_calibration(OUT.json)  ->  Calibration
    CalibratedProfile(model_cfg, calibration)  ->  core.hardware.Profile
        plugged into ThroughputModel -> Router thresholds and
        PrfaasSimulator service times derive from THIS machine.

``serving.deployment.DeploymentConfig.calibration`` and
``launch.serve --calibration`` select it on the live path;
``launch.serve --cross-validate`` prices the simulator replay with the same
profile.

The MFU saturation curve mfu(l) = mfu_max * l / (l + l_half) linearizes as
1/mfu = 1/mfu_max + (l_half/mfu_max) * (1/l), so the fit is a closed-form
least squares in (1/l, 1/mfu) space — no optimizer dependency.

The sweep (``measure_machine``, ``prefill_sweep``) is the reference's
``benchmarks/kernel_bench.py`` measurement on a named device and dtype: the
causal attention runs through ``kernels.ops.attention`` (the hand-written
flash kernel on a CUDA tensor, its plain version on a CPU one), the FFN's
two products are ``torch.matmul``.  On the card each point is timed with
CUDA events around replays of a CUDA graph of its calls, after warm-up
calls (the first flash call builds the kernel library), so the times are
the device's and not the host's dispatch; the eager times are recorded
beside them.

    PYTHONPATH=src python -m repro_torch.analysis.calibrate \
        --sweep build/calibration.json --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.analysis.calibrate OUT.json
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import (AnalyticProfile, CalibratedProfile,
                                       Calibration)

SWEEP_LENS = (256, 512, 1024, 2048, 4096)
SWEEP_LENS_SMOKE = (128, 256, 512, 1024)
SWEEP_HEADS, SWEEP_DIM, SWEEP_DMODEL = 8, 128, 1024
# bytes of the bandwidth probe's array: the reference's 2^24 (smoke 2^22)
# float32 elements, whatever the dtype, so a bf16 probe does not shrink
# into the card's 50 MB L2
PROBE_BYTES, PROBE_BYTES_SMOKE = 4 << 24, 4 << 22
GRAPH_REPLAYS = 5            # timed replays of a point's captured calls


def fit_mfu_curve(lens: Sequence[float],
                  mfus: Sequence[float]) -> Tuple[float, float]:
    """Least-squares fit of mfu(l) = mfu_max * l / (l + l_half).

    Returns (mfu_max, l_half), clamped to sane ranges (mfu_max in (0, 1],
    l_half >= 0) so a noisy sweep can't produce a pathological profile.
    """
    lens = np.asarray(lens, np.float64)
    mfus = np.asarray(mfus, np.float64)
    if lens.size < 2:
        raise ValueError("need >= 2 sweep points to fit the MFU curve")
    x = 1.0 / np.maximum(lens, 1.0)
    y = 1.0 / np.maximum(mfus, 1e-9)
    slope, intercept = np.polyfit(x, y, 1)
    intercept = max(float(intercept), 1.0)       # mfu_max <= 1
    mfu_max = 1.0 / intercept
    l_half = max(float(slope) / intercept, 0.0)
    return mfu_max, l_half


def calibration_from_points(points: Sequence[Tuple[float, float]],
                            peak_flops: float, mem_bw: float,
                            source: str = "kernel_bench") -> Calibration:
    """points: (prefill_length, measured_mfu) pairs (any order)."""
    pts = tuple(sorted((float(l), float(m)) for l, m in points))
    mfu_max, l_half = fit_mfu_curve([p[0] for p in pts],
                                    [p[1] for p in pts])
    return Calibration(peak_flops=float(peak_flops), mem_bw=float(mem_bw),
                       mfu_max=mfu_max, l_half=l_half, points=pts,
                       source=source)


def calibration_to_json(calib: Calibration) -> dict:
    return dataclasses.asdict(calib)


def calibration_from_json(obj: dict) -> Calibration:
    return Calibration(
        peak_flops=float(obj["peak_flops"]), mem_bw=float(obj["mem_bw"]),
        mfu_max=float(obj["mfu_max"]), l_half=float(obj["l_half"]),
        points=tuple((float(l), float(m)) for l, m in obj.get("points", ())),
        source=obj.get("source", "kernel_bench"))


def load_calibration(path: str) -> Calibration:
    """Read the ``calibration`` block of a sweep's JSON (or a bare
    calibration dict)."""
    with open(path) as f:
        obj = json.load(f)
    return calibration_from_json(obj.get("calibration", obj))


def calibrated_profile(model_cfg, calibration: Calibration,
                       chips_per_instance: int = 1,
                       kv_dtype_bytes: int = 2) -> CalibratedProfile:
    return CalibratedProfile(model_cfg, calibration,
                             chips_per_instance=chips_per_instance,
                             kv_dtype_bytes=kv_dtype_bytes)


# ------------------------------------------------------------ the sweep

def time_us(fn, device: torch.device, iters: int, warmup: int,
            graph: bool = True) -> float:
    """Microseconds per ``fn()`` call after ``warmup`` calls.  On a CUDA
    device ``iters`` calls are captured into one CUDA graph and its
    replays timed by events, so the host's dispatch of each call (tens of
    microseconds through the eager wrappers, more than a small kernel
    takes) is not in the time; ``graph=False`` times the same calls
    dispatched eagerly, which is what an eager caller sees.  Elsewhere
    the median of ``iters`` host-timed calls."""
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e6
    from repro_torch.kernels import build as _build

    # warm-up on a side stream: kernel builds, cudaFuncSetAttribute and
    # allocator growth happen there, outside any capture
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / iters
    g = torch.cuda.CUDAGraph()
    with _build.captured_launches() as rec, torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()                                 # the first replay uploads
    _build.LAUNCHES.update(rec)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        g.replay()
        _build.LAUNCHES.update(rec)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (GRAPH_REPLAYS * iters)


def _randn(gen, shape, device, dtype):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def measure_machine(device, dtype=torch.float32, smoke: bool = False):
    """Measured peaks of this device: dense-matmul FLOP/s of a
    (d_model, d_model) product in ``dtype`` and a streaming pass's bytes/s
    (the roofline ceilings the MFU sweep is relative to).  The bandwidth
    probe is one kernel, ``torch.mul(x, c, out=y)``, which reads ``x`` once
    and writes ``y`` once (the reference's ``x * 1.000001 + 0.5`` fuses
    into one pass under ``jit``; in eager PyTorch it would be two).
    Returns (peak_flops, mem_bw)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    iters = 50 if device.type == "cuda" else 3
    n = SWEEP_DMODEL
    a, b = _randn(gen, (n, n), device, dtype), _randn(gen, (n, n), device,
                                                      dtype)
    us = time_us(lambda: torch.matmul(a, b), device, iters, 2)
    peak_flops = 2.0 * n ** 3 / (us * 1e-6)

    m = (PROBE_BYTES_SMOKE if smoke else PROBE_BYTES) // dtype.itemsize
    x = _randn(gen, (m,), device, dtype)
    y = torch.empty_like(x)
    us = time_us(lambda: torch.mul(x, 1.000001, out=y), device, iters, 2)
    mem_bw = 2.0 * m * dtype.itemsize / (us * 1e-6)   # read + write
    return peak_flops, mem_bw


def prefill_sweep(peak_flops: float, device, dtype=torch.float32,
                  smoke: bool = False, lens: Optional[Sequence[int]] = None):
    """Achieved FLOP/s of prefill-shaped work vs prefill length -> MFU(l).

    Per length l: causal flash attention (B=1, H, l, D) plus the matching
    FFN-style matmul (l, d) @ (d, 4d) @ (4d, d) — the two shapes that
    dominate a real prefill — timed apart; MFU(l) is their combined
    achieved FLOP/s over the larger of ``peak_flops`` and the sweep's best
    (so mfu <= 1 by construction).  ``lens`` overrides the lengths.
    Returns (points, the denominator used)."""
    from repro_torch.kernels import ops

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    iters = 20 if device.type == "cuda" else 2
    B, H, D, d = 1, SWEEP_HEADS, SWEEP_DIM, SWEEP_DMODEL
    w1 = _randn(gen, (d, 4 * d), device, dtype)
    w2 = _randn(gen, (4 * d, d), device, dtype)
    points = []
    with torch.no_grad():
        for l in (lens or (SWEEP_LENS_SMOKE if smoke else SWEEP_LENS)):
            q, k, v = (_randn(gen, (B, H, l, D), device, dtype)
                       for _ in range(3))
            x = _randn(gen, (l, d), device, dtype)
            attn = lambda: ops.attention(q, k, v, causal=True)  # noqa: E731
            ffn = lambda: torch.matmul(torch.matmul(x, w1), w2)  # noqa: E731
            us_a = time_us(attn, device, iters, 2)
            us_f = time_us(ffn, device, iters, 2)
            f_attn = 2.0 * B * H * l * l * D          # qk + pv, causal half
            f_ffn = 2.0 * l * d * 4 * d * 2
            point = {"l": int(l), "attn_us": us_a, "ffn_us": us_f,
                     "flops": f_attn + f_ffn,
                     "achieved_flops": (f_attn + f_ffn)
                     / ((us_a + us_f) * 1e-6)}
            if device.type == "cuda":
                # recorded, not fitted: the same calls dispatched eagerly
                point["attn_eager_us"] = time_us(attn, device, iters, 0,
                                                 graph=False)
                point["ffn_eager_us"] = time_us(ffn, device, iters, 0,
                                                graph=False)
            points.append(point)
    peak_used = max(peak_flops, *(p["achieved_flops"] for p in points))
    for p in points:
        p["mfu"] = p["achieved_flops"] / peak_used
    return points, peak_used


def sweep(out_path: str, device="cuda", dtype=torch.float32,
          smoke: bool = False, lens: Optional[Sequence[int]] = None) -> dict:
    """Measure the machine, sweep the prefill lengths, fit, and write the
    result to ``out_path`` in the reference's ``BENCH_kernel.json`` layout
    (``machine``, ``sweep``, ``points``, ``calibration``).  Returns it."""
    device = torch.device(device)
    peak_flops, mem_bw = measure_machine(device, dtype, smoke)
    points, peak_used = prefill_sweep(peak_flops, device, dtype, smoke, lens)
    calib = calibration_from_points([(p["l"], p["mfu"]) for p in points],
                                    peak_used, mem_bw)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    out = {"machine": {"peak_flops": peak_used, "mem_bw": mem_bw,
                       "matmul_probe_flops": peak_flops, "device": name,
                       "dtype": str(dtype).replace("torch.", "")},
           "sweep": {"heads": SWEEP_HEADS, "head_dim": SWEEP_DIM,
                     "d_model": SWEEP_DMODEL, "smoke": smoke},
           "points": points,
           "calibration": calibration_to_json(calib)}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main():
    import argparse

    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bench_json", nargs="?",
                    help="a sweep's JSON to read (without --sweep)")
    ap.add_argument("--sweep", metavar="OUT",
                    help="measure this machine and write OUT first")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke lengths and probe size")
    ap.add_argument("--arch", default="kimi-linear-1t",
                    help="model config used for the T_prefill table")
    args = ap.parse_args()
    if args.sweep:
        sweep(args.sweep, args.device, getattr(torch, args.dtype),
              args.smoke)
    path = args.sweep or args.bench_json
    if path is None:
        ap.error("give a sweep's JSON or --sweep OUT")
    calib = load_calibration(path)
    print(f"machine peak: {calib.peak_flops/1e9:.1f} GFLOP/s, "
          f"{calib.mem_bw/1e9:.1f} GB/s")
    print(f"fit: mfu_max={calib.mfu_max:.4f} l_half={calib.l_half:.1f}")
    prof = calibrated_profile(get_config(args.arch), calib)
    print(f"{'l':>8} {'mfu_meas':>9} {'mfu_fit':>8} {'T_prefill':>10}")
    for l, m in calib.points:
        fit = AnalyticProfile.mfu(prof, l)
        print(f"{int(l):8d} {m:9.4f} {fit:8.4f} {prof.t_prefill(l):9.3f}s")


if __name__ == "__main__":
    main()
