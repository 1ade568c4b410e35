"""Hardware model: chip classes, instance profiles, T_prefill / S_kv sources.

Three profile kinds feed the throughput model (paper Eq. 1):
  * ``PaperProfile`` — the paper's measured Table 5 for the internal 1T
    hybrid on an 8xH200 instance, with log-log (power-law) interpolation.
    This is the *faithful-reproduction* input: feeding it into our
    throughput model must reproduce Table 6 (validated in benchmarks).
  * ``AnalyticProfile`` — derived from any ``ModelConfig`` + chip spec via a
    FLOPs/bytes roofline with an MFU(l) saturation curve; used for the
    assigned architectures where no measured profile exists.
  * ``CalibratedProfile`` — the same roofline, but the chip peak and the
    MFU(l) curve are MEASURED on this machine by the kernel sweep in
    ``benchmarks.kernel_bench`` and fitted by ``analysis.calibrate``:
    routing thresholds and simulated service times then derive from the
    hardware the engines actually run on, not a named chip's datasheet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from repro_torch.configs.base import AttentionSpec, ModelConfig

MIB = 2 ** 20


@dataclass(frozen=True)
class ChipSpec:
    name: str
    flops_bf16: float          # peak FLOP/s
    hbm_bw: float              # bytes/s
    hbm_bytes: float

    def prefill_time(self, flops: float, bytes_moved: float,
                     mfu: float = 0.5, chips: int = 1) -> float:
        return max(flops / (chips * self.flops_bf16 * mfu),
                   bytes_moved / (chips * self.hbm_bw * 0.8))


CHIPS = {
    "h200": ChipSpec("h200", 989e12, 4.8e12, 141e9),
    "h20": ChipSpec("h20", 148e12, 4.0e12, 96e9),
    "tpu-v5e": ChipSpec("tpu-v5e", 197e12, 819e9, 16e9),
    "tpu-v5p": ChipSpec("tpu-v5p", 459e12, 2.77e12, 95e9),
}


def _loglog_interp(xs, ys, x):
    """Piecewise power-law interpolation (extrapolates end slopes)."""
    lx = [math.log(v) for v in xs]
    ly = [math.log(v) for v in ys]
    q = math.log(x)
    if q <= lx[0]:
        i = 0
    elif q >= lx[-1]:
        i = len(lx) - 2
    else:
        i = max(j for j in range(len(lx) - 1) if lx[j] <= q)
    slope = (ly[i + 1] - ly[i]) / (lx[i + 1] - lx[i])
    return math.exp(ly[i] + slope * (q - lx[i]))


def _loglog_interp_vec(xs, ys, x: np.ndarray) -> np.ndarray:
    """Vectorized ``_loglog_interp``: same piecewise power law (including
    end-slope extrapolation) over an array of query lengths.  Agrees with
    the scalar version to float rounding — the vectorized simulator engine
    must charge the same bytes/service times as the event engine."""
    lx = np.log(np.asarray(xs, np.float64))
    ly = np.log(np.asarray(ys, np.float64))
    q = np.log(np.maximum(np.asarray(x, np.float64), 1e-300))
    # segment index per query, clipped so end segments extrapolate
    i = np.clip(np.searchsorted(lx, q, side="right") - 1, 0, len(lx) - 2)
    slope = (ly[i + 1] - ly[i]) / (lx[i + 1] - lx[i])
    return np.exp(ly[i] + slope * (q - lx[i]))


class Profile:
    """Per-instance profile: S_kv(l) bytes, T_prefill(l) seconds."""

    def s_kv(self, l: int) -> float:
        raise NotImplementedError

    def t_prefill(self, l: int) -> float:
        raise NotImplementedError

    def kv_throughput(self, l: int) -> float:
        """Paper Eq. 1: Φ_kv(l) in bytes/s."""
        return self.s_kv(l) / self.t_prefill(l)

    # -- batched evaluation (vectorized simulator engine) -------------------
    # Subclasses with closed-form curves override these with pure-numpy
    # versions; the fallback loops over the scalar methods so ANY profile
    # stays usable from the SoA fast path (just without the speedup).
    def s_kv_vec(self, lens: np.ndarray) -> np.ndarray:
        return np.array([self.s_kv(int(l)) for l in np.asarray(lens).ravel()],
                        np.float64).reshape(np.shape(lens))

    def t_prefill_vec(self, lens: np.ndarray) -> np.ndarray:
        return np.array([self.t_prefill(int(l))
                         for l in np.asarray(lens).ravel()],
                        np.float64).reshape(np.shape(lens))


# Paper Table 5 (1T hybrid model, 8xH200, in-house vLLM).
PAPER_TABLE5_LENS = (1024, 8192, 32768, 131072)
PAPER_TABLE5_SKV_MIB = (190.8, 308.9, 701.3, 2316.3)
PAPER_TABLE5_TPREFILL = (0.44, 0.72, 1.84, 7.40)


class PaperProfile(Profile):
    """The paper's measured Table 5 with power-law interpolation.

    ``slowdown(l)`` maps the 8xH200 profile onto other hardware; the H20
    factor is calibrated from the paper's own Table 6 operating points
    (T_H20(10.2K)=1.83s, T_H20(27.3K)=4.27s -> kappa(l) ~= 2.19*(l/10222)^0.188).
    """

    def __init__(self, slowdown_base: float = 1.0, slowdown_exp: float = 0.0,
                 slowdown_ref_len: float = 10222.0):
        self.slowdown_base = slowdown_base
        self.slowdown_exp = slowdown_exp
        self.slowdown_ref_len = slowdown_ref_len

    def s_kv(self, l: int) -> float:
        return _loglog_interp(PAPER_TABLE5_LENS,
                              [v * MIB for v in PAPER_TABLE5_SKV_MIB], l)

    def t_prefill(self, l: int) -> float:
        base = _loglog_interp(PAPER_TABLE5_LENS, PAPER_TABLE5_TPREFILL, l)
        kappa = self.slowdown_base * (l / self.slowdown_ref_len) ** self.slowdown_exp
        return base * kappa

    def s_kv_vec(self, lens: np.ndarray) -> np.ndarray:
        return _loglog_interp_vec(
            PAPER_TABLE5_LENS, [v * MIB for v in PAPER_TABLE5_SKV_MIB], lens)

    def t_prefill_vec(self, lens: np.ndarray) -> np.ndarray:
        l = np.asarray(lens, np.float64)
        base = _loglog_interp_vec(PAPER_TABLE5_LENS, PAPER_TABLE5_TPREFILL, l)
        kappa = self.slowdown_base * (
            l / self.slowdown_ref_len) ** self.slowdown_exp
        return base * kappa


def paper_h200_profile() -> PaperProfile:
    return PaperProfile()


def paper_h20_profile() -> PaperProfile:
    # calibrated vs Table 6 (see module docstring)
    return PaperProfile(slowdown_base=2.187, slowdown_exp=0.1876,
                        slowdown_ref_len=10222.0)


class AnalyticProfile(Profile):
    """Roofline-derived profile for an arbitrary ModelConfig.

    T_prefill(l) = max(compute, HBM) with a length-dependent MFU saturation
    curve mfu(l) = mfu_max * l / (l + l_half): short prefills are launch/
    memory-bound (low utilization), long prefills approach peak — matching
    the shape of the paper's Figure 2 / Table 5.
    """

    def __init__(self, cfg: ModelConfig, chip: ChipSpec, chips_per_instance: int,
                 mfu_max: float = 0.55, l_half: float = 2048.0,
                 kv_dtype_bytes: int = 2):
        self.cfg = cfg
        self.chip = chip
        self.chips = chips_per_instance
        self.mfu_max = mfu_max
        self.l_half = l_half
        self.kv_dtype_bytes = kv_dtype_bytes

    def s_kv(self, l: int) -> float:
        return float(self.cfg.kv_cache_bytes(l, self.kv_dtype_bytes))

    def mfu(self, l: float) -> float:
        """Length-dependent MFU saturation curve (overridable: measured)."""
        return self.mfu_max * l / (l + self.l_half)

    def prefill_flops(self, l: int) -> float:
        """2*N_active*l matmul + attention quadratic terms."""
        cfg = self.cfg
        f = 2.0 * cfg.active_param_count() * l
        for *_, b in cfg.iter_blocks():
            m = b.mixer
            if isinstance(m, AttentionSpec):
                eff = min(l, m.window) if m.window else l
                # q@k^T + p@v over causal half
                f += 2.0 * 2.0 * m.q_heads * m.head_dim * l * eff / 2.0
            else:                            # linear mixer: chunked scan
                f += 2.0 * 2.0 * m.heads * m.key_dim * m.value_dim * l
        return f

    def prefill_bytes(self, l: int) -> float:
        cfg = self.cfg
        w = cfg.active_param_count() * 2.0   # weights once (big-batch amortized)
        act = 12.0 * l * cfg.d_model * cfg.n_layers * 2.0
        return w + act

    def t_prefill(self, l: int) -> float:
        mfu = self.mfu(l)
        t_c = self.prefill_flops(l) / (self.chips * self.chip.flops_bf16 * mfu)
        t_m = self.prefill_bytes(l) / (self.chips * self.chip.hbm_bw * 0.8)
        return max(t_c, t_m)


@dataclass(frozen=True)
class Calibration:
    """Measured-machine kernel calibration (see ``analysis.calibrate``).

    ``points`` are (prefill_length, measured_mfu) pairs from the kernel
    sweep; ``mfu_max``/``l_half`` are the fitted saturation-curve params
    used outside the measured range.  ``peak_flops``/``mem_bw`` are this
    machine's measured peaks (the "chip" the MFU is relative to).
    """
    peak_flops: float
    mem_bw: float
    mfu_max: float
    l_half: float
    points: Tuple[Tuple[float, float], ...] = field(default_factory=tuple)
    source: str = "kernel_bench"


class CalibratedProfile(AnalyticProfile):
    """AnalyticProfile whose chip peak and MFU(l) come from measured
    kernels: log-log interpolation over the measured MFU points inside the
    sweep range, the fitted saturation curve outside it.

    Flow: ``benchmarks.kernel_bench`` (sweep -> BENCH_kernel.json) ->
    ``analysis.calibrate.load_calibration`` -> ``CalibratedProfile`` ->
    Router / ``PrfaasSimulator`` service times.
    """

    def __init__(self, cfg: ModelConfig, calibration: Calibration,
                 chips_per_instance: int = 1, kv_dtype_bytes: int = 2):
        chip = ChipSpec(f"measured:{calibration.source}",
                        calibration.peak_flops, calibration.mem_bw, 0.0)
        super().__init__(cfg, chip, chips_per_instance,
                         mfu_max=calibration.mfu_max,
                         l_half=calibration.l_half,
                         kv_dtype_bytes=kv_dtype_bytes)
        self.calibration = calibration

    def mfu(self, l: float) -> float:
        pts = self.calibration.points
        if len(pts) >= 2 and pts[0][0] <= l <= pts[-1][0]:
            return _loglog_interp([p[0] for p in pts],
                                  [max(p[1], 1e-9) for p in pts], l)
        return super().mfu(l)
