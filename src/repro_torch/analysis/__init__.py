"""Measured-machine calibration of the Router's prefill profile (the
reference's ``analysis.calibrate`` and the sweep of its
``benchmarks/kernel_bench.py``), and the dry run's counting, roofline,
cost fit and report (``counting``, ``roofline``, ``costfit``,
``report``)."""
from repro_torch.analysis.calibrate import (calibrated_profile,
                                            calibration_from_points,
                                            fit_mfu_curve, load_calibration)

__all__ = ["fit_mfu_curve", "calibration_from_points", "calibrated_profile",
           "load_calibration"]
