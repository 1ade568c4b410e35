"""The cost polynomial of ``src/repro/analysis/costfit.py``.

The reference fits probes because ``cost_analysis`` counts a ``while``
loop's body once: it compiles small probes with every scan unrolled and
fits the exact polynomial

  F(B, S, R, mb) = B*(a0 + a1 S + a2 S^2)                    # embed/logits
                 + sum_g B*Rg*(b0 + b1 S + b2 S^2)           # per layer
                 + sum_g (mb*Rg*c_g + Rg*d_g)                # param colls
                 + mb*e + f                                  # constants

per device, then evaluates it at full scale.  A ``meta`` count runs every
loop (``analysis/counting.py``), so the dry run counts each cell directly
and needs no fit.  What is kept is the basis and the fit, to price a depth
or a length that no count ran from counts of a few small ones
(:func:`scaled_config` cuts the depth): on one plain attention route
(``kernels/ops.py::plain_attention_route``) the counts are this
polynomial, so such a fit is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


def scaled_config(cfg: ModelConfig, r_vec):
    """Replace group repeats with r_vec (decoder groups then encoder)."""
    gs = list(cfg.groups)
    egs = list(cfg.encoder_groups or ())
    out_g = [dataclasses.replace(g, repeats=r_vec[i])
             for i, g in enumerate(gs)]
    out_e = [dataclasses.replace(g, repeats=r_vec[len(gs) + i])
             for i, g in enumerate(egs)]
    return dataclasses.replace(cfg, groups=tuple(out_g),
                               encoder_groups=tuple(out_e) or None)


def basis_row(kind: str, B, S, r_vec, mb):
    """Per-device cost basis (the reference's): token work scales with B
    alone (microbatching splits the same batch), mb enters through
    per-microbatch overheads, R through parameter-sized work."""
    row = [B, B * S, B * S * S]
    for r in r_vec:
        row += [B * r, B * S * r, B * S * S * r,
                mb * r, float(r)]
    row += [float(mb), 1.0]
    return np.array(row, np.float64)


def nnls_fit(A, y):
    """Non-negative least squares by iterative active-set clamping (the
    reference's): every true coefficient is >= 0, so a negative one is
    clamped to zero and the rest re-solved."""
    scale = np.maximum(np.abs(A).max(0), 1e-12)
    As = A / scale
    active = np.ones(A.shape[1], dtype=bool)
    c = np.zeros(A.shape[1])
    for _ in range(A.shape[1]):
        if not active.any():
            break
        sol, *_ = np.linalg.lstsq(As[:, active], y, rcond=None)
        if (sol >= -1e-12).all():
            c[active] = np.maximum(sol, 0.0)
            break
        idx = np.where(active)[0]
        active[idx[sol < 0]] = False
    else:
        c[active] = 0.0
    return c / scale


def fit_counts(kind: str, points, counts) -> dict:
    """The fit of ``counts`` (a dict of metric -> value per point) at
    ``points`` ((B, S, r_vec, mb) each): {"kind", "coeffs": {metric:
    coefficients}}, the reference's fit record."""
    A = np.stack([basis_row(kind, *p) for p in points])
    return {"kind": kind, "coeffs": {
        k: nnls_fit(A, np.array([c[k] for c in counts], np.float64)).tolist()
        for k in counts[0]}}


def predict(fit: dict, cfg: ModelConfig, kind: str, B: int, S: int,
            mb: int = 1) -> dict:
    """Each fitted metric at ``cfg``'s full depth (the reference's)."""
    r_full = [g.repeats for g in cfg.groups] \
        + [g.repeats for g in (cfg.encoder_groups or ())]
    row = basis_row(kind, B, S, r_full, mb)
    return {k: float(np.dot(np.array(c), row))
            for k, c in fit["coeffs"].items()}
