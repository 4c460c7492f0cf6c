"""The sparse-gap matching model's host side: cohort labels and per-cohort
parameters (the port of ``reporter_tpu/matching/sparse.py``, without the
route-consistent interpolation).

  * **Cohorts.**  A trace whose median inter-point gap is at or above
    ``sparse_gap_s`` belongs to a sparse cohort, labelled with the quality
    plane's gap buckets (``GAP_BUCKETS``: "30-45", "45-60", "ge60", ...).
  * **Parameters.**  Each cohort decodes with the config's sparse family
    (``sparse_*`` knobs, ``sparse_beam_k`` candidates), overlaid by the
    cohort's row of a CALIBRATION.json (``$REPORTER_CALIBRATION`` or
    ``cfg.calibration``; a cohort the file lacks borrows the nearest of
    "45-60", "ge60", "30-45"), overlaid by per-request match_options
    (sigma_z, beta, search_radius), the radius clamped to cell_size/2.
    ``params_for`` turns those values into (MatchParams, SparseParams, k)
    for the kernels' SPARSE instantiations (ops/viterbi.py).

The model is on when ``$REPORTER_SPARSE`` says so, else when
``cfg.sparse`` does; both env variables are read when the model is built
(with the matcher).  Off, it changes nothing: every trace takes the dense
programs.  ``dispatch`` counts traces (windowed, long) and session steps
dispatched through the sparse programs, per cohort label.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

# the quality plane's gap buckets (reporter_tpu/obs/quality.py): the
# reference BatchingProcessor's operating point (>= 45 s) has two of them
GAP_BUCKETS: Tuple[Tuple[float, str], ...] = (
    (15.0, "lt15"), (30.0, "15-30"), (45.0, "30-45"),
    (60.0, "45-60"), (math.inf, "ge60"),
)

# calibration keys read per cohort; anything else in the file is provenance
_COHORT_KEYS = (
    "sigma_z", "beta", "search_radius", "k",
    "beta_ref_s", "beta_scale", "beta_max",
    "break_speed_mps", "vmax_mps", "plaus_weight",
)

_OFF = ("0", "false", "off", "no")


def gap_label(times: List[float], gap_s: float) -> Optional[str]:
    """The sparse cohort label of a trace's timestamps, or None when the
    trace is dense (fewer than two points, or a median gap below
    ``gap_s``)."""
    if len(times) < 2:
        return None
    med = float(np.median(np.diff(np.asarray(times, np.float64))))
    if med < gap_s:
        return None
    return next((label for bound, label in GAP_BUCKETS if med < bound),
                GAP_BUCKETS[-1][1])


def load_calibration(path: str) -> Optional[dict]:
    """Parse a CALIBRATION.json ({"cohorts": {label: {param: value}}}).
    Any problem is logged and gives None: a corrupt calibration degrades
    to the config family, it never takes the matcher down."""
    try:
        with open(path) as f:
            d = json.load(f)
        cohorts = d.get("cohorts")
        if not isinstance(cohorts, dict) or not cohorts:
            raise ValueError("no cohorts")
        out = {}
        for label, row in cohorts.items():
            if not isinstance(row, dict):
                raise ValueError("cohort %r is not an object" % label)
            clean = {k: row[k] for k in _COHORT_KEYS if k in row}
            for k, v in clean.items():
                if k != "k" and not (isinstance(v, (int, float))
                                     and math.isfinite(float(v))):
                    raise ValueError("cohort %r key %r = %r" % (label, k, v))
            out[str(label)] = clean
        return {"cohorts": out, "path": path, "generated": d.get("generated"),
                "corpus": d.get("corpus")}
    except (OSError, ValueError, AttributeError, json.JSONDecodeError) as e:
        log.warning("calibration %s unusable (%s); the sparse model runs "
                    "the config family", path, e)
        return None


def clamp_radius(radius: float, cell_size: float,
                 source: str = "request") -> float:
    """min(radius, cell_size/2): the bound that keeps the 2x2 quadrant
    candidate sweep exhaustive; a clamp is logged with its source."""
    max_radius = float(cell_size) / 2.0
    if radius <= max_radius:
        return float(radius)
    log.warning("search_radius %.3f (%s) clamped to %.3f (the 2x2 quadrant "
                "sweep requires radius <= cell_size/2)", radius, source,
                max_radius)
    return max_radius


class SparseModel:
    """One matcher's sparse-gap model: the enable flag, the calibration
    table, the per-cohort parameter cache and the dispatch counts."""

    def __init__(self, cfg, cell_size: float):
        self.cfg = cfg
        self.cell_size = float(cell_size)
        env = os.environ.get("REPORTER_SPARSE", "").strip().lower()
        self.enabled = (env not in _OFF) if env else bool(cfg.sparse)
        self.gap_s = float(cfg.sparse_gap_s or 40.0)
        self.calibration: Optional[dict] = None
        if self.enabled:
            path = (os.environ.get("REPORTER_CALIBRATION", "").strip()
                    or cfg.calibration or "")
            if path:
                self.calibration = load_calibration(path)
        # (label, pkey) -> (MatchParams, SparseParams, k)
        self._params: Dict[tuple, tuple] = {}
        # cohort label -> traces / session steps through the sparse programs
        self.dispatch: Dict[str, int] = {}

    # -- cohorts -----------------------------------------------------------

    def label_for_times(self, times: List[float]) -> Optional[str]:
        return gap_label(times, self.gap_s) if self.enabled else None

    def label_for_trace(self, trace: dict) -> Optional[str]:
        if not self.enabled:
            return None
        try:
            times = [float(p["time"]) for p in trace["trace"]]
        except (KeyError, TypeError, ValueError):
            return None
        return gap_label(times, self.gap_s)

    def count(self, label: str, n: int = 1) -> None:
        self.dispatch[label] = self.dispatch.get(label, 0) + n

    # -- parameters --------------------------------------------------------

    def cohort_values(self, label: str, pkey: tuple = ()) -> dict:
        """The effective values of one cohort as plain numbers: the config
        family, overlaid by the cohort's calibration row, overlaid by the
        per-request (sigma_z, beta, search_radius) of ``pkey``; the radius
        clamped to cell_size/2."""
        cfg = self.cfg
        vals = {
            "sigma_z": float(cfg.sigma_z),
            "beta": float(cfg.beta),
            "search_radius": float(cfg.sparse_search_radius
                                   or cfg.search_radius),
            "k": int(cfg.sparse_beam_k or cfg.beam_k),
            "beta_ref_s": float(cfg.sparse_beta_ref_s),
            "beta_scale": float(cfg.sparse_beta_scale),
            "beta_max": float(cfg.sparse_beta_max),
            "break_speed_mps": float(cfg.sparse_break_speed_mps),
            "vmax_mps": float(cfg.sparse_vmax_mps),
            "plaus_weight": float(cfg.sparse_plaus_weight),
        }
        if self.calibration:
            cohorts = self.calibration["cohorts"]
            row = cohorts.get(label)
            if row is None:  # the nearest calibrated cohort stands in
                row = next((cohorts[alt] for alt in ("45-60", "ge60", "30-45")
                            if alt in cohorts), None)
            if row:
                vals.update({k: (int(v) if k == "k" else float(v))
                             for k, v in row.items()})
        if pkey:
            vals["sigma_z"], vals["beta"], vals["search_radius"] = (
                float(pkey[0]), float(pkey[1]), float(pkey[2]))
        vals["search_radius"] = clamp_radius(vals["search_radius"],
                                             self.cell_size, "sparse")
        vals["k"] = max(1, int(vals["k"]))
        return vals

    def params_for(self, label: str, pkey: tuple = ()) -> tuple:
        """(MatchParams, SparseParams, k) of one cohort, cached (at most 64
        entries, like the matcher's per-request params cache)."""
        key = (label, pkey)
        hit = self._params.get(key)
        if hit is not None:
            return hit
        import dataclasses

        from ..ops.viterbi import MatchParams, SparseParams

        if len(self._params) >= 64:
            self._params.clear()
        vals = self.cohort_values(label, pkey)
        p = MatchParams.from_config(dataclasses.replace(
            self.cfg, sigma_z=vals["sigma_z"], beta=vals["beta"],
            search_radius=vals["search_radius"]))
        sp = SparseParams.from_values(
            vals["beta_ref_s"], vals["beta_scale"], vals["beta_max"],
            vals["break_speed_mps"], vals["vmax_mps"], vals["plaus_weight"])
        out = self._params[key] = (p, sp, int(vals["k"]))
        return out

    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "gap_s": self.gap_s,
            "calibrated": bool(self.calibration),
            "calibration": (self.calibration or {}).get("path"),
            "dispatch": dict(self.dispatch),
        }
