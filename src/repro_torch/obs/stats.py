"""The statistics core of ``repro_torch.obs`` (a copy of ``repro.obs.stats``,
which the port does not import): seeded percentile-bootstrap confidence
intervals of a median, the ``{median, ci_lo, ci_hi, reps, mean, min, max}``
summary, and the CI-overlap minimum-effect-size gate a benchmark's compare
step judges baseline against candidate with.

Numpy only.  A throughput delta is significant only when the two 95 %
bootstrap CIs of the median are disjoint AND the median ratio clears a
minimum effect size; everything else is "unchanged within noise".
``tests/test_torch_obs.py`` holds every function equal to ``repro``'s on
seeded samples.
"""

from __future__ import annotations

import numpy as np

#: default bootstrap resamples: enough that the CI endpoints of a
#: median-of-~10 are stable to well under the effect sizes we gate on
N_BOOT = 2000
CONFIDENCE = 0.95
#: default minimum effect size for the compare gate: a significant delta
#: smaller than 10% is reported but never fails the gate
MIN_EFFECT = 0.10


def bootstrap_ci(samples, *, n_boot: int = N_BOOT, conf: float = CONFIDENCE,
                 seed: int = 0, stat=np.median) -> tuple[float, float]:
    """Seeded percentile-bootstrap CI of ``stat`` over ``samples``.

    Deterministic (fixed ``seed``): two runs over the same samples produce
    identical intervals, so the gate itself can never flake.  With a single
    sample the interval degenerates to the point (honestly useless — the
    harness enforces reps >= 3).
    """
    s = np.asarray(samples, dtype=np.float64)
    if s.size == 0:
        return float("nan"), float("nan")
    if s.size == 1:
        return float(s[0]), float(s[0])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s.size, size=(n_boot, s.size))
    stats = stat(s[idx], axis=1)
    lo, hi = np.percentile(stats, [(1 - conf) / 2 * 100, (1 + conf) / 2 * 100])
    return float(lo), float(hi)


def summarize(samples, *, n_boot: int = N_BOOT, conf: float = CONFIDENCE,
              seed: int = 0) -> dict:
    """``{median, ci_lo, ci_hi, reps, mean, min, max}`` of ``samples`` —
    the stats block every throughput row of the v6 bench schema carries."""
    s = np.asarray(samples, dtype=np.float64)
    lo, hi = bootstrap_ci(s, n_boot=n_boot, conf=conf, seed=seed)
    return {
        "median": float(np.median(s)) if s.size else float("nan"),
        "ci_lo": lo,
        "ci_hi": hi,
        "reps": int(s.size),
        "mean": float(np.mean(s)) if s.size else float("nan"),
        "min": float(np.min(s)) if s.size else float("nan"),
        "max": float(np.max(s)) if s.size else float("nan"),
    }


def ci_gate(base: dict, cand: dict, *, min_effect: float = MIN_EFFECT) -> dict:
    """CI-overlap minimum-effect-size verdict for one throughput row.

    ``base``/``cand`` are stats blocks (``median``/``ci_lo``/``ci_hi`` at
    least).  Higher is better (throughput).  Returns a dict with:

    * ``status`` — ``"regression"`` (CIs disjoint below AND the median drop
      exceeds ``min_effect``), ``"improvement"`` (the mirror image), or
      ``"ok"`` (everything else: overlapping CIs, or a significant but
      sub-effect-size separation).
    * ``ratio`` — candidate median / baseline median.
    * ``separated`` — whether the CIs were disjoint at all (so a verdict
      consumer can distinguish "within noise" from "real but tiny").
    """
    bm, cm = float(base["median"]), float(cand["median"])
    ratio = cm / bm if bm else float("inf")
    below = float(cand["ci_hi"]) < float(base["ci_lo"])
    above = float(cand["ci_lo"]) > float(base["ci_hi"])
    if below and ratio < 1.0 - min_effect:
        status = "regression"
    elif above and ratio > 1.0 + min_effect:
        status = "improvement"
    else:
        status = "ok"
    return {
        "status": status,
        "ratio": round(ratio, 4),
        "separated": bool(below or above),
        "base": {"median": bm, "ci_lo": float(base["ci_lo"]),
                 "ci_hi": float(base["ci_hi"])},
        "cand": {"median": cm, "ci_lo": float(cand["ci_lo"]),
                 "ci_hi": float(cand["ci_hi"])},
    }
