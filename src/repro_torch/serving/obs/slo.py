"""Log-bucketed latency histograms + per-tenant SLO evaluation (§6.9;
port of ``repro.serving.obs.slo``).

Two pieces, both deliberately free of engine imports (stdlib only, so
``metrics.py`` can import this module without touching the rest of the
obs package's dependency graph):

* :class:`LogHistogram` — an HDR-style geometric-bucket histogram.  The
  bounded TTFT/ITL sample windows in ``metrics.py`` (``deque(maxlen=
  4096)``) silently drop the *oldest* samples, so on a long run the
  reported p99 is the p99 of the last few minutes, not of the run —
  tail bias that gets worse the longer the server lives.  A histogram
  with geometric buckets keeps every sample forever at O(buckets)
  memory: percentiles are unbiased over the whole run, with relative
  error bounded by the bucket growth factor (``2**0.25`` → ≤ ~19% per
  bucket, ~9.5% expected).  Buckets are FIXED at import time (every
  histogram shares the same ``les`` table), which is what makes
  :meth:`merge` and Prometheus ``histogram`` exposition (cumulative
  ``le`` buckets) exact.

* :func:`evaluate_objective` — SLO error-budget math.  An objective is
  "``target`` of samples must land at or under ``threshold_ms``"
  (e.g. 99% of TTFTs under 200 ms).  The *cumulative* bad fraction
  comes from the histogram (the whole run: has the budget been spent?);
  the *recent* burn rate comes from the caller's last-N sample window
  (the same deques the percentile fix demoted to a debug view — they
  are exactly a sliding recent window, which is what burn rate wants).
  States: ``violated`` (cumulative budget exhausted), ``burning``
  (recent window failing faster than the budget allows — on track to
  violate), ``ok``.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

# geometric bucket ladder: 0.1 ms .. 120 s, 4 buckets per octave.
# ~82 finite buckets + the +Inf bucket; shared by every LogHistogram so
# merge() and cross-instance aggregation are bucket-exact.
HIST_LO_S = 1e-4
HIST_HI_S = 120.0
HIST_GROWTH = 2 ** 0.25


def _bucket_bounds() -> tuple:
    les = [HIST_LO_S]
    while les[-1] < HIST_HI_S:
        les.append(les[-1] * HIST_GROWTH)
    return tuple(les)


_LES = _bucket_bounds()


class LogHistogram:
    """Fixed geometric-bucket latency histogram (seconds).

    ``record`` is one ``bisect`` on the shared bounds table plus three
    scalar updates — cheap enough to be ALWAYS ON (histograms are the
    percentile-bias fix, not an opt-in observability layer).  Bucket i
    counts samples v with ``les[i-1] < v <= les[i]``; the last bucket
    is +Inf.  ``percentile`` returns the matched bucket's UPPER bound:
    a conservative (never under-reporting) estimate whose relative
    error is bounded by the growth factor."""

    __slots__ = ("counts", "sum", "count")

    les = _LES                       # ascending upper bounds, seconds

    def __init__(self):
        self.counts = [0] * (len(_LES) + 1)    # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def record(self, v: float) -> None:
        self.counts[bisect.bisect_left(_LES, v)] += 1
        self.sum += v
        self.count += 1

    def __len__(self) -> int:
        return self.count

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Accumulate ``other`` into self (same bounds by construction)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    def percentile(self, q: float) -> float:
        """q in [0, 1] → seconds (upper bound of the matched bucket).
        Nearest-rank on the cumulative counts; +Inf bucket reports the
        largest finite bound (nothing tighter is known)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return _LES[i] if i < len(_LES) else _LES[-1]
        return _LES[-1]

    def percentiles(self, scale: float = 1e3) -> dict | None:
        """{"p50","p95","p99"} scaled (default ms) — the same contract
        as ``metrics.percentiles``; None when empty."""
        if not self.count:
            return None
        return {"p50": self.percentile(0.50) * scale,
                "p95": self.percentile(0.95) * scale,
                "p99": self.percentile(0.99) * scale}

    def frac_le(self, threshold_s: float) -> float:
        """Fraction of samples known to be <= threshold (counts only
        buckets wholly at or under it — conservative: a threshold
        mid-bucket credits none of that bucket, so the derived bad
        fraction never under-reports)."""
        if not self.count:
            return 1.0
        k = bisect.bisect_right(_LES, threshold_s)
        return sum(self.counts[:k]) / self.count

    def buckets(self):
        """Yield ``(le_seconds, cumulative_count)`` per finite bucket,
        then ``(inf, total_count)`` — the Prometheus histogram rows."""
        cum = 0
        for i, le in enumerate(_LES):
            cum += self.counts[i]
            yield le, cum
        yield math.inf, self.count

    def snapshot(self) -> dict:
        return {"buckets": [[le, cum] for le, cum in self.buckets()],
                "sum": self.sum, "count": self.count}


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-instance serving objectives.  ``None`` threshold = objective
    not set (not evaluated).  ``target`` is the good-fraction goal for
    the latency objectives; ``availability_target`` for completed vs
    failed requests."""
    ttft_ms: float | None = None
    itl_ms: float | None = None
    target: float = 0.99
    availability_target: float = 0.99

    def active(self) -> bool:
        return self.ttft_ms is not None or self.itl_ms is not None


def evaluate_objective(hist: LogHistogram, recent, threshold_ms: float,
                       target: float = 0.99) -> dict:
    """Error-budget view of one latency objective.

    ``allowed = 1 - target`` is the error budget as a fraction of
    samples.  Cumulative ``bad_frac`` (from the histogram, whole run)
    against it gives ``budget_remaining`` and the terminal ``violated``
    state; the bad fraction of ``recent`` (an iterable of seconds —
    the last-N debug window) over ``allowed`` is the burn rate: > 1
    means the recent window is failing faster than the budget can
    absorb (``burning``)."""
    allowed = max(1.0 - target, 1e-12)
    n = hist.count
    bad_frac = (1.0 - hist.frac_le(threshold_ms * 1e-3)) if n else 0.0
    recent = list(recent)
    recent_bad = (sum(1 for v in recent if v > threshold_ms * 1e-3)
                  / len(recent)) if recent else 0.0
    burn_rate = recent_bad / allowed
    if n and bad_frac > allowed:
        state = "violated"
    elif burn_rate > 1.0:
        state = "burning"
    else:
        state = "ok"
    return {
        "threshold_ms": threshold_ms,
        "target": target,
        "count": n,
        "bad_frac": bad_frac,
        "burn_rate": burn_rate,
        "budget_remaining": 1.0 - bad_frac / allowed,
        "state": state,
    }


def evaluate_availability(completed: int, failed: int,
                          target: float = 0.99) -> dict:
    """Availability objective from terminal request counts (failed =
    error/unavailable outcomes chargeable to the server)."""
    allowed = max(1.0 - target, 1e-12)
    n = completed + failed
    bad_frac = failed / n if n else 0.0
    burn_rate = bad_frac / allowed
    state = ("violated" if n and bad_frac > allowed else "ok")
    return {
        "target": target,
        "count": n,
        "bad_frac": bad_frac,
        "burn_rate": burn_rate,
        "budget_remaining": 1.0 - bad_frac / allowed,
        "state": state,
    }


def worst_state(states) -> str:
    """Fold per-objective states into one instance-level state."""
    order = {"ok": 0, "burning": 1, "violated": 2}
    worst = "ok"
    for s in states:
        if order.get(s, 0) > order[worst]:
            worst = s
    return worst
