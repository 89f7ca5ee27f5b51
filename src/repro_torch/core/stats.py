"""Statistical primitives for the sequential MH test and chain diagnostics.

The tensor functions follow ``repro.core.stats`` in float32. The Student-t
tail is the JAX package's float32 recurrence (see
:mod:`repro_torch.kernels.ref`), not the exact tail: the two differ by up to
6e-2 relative at df = 1e5, and the port reproduces the reference's
decisions. The chain diagnostics, the safeguard's Jarque–Bera test and the
serving layer's SLO and EWMA helpers are host-side numpy, as in the
reference (the last are copies of the reference's, which need no JAX).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ref


def student_t_sf(t, df) -> torch.Tensor:
    """P(T > t) for T ~ Student-t(df), t >= 0:
    sf(t) = 0.5 * I_{df/(df+t^2)}(df/2, 1/2)."""
    return ref.student_t_sf_ref(t, df)


def two_sided_t_pvalue(tstat, df) -> torch.Tensor:
    """Two-sided p-value of |tstat| under Student-t(df)."""
    return 2.0 * student_t_sf(torch.abs(torch.as_tensor(tstat, dtype=torch.float32)), df)


class Welford(NamedTuple):
    """Streaming mean/variance accumulator (Chan's parallel merge form),
    float32; ``count`` is float32 too (exact for n <= 2**24). Fields are
    tensors of one shape: () for a chain, (K,) for an ensemble."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor

    @staticmethod
    def empty(shape=(), device=None) -> "Welford":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Welford(z, z.clone(), z.clone())

    def merge_batch(self, values: torch.Tensor, mask: torch.Tensor | None = None) -> "Welford":
        """Merge a batch of observations (the last axis). ``mask`` selects
        valid entries; an empty batch keeps the previous statistics."""
        return Welford(*ref.welford_merge_ref(self.count, self.mean, self.m2, values, mask))

    @property
    def std(self) -> torch.Tensor:
        """Sample standard deviation (ddof=1)."""
        return ref.welford_std_ref(self.count, self.m2)


def finite_population_std_err(welford: Welford, population) -> torch.Tensor:
    """Std of the running mean with the without-replacement correction.

    s = s_l / sqrt(n) * sqrt(1 - (n-1)/(N-1))   (Alg. 2, step 7)
    """
    return ref.finite_population_std_err_ref(welford.count, welford.m2, population)


# ---------------------------------------------------------------------------
# Chain diagnostics (host-side numpy).
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def autocorrelation(x, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation of a 1-d chain via FFT."""
    x = _np(x)
    n = len(x)
    if max_lag is None:
        max_lag = n - 1
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[: max_lag + 1].real / n
    if acov[0] <= 0:
        return np.zeros(max_lag + 1)
    return acov / acov[0]


def effective_sample_size(x) -> float:
    """ESS via Geyer's initial positive sequence estimator."""
    n = len(x)
    if n < 4:
        return float(n)
    rho = autocorrelation(x)
    tau = 1.0
    for k in range(1, (len(rho) - 1) // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair < 0:
            break
        tau += 2.0 * pair
    return float(n / max(tau, 1e-12))


def predictive_risk(estimates, truth: float) -> float:
    """Risk of the running predictive mean (Korattikara et al. 2014),
    E[(f_bar_T - truth)^2], estimated from one chain's or several chains'
    estimates (float64 on the host, as the reference)."""
    estimates = np.atleast_2d(_np(estimates))
    return float(np.mean((estimates - truth) ** 2))


def split_rhat(chains) -> np.ndarray | float:
    """Split-R-hat (Gelman et al. 2013) of (K, T) or (K, T, *param) chains:
    2K half-chains, R-hat = sqrt(((L-1)/L W + B/L) / W)."""
    x = _np(chains)
    if x.ndim < 2:
        raise ValueError("split_rhat expects (K, T, ...) stacked chains")
    k, t = x.shape[:2]
    half = t // 2
    if half < 2:
        raise ValueError(f"chains too short for split-R-hat: T={t}")
    halves = np.concatenate([x[:, :half], x[:, t - half:]], axis=0)
    means = halves.mean(axis=1)
    variances = halves.var(axis=1, ddof=1)
    w = variances.mean(axis=0)
    b = half * means.var(axis=0, ddof=1)
    var_hat = (half - 1) / half * w + b / half
    rhat = np.sqrt(var_hat / np.maximum(w, 1e-300))
    return float(rhat) if rhat.ndim == 0 else rhat


def multichain_ess(chains) -> float:
    """Total effective sample size of a (K, T) scalar-functional trace: the
    sum of per-chain Geyer ESS values."""
    x = _np(chains)
    if x.ndim != 2:
        raise ValueError("multichain_ess expects (K, T)")
    return float(sum(effective_sample_size(row) for row in x))


def tail_latency_summary(rounds, percentiles=(50, 90, 99)) -> dict:
    """Tail statistics of per-transition sequential-test rounds: percentiles,
    mean/max and a histogram over integer round counts."""
    r = _np(rounds).ravel()
    if r.size == 0:
        raise ValueError("tail_latency_summary needs at least one transition")
    out = {f"p{p}": float(np.percentile(r, p)) for p in percentiles}
    out["mean"] = float(r.mean())
    out["max"] = float(r.max())
    edges = np.arange(1, max(int(r.max()), 1) + 1)
    hist, _ = np.histogram(r, bins=np.concatenate([edges - 0.5, [edges[-1] + 0.5]]))
    out["edges"] = edges
    out["hist"] = hist
    return out


def ensemble_summary(infos) -> dict:
    """Per-chain and aggregate transition statistics from stacked ensemble
    infos (leaves shaped (K, T)): acceptance rates, mean evaluated sections,
    and the round-count tail."""
    acc = _np(infos.accepted)
    n_eval = _np(infos.n_evaluated)
    out = {
        "accept_rate": acc.mean(axis=1),
        "mean_n_evaluated": n_eval.mean(axis=1),
        "accept_rate_overall": float(acc.mean()),
        "mean_n_evaluated_overall": float(n_eval.mean()),
    }
    if hasattr(infos, "rounds"):
        rounds = _np(infos.rounds)
        out["mean_rounds"] = rounds.mean(axis=1)
        out["mean_rounds_overall"] = float(rounds.mean())
        out["rounds_tail"] = tail_latency_summary(rounds)
    if hasattr(infos, "epsilon"):
        eps = _np(infos.epsilon)
        out["mean_epsilon"] = eps.mean(axis=1)
        out["final_epsilon"] = eps[:, -1]
    if hasattr(infos, "batch_eff"):
        be = _np(infos.batch_eff)
        out["mean_batch_eff"] = be.mean(axis=1)
        out["final_batch_eff"] = be[:, -1]
    return out


def jarque_bera(x) -> tuple[float, float]:
    """Jarque–Bera normality statistic and asymptotic chi2(2) p-value, on the
    host in float64.

    Used by the Sec. 3.3 safeguard: the sequential t-test assumes the
    mini-batch means are approximately normal; heavy-tailed {l_i} break it.
    """
    x = _np(x)
    n = len(x)
    mu = x.mean()
    s = x.std()
    if s == 0 or n < 8:
        return 0.0, 1.0
    z = (x - mu) / s
    skew = np.mean(z**3)
    kurt = np.mean(z**4) - 3.0
    jb = n / 6.0 * (skew**2 + kurt**2 / 4.0)
    # chi2(2) survival = exp(-jb/2)
    return float(jb), float(np.exp(-jb / 2.0))


def stage_latency_breakdown(spans) -> dict:
    """Per-stage latency tables from closed trace spans.

    The request-path counterpart of :func:`tail_latency_summary`: spans
    (plain dicts carrying ``stage``/``dur_s``, as a tracer records them)
    are grouped by stage tag — queue wait vs batch assembly vs device eval
    vs combine — and each stage gets count/mean/p50/p95/max/total in
    milliseconds. This is what the stats endpoint's ``/stages`` view
    returns, answering "where did the latency go" without re-reading the
    raw spans stream.
    """
    by_stage: dict[str, list[float]] = {}
    traces = set()
    for span in spans:
        dur = span.get("dur_s")
        stage = span.get("stage")
        if not isinstance(dur, (int, float)) or stage is None:
            continue
        by_stage.setdefault(str(stage), []).append(float(dur) * 1e3)
        if span.get("trace_id") is not None:
            traces.add(span["trace_id"])
    stages = {}
    for stage, ms in sorted(by_stage.items()):
        arr = np.asarray(ms, np.float64)
        stages[stage] = {
            "count": int(arr.size),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
            "total_ms": float(arr.sum()),
        }
    return {
        "span_count": int(sum(len(v) for v in by_stage.values())),
        "trace_count": len(traces),
        "stages": stages,
    }


def slo_summary(latencies_s, deadlines_s=None, percentiles=(50, 95, 99)) -> dict:
    """Service-level summary of per-request latencies (seconds).

    The serving-layer counterpart of :func:`tail_latency_summary`: request
    latencies instead of sequential-test rounds. Returns millisecond
    percentiles (``p50_ms`` etc.), mean/max, the request count, and — when
    per-request ``deadlines_s`` are given — the fraction of requests that
    met their deadline (``deadline_hit_rate``), the SLO number
    ``launch/serve.py`` reports per request class.

    Example::

        >>> s = slo_summary([0.010, 0.020, 0.030], deadlines_s=[0.025] * 3)
        >>> round(s["p50_ms"], 1), round(s["deadline_hit_rate"], 2)
        (20.0, 0.67)
    """
    lat = np.asarray(latencies_s, np.float64).ravel()
    if lat.size == 0:
        raise ValueError("slo_summary needs at least one request")
    out = {f"p{p}_ms": float(np.percentile(lat, p) * 1e3) for p in percentiles}
    out["mean_ms"] = float(lat.mean() * 1e3)
    out["max_ms"] = float(lat.max() * 1e3)
    out["count"] = int(lat.size)
    if deadlines_s is not None:
        dl = np.broadcast_to(np.asarray(deadlines_s, np.float64).ravel(), lat.shape)
        out["deadline_hit_rate"] = float(np.mean(lat <= dl))
    return out


# ---------------------------------------------------------------------------
# Unified serving SLO schema, the reference's: RequestQueue.slo_report()
# builds it. Every field is always present (latency percentiles are None
# when a class has no successful completions), so consumers never need
# per-producer key probing.
# ---------------------------------------------------------------------------


_SLO_DEPRECATED_KEYS = {"total_requests": "count"}


class SLOReportDict(dict):
    """A canonical slo_report dict that still answers the older key
    spelling ``total_requests`` (as ``count``), with a
    :class:`DeprecationWarning`. The alias is not a real key: iteration,
    ``in`` and serialization see only the canonical schema."""

    def __missing__(self, key):
        canon = _SLO_DEPRECATED_KEYS.get(key)
        if canon is not None and dict.__contains__(self, canon):
            warnings.warn(f"slo_report key {key!r} is deprecated; use {canon!r}",
                          DeprecationWarning, stacklevel=2)
            return self[canon]
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


@dataclasses.dataclass
class ClassSLO:
    """Per-(workload, request-class) serving statistics.

    ``count``/``errors`` cover *attempted* (non-shed) completions;
    ``admitted``/``shed`` are admission-control counters (for the plain
    queue, which never sheds, ``admitted`` equals the attempted count).
    Latency percentiles summarize successful requests only — a batch that
    failed fast must not read as low latency — while ``deadline_hit_rate``
    covers every attempted request (failures count as misses).
    """

    count: int = 0
    errors: int = 0
    admitted: int = 0
    shed: int = 0
    priority: int = 0
    deadline_hit_rate: float = 0.0
    mean_batch_size: float = 0.0
    p50_ms: float | None = None
    p95_ms: float | None = None
    p99_ms: float | None = None
    mean_ms: float | None = None
    max_ms: float | None = None
    staleness_mean_s: float | None = None
    staleness_max_s: float | None = None

    @classmethod
    def from_requests(
        cls, requests, *, priority: int = 0,
        admitted: int | None = None, shed: int | None = None,
    ) -> "ClassSLO":
        """Aggregate completed request records (anything with ``latency_s``
        / ``error`` / ``deadline_met`` / ``staleness_s`` / ``batch_size``
        attributes; shed requests carry ``error="shed: ..."``)."""
        attempted, shed_local = [], 0
        for r in requests:
            if (r.error or "").startswith("shed"):
                shed_local += 1
            else:
                attempted.append(r)
        ok = [r for r in attempted if r.error is None]
        out = cls(
            count=len(ok),
            errors=len(attempted) - len(ok),
            admitted=len(attempted) if admitted is None else int(admitted),
            shed=shed_local if shed is None else int(shed),
            priority=int(priority),
        )
        if attempted:
            out.deadline_hit_rate = float(
                np.mean([bool(r.deadline_met) for r in attempted])
            )
        if ok:
            s = slo_summary([r.latency_s for r in ok])
            out.p50_ms, out.p95_ms, out.p99_ms = s["p50_ms"], s["p95_ms"], s["p99_ms"]
            out.mean_ms, out.max_ms = s["mean_ms"], s["max_ms"]
            out.mean_batch_size = float(np.mean([r.batch_size or 1 for r in ok]))
            staleness = [r.staleness_s for r in ok if r.staleness_s is not None]
            if staleness:
                out.staleness_mean_s = float(np.mean(staleness))
                out.staleness_max_s = float(np.max(staleness))
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SLOReport:
    """One serving report: totals, admission/recovery state, per-class
    tables. ``count`` spans every completion including shed requests (they
    completed, just not with an answer); ``errors`` excludes shed.
    """

    count: int = 0
    errors: int = 0
    shed: int = 0
    admission: dict | None = None
    recovery: dict | None = None
    classes: dict[str, ClassSLO] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> SLOReportDict:
        return SLOReportDict(
            count=self.count,
            errors=self.errors,
            shed=self.shed,
            admission=self.admission,
            recovery=self.recovery,
            classes={k: v.to_dict() for k, v in self.classes.items()},
        )


def build_slo_report(
    requests,
    *,
    priorities: dict[str, int] | None = None,
    class_counters: dict[tuple[str, str], dict] | None = None,
    admission: dict | None = None,
    recovery: dict | None = None,
) -> SLOReport:
    """Aggregate completed requests into the unified :class:`SLOReport`.

    ``class_counters`` (keyed ``(workload, query_class)``, entries holding
    ``admitted``/``shed``) lets the router report its submit-time admission
    counters instead of the completion-derived defaults; classes that only
    appear in the counters (everything they admitted still pending) still
    get a row.
    """
    done = [r for r in requests if r.latency_s is not None]
    by_class: dict[tuple[str, str], list] = {}
    for r in done:
        by_class.setdefault((r.workload, r.query_class), []).append(r)
    counters = class_counters or {}
    classes: dict[str, ClassSLO] = {}
    errors_total = shed_total = 0
    for wl, qc in sorted(set(by_class) | set(counters)):
        cnt = counters.get((wl, qc))
        entry = ClassSLO.from_requests(
            by_class.get((wl, qc), []),
            priority=(priorities or {}).get(qc, 0),
            admitted=cnt["admitted"] if cnt else None,
            shed=cnt["shed"] if cnt else None,
        )
        classes[f"{wl}.{qc}"] = entry
        errors_total += entry.errors
        shed_total += entry.shed
    return SLOReport(
        count=len(done),
        errors=errors_total,
        shed=shed_total,
        admission=admission,
        recovery=recovery,
        classes=classes,
    )


# ---------------------------------------------------------------------------
# Streaming anomaly / SLO-burn math (for the alert rules of an observability layer)
# ---------------------------------------------------------------------------


class EwmaState(NamedTuple):
    """Exponentially weighted mean/variance for streaming z-scores.

    ``count`` is the number of observations folded in; ``mean``/``var`` are
    the EWMA first and second central moments (West's recurrence). A fresh
    state is ``EwmaState(0, 0.0, 0.0)``.
    """

    count: int
    mean: float
    var: float


def ewma_update(state: EwmaState, x: float, alpha: float = 0.3) -> EwmaState:
    """Fold one observation into an :class:`EwmaState`.

    The first observation initializes the mean exactly (no bias toward
    zero); variance starts at 0 and inflates as spread is observed.
    """
    if state.count == 0:
        return EwmaState(1, float(x), 0.0)
    diff = float(x) - state.mean
    incr = alpha * diff
    mean = state.mean + incr
    var = (1.0 - alpha) * (state.var + diff * incr)
    return EwmaState(state.count + 1, mean, var)


def ewma_zscore(state: EwmaState, x: float, min_sigma: float = 1e-9) -> float:
    """The z-score of ``x`` against an EWMA state's mean/sigma (0.0 until
    the state has seen at least two observations)."""
    if state.count < 2:
        return 0.0
    sigma = max(state.var, 0.0) ** 0.5
    return (float(x) - state.mean) / max(sigma, min_sigma)


def burn_rate(bad_fraction: float, budget: float) -> float:
    """SLO error-budget burn rate: observed bad fraction over the allowed
    bad fraction. 1.0 burns the budget exactly at the sustainable pace;
    >1 exhausts it early (e.g. 14.4 = a 30-day budget gone in ~2 days)."""
    return float(bad_fraction) / max(float(budget), 1e-12)
