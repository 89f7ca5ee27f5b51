"""Statistical primitives for the sequential MH test and chain diagnostics.

The tensor functions follow ``repro.core.stats`` in float32. The Student-t
tail is the JAX package's float32 recurrence (see
:mod:`repro_torch.kernels.ref`), not the exact tail: the two differ by up to
6e-2 relative at df = 1e5, and the port reproduces the reference's
decisions. The chain diagnostics and the safeguard's Jarque–Bera test are
host-side numpy, as in the reference.
"""
from __future__ import annotations

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
