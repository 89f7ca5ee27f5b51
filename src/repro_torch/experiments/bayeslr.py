"""Bayesian logistic regression (paper Sec. 4.1), the port of
``repro.experiments.bayeslr``.

    w ~ N(0, 0.1 I_D),   y_i ~ Logit(y | x_i, w),  y in {-1, +1}

The MNIST-like feature set of the Fig-4 risk experiment (12214 train / 2037
test, 50 PCA-like dimensions, synthesized with the same shape and scale)
and the 2-feature synthetic of Fig. 5. Data is drawn on the device from a
seeded ``torch.Generator``; to start from the JAX package's arrays use
:mod:`repro_torch.convert`. ``make_serving_workload`` serves the posterior
through :mod:`repro_torch.serving`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import make_generator, resolve_device
from ..core.target import PartitionedTarget
from ..core.target_builder import build_target
from ..kernels.ref import logit_loglik

PRIOR_VAR = 0.1


class LRData(NamedTuple):
    x_train: torch.Tensor  # (N, D)
    y_train: torch.Tensor  # (N,) in {-1, +1}
    x_test: torch.Tensor
    y_test: torch.Tensor
    w_true: torch.Tensor


def synth_mnist_like(seed: int = 0, n_train: int = 12214, n_test: int = 2037, d: int = 50,
                     *, device=None) -> LRData:
    """Two-class feature clouds with PCA-like decaying variance per dim,
    the scale of the paper's 7-vs-9 MNIST PCA features."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    scales = 1.0 / torch.sqrt(1.0 + torch.arange(d, dtype=torch.float32, device=dev))
    w_true = torch.randn(d, generator=gen, device=dev) * scales * 2.0
    x_train = torch.randn(n_train, d, generator=gen, device=dev) * scales
    x_test = torch.randn(n_test, d, generator=gen, device=dev) * scales
    u = torch.rand(n_train + n_test, generator=gen, device=dev)
    y_train = torch.where(u[:n_train] < torch.sigmoid(x_train @ w_true), 1.0, -1.0)
    y_test = torch.where(u[n_train:] < torch.sigmoid(x_test @ w_true), 1.0, -1.0)
    return LRData(x_train, y_train, x_test, y_test, w_true)


def synth_2d(seed: int, n: int, *, device=None) -> LRData:
    """Fig. 5a style data: two 2-d blobs separated along a diagonal."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    w_true = torch.tensor([2.0, -2.0], device=dev)
    x = torch.randn(n, 2, generator=gen, device=dev)
    y = torch.where(torch.rand(n, generator=gen, device=dev) < torch.sigmoid(x @ w_true), 1.0, -1.0)
    k = max(n // 10, 1)
    return LRData(x, y, x[:k], y[:k], w_true)


# The shared logistic factor lives in repro_torch.kernels.ref; re-exported
# under the name the experiments imported it by.
loglik = logit_loglik


def make_target(x: torch.Tensor, y: torch.Tensor, prior_var: float = PRIOR_VAR) -> PartitionedTarget:
    """BayesLR target via the ``logit`` kernel family; the prior sums over
    the last axis, so it scores a (K, D) batch of chains as (K,)."""
    return build_target(
        "logit",
        (x, y),
        x.shape[0],
        prior_logpdf=lambda w: (-0.5 / prior_var) * (w ** 2).sum(-1),
    )


def make_grad_fn(x: torch.Tensor, y: torch.Tensor, prior_var: float = PRIOR_VAR,
                 subsample: int | None = None):
    """Gradient of the log posterior, or of its estimate on the first
    ``subsample`` rows rescaled by N/|S|, through ``torch.autograd`` on the
    plain log-likelihood: it powers the MALA proposal. A (K, D) theta gives
    per-chain gradients."""
    n = x.shape[0]
    sub = n if subsample is None else min(subsample, n)
    xs, ys = x[:sub], y[:sub]

    def grad(w: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            wv = w.detach().requires_grad_(True)
            batched = wv.ndim == 2  # (K, D): the rows' logits as (N, K) columns
            ll = logit_loglik(wv.transpose(0, 1) if batched else wv, xs,
                              ys[:, None] if batched else ys).sum(0)
            if subsample is not None:
                ll = (n / sub) * ll
            lp = (-0.5 / prior_var) * (wv ** 2).sum(-1) + ll
            (g,) = torch.autograd.grad(lp.sum(), wv)
        return g

    return grad


def run_posterior_ensemble(seed, data: LRData, num_chains: int = 8, num_steps: int = 1000,
                           kernel: str = "subsampled", batch_size: int = 100,
                           epsilon: float = 0.05, sampler: str = "stream",
                           sigma: float = 0.05, overdisperse: float = 0.5,
                           stepping: str = "lockstep", schedule=None, *, device=None,
                           fused_kernels: str = "auto"):
    """K-chain posterior sampling with cross-chain diagnostics, from
    overdispersed starting points. Returns (samples (K, T, D) numpy,
    diagnostics dict: per-dimension split-R-hat over the second half, total
    ESS of w[0], per-chain acceptance and evaluated-section summaries)."""
    from ..core import (ChainEnsemble, RandomWalk, SubsampledMHConfig, ensemble_summary,
                        multichain_ess, split_rhat)

    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    target = make_target(data.x_train.to(dev), data.y_train.to(dev))
    d = data.x_train.shape[1]
    cfg = SubsampledMHConfig(batch_size=batch_size, epsilon=epsilon, sampler=sampler)
    ens = ChainEnsemble(target, RandomWalk(sigma), num_chains, kernel=kernel, config=cfg,
                        stepping=stepping, schedule=schedule, fused_kernels=fused_kernels,
                        device=dev)
    theta0 = overdisperse * torch.randn(num_chains, d, generator=gen, device=dev)
    state = ens.init(theta0, batched=True)
    state, samples, infos = ens.run(gen, state, num_steps)
    samples = samples.cpu().numpy()
    w = samples[:, num_steps // 2:]
    diagnostics = {
        "rhat": split_rhat(w),
        "ess_w0": multichain_ess(w[..., 0]),
        **ensemble_summary(infos),
    }
    return samples, diagnostics


def make_serving_workload(*, smoke: bool = False, num_chains: int = 8, n_train: int | None = None,
                          d: int | None = None, batch_size: int | None = None,
                          epsilon: float = 0.05, sigma: float = 0.05, stepping: str = "lockstep",
                          schedule=None, seed: int = 0, device=None):
    """The BayesLR posterior as a servable workload (see
    :mod:`repro_torch.serving.workloads`): the ``logit``-family target behind
    a :class:`~repro_torch.core.ensemble.ChainEnsemble` (the ``stream``
    sampler), with two request classes:

      * ``predictive``: posterior-predictive P(y=+1 | x) for test rows,
      * ``vote``: the posterior fraction of draws classifying x as +1.

    Query inputs are rows of the held-out test set. Each class scores all
    (S, D) draws against the (B, D) rows in one ``torch.matmul``.
    """
    from ..core import ChainEnsemble, RandomWalk, SubsampledMHConfig
    from ..serving.resident import QuerySpec
    from ..serving.workloads import ServingWorkload, row_sampler

    dev = resolve_device(device)
    n_train = n_train if n_train is not None else (2_000 if smoke else 12_000)
    d = d if d is not None else (4 if smoke else 20)
    batch_size = batch_size if batch_size is not None else (100 if smoke else 500)
    data = synth_mnist_like(seed, n_train=n_train, n_test=max(512, d * 16), d=d, device=dev)
    target = make_target(data.x_train, data.y_train)
    cfg = SubsampledMHConfig(batch_size=batch_size, epsilon=epsilon, sampler="stream")
    ens = ChainEnsemble(target, RandomWalk(sigma), num_chains, config=cfg, stepping=stepping,
                        schedule=schedule, device=dev)
    make_queries = row_sampler(data.x_test)
    specs = {
        "predictive": QuerySpec(fn=lambda w, xs: torch.sigmoid(w @ xs.T), aggregate="mean",
                                make_queries=make_queries, name="predictive"),
        "vote": QuerySpec(fn=lambda w, xs: (w @ xs.T > 0).to(torch.float32), aggregate="mean",
                          make_queries=make_queries, name="vote"),
    }
    return ServingWorkload(name="bayeslr", ensemble=ens, theta0=torch.zeros(d), query_specs=specs,
                           default_class="predictive",
                           description=f"Bayesian logistic regression, N={n_train}, D={d}")


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def predictive_mean_prob(w_samples, x_test) -> np.ndarray:
    """Running posterior-predictive mean P(y=+1|x) per test point: (T, Ntest)."""
    logits = _np(w_samples) @ _np(x_test).T
    probs = 1.0 / (1.0 + np.exp(-logits))
    return np.cumsum(probs, axis=0) / np.arange(1, len(probs) + 1)[:, None]


def risk_vs_reference(pred_running: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Mean squared error of the running predictive mean against a long-run
    reference, per step (Korattikara et al. 2014)."""
    return np.mean((pred_running - reference[None, :]) ** 2, axis=1)


def test_error(w, x_test, y_test) -> float:
    pred = np.sign(_np(x_test) @ _np(w))
    return float(np.mean(pred != _np(y_test)))
