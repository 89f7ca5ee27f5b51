"""Adaptive per-chain scheduling for the subsampled-MH ensemble: the port of
``repro.core.schedule``.

After every completed transition the controller folds that transition's
``rounds`` / ``n_evaluated`` / ``accepted`` into trailing EMAs and re-tunes,
per chain:

  * ``batch_size`` within a static **bucket set**: chains whose tests run
    long (rounds EMA above ``rounds_high``) step up a bucket, chains that
    decide in about one round step down. Round shapes stay at the largest
    bucket; the *effective* batch is a per-chain tensor applied through the
    bounded draws of :mod:`repro_torch.core.samplers`;
  * ``epsilon`` within ``[epsilon floor, epsilon_max]``: a chain that keeps
    exhausting its pool relaxes its tolerance multiplicatively, easy chains
    decay back to the floor (the configured ``SubsampledMHConfig.epsilon``);
  * optionally (``adapt_proposal=True``) the proposal's ``sigma_scale``,
    toward the target acceptance rate.

The state is a :class:`ControllerState` of tensors with an optional leading
(K,) chain axis; :func:`controller_update` is float32 tensor arithmetic over
all chains at once. It keeps the reference's dtypes, promotions and Python
branches, so on the same sequence of infos it gives the reference's buckets,
epsilons, EMAs and scales bit for bit when both run op by op on the CPU. Two
pieces need care for that: ``exp`` is XLA's CPU polynomial (:func:`_exp_f32`),
and the gain decay ``(1 + t) ** -decay`` is a float64 power rounded to
float32, where XLA calls glibc's ``powf``; the two differ by one ulp at about
0.07% of the integers t (first at t = 323 for decay 0.75).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, tree_map

F32 = torch.float32


class ControllerState(NamedTuple):
    """Per-chain adaptation state; every field is a scalar tensor, or (K,) in
    an ensemble. ``bucket`` indexes the static bucket tuple."""

    bucket: torch.Tensor  # int32 index into the batch-bucket tuple
    epsilon: torch.Tensor  # f32 current per-chain tolerance
    ema_rounds: torch.Tensor  # f32 trailing mean of rounds per transition
    ema_frac: torch.Tensor  # f32 trailing mean of n_evaluated / N
    ema_accept: torch.Tensor  # f32 trailing acceptance rate
    t: torch.Tensor  # int32 transitions folded in so far
    sigma_scale: torch.Tensor  # f32 proposal-sigma multiplier (1.0 = base)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Static controller configuration (the reference's fields and checks).

    ``batch_buckets=None`` derives ``{m//2, m, 2m, 4m}`` from the kernel's
    ``batch_size`` (see :meth:`buckets_for`); ``epsilon_min=None`` is the base
    ``SubsampledMHConfig.epsilon``.

        >>> from repro_torch.core import SubsampledMHConfig
        >>> ScheduleConfig(epsilon_max=0.2).buckets_for(SubsampledMHConfig(batch_size=100), 5000)
        (50, 100, 200, 400)
    """

    batch_buckets: tuple[int, ...] | None = None
    epsilon_max: float = 0.2
    epsilon_min: float | None = None
    adapt_batch_size: bool = True
    adapt_epsilon: bool = True
    ema_halflife: float = 8.0  # transitions until a stat's weight halves
    rounds_high: float = 3.0  # rounds EMA above this -> bigger bucket
    rounds_low: float = 1.25  # rounds EMA below this -> smaller bucket
    exhaust_frac: float = 0.9  # n_evaluated/N at or above this -> relax epsilon
    epsilon_grow: float = 1.25
    epsilon_decay: float = 0.97
    adapt_proposal: bool = False
    accept_target: float = 0.234
    proposal_gain: float = 0.33  # log-scale gain per transition
    scale_min: float = 0.1
    scale_max: float = 10.0
    # gain * (1 + t) ** -adapt_gain_decay; 0.0 keeps the gain constant
    adapt_gain_decay: float = 0.0

    def __post_init__(self):
        if self.batch_buckets is not None:
            b = tuple(sorted(set(int(x) for x in self.batch_buckets)))
            if not b or b[0] < 1:
                raise ValueError(f"batch_buckets must be positive ints, got {self.batch_buckets}")
            object.__setattr__(self, "batch_buckets", b)
        if not 0.0 < self.epsilon_decay <= 1.0 or self.epsilon_grow < 1.0:
            raise ValueError("need 0 < epsilon_decay <= 1 <= epsilon_grow")
        if not 0.0 < self.scale_min <= 1.0 <= self.scale_max:
            raise ValueError("need 0 < scale_min <= 1 <= scale_max")
        if not 0.0 < self.accept_target < 1.0:
            raise ValueError(f"accept_target must be in (0, 1), got {self.accept_target}")
        if not 0.0 <= self.adapt_gain_decay <= 1.0:
            raise ValueError(f"adapt_gain_decay must be in [0, 1], got {self.adapt_gain_decay}")

    def buckets_for(self, config, num_sections: int | None = None) -> tuple[int, ...]:
        """The sorted static bucket tuple for a given kernel config."""
        if self.batch_buckets is not None:
            buckets = self.batch_buckets
        else:
            m = config.batch_size
            buckets = tuple(sorted({max(1, m // 2), m, 2 * m, 4 * m}))
        if num_sections is not None:
            buckets = tuple(sorted({min(b, num_sections) for b in buckets}))
        return buckets

    def epsilon_floor(self, config) -> float:
        eps = config.epsilon if self.epsilon_min is None else self.epsilon_min
        return float(min(eps, self.epsilon_max))


def controller_init(sched: ScheduleConfig, config, num_sections: int,
                    num_chains: int | None = None, *, device=None) -> ControllerState:
    """Initial state: the bucket nearest the base batch, the floor epsilon,
    neutral EMAs. With ``num_chains`` every field gets a leading (K,) axis.
    ``device=None`` means the card."""
    device = resolve_device(device)
    buckets = sched.buckets_for(config, num_sections)
    base = min(range(len(buckets)), key=lambda i: abs(buckets[i] - config.batch_size))
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    st = ControllerState(
        bucket=scalar(base, torch.int32),
        epsilon=scalar(sched.epsilon_floor(config), F32),
        ema_rounds=scalar(1.0, F32),
        ema_frac=scalar(min(config.batch_size / max(num_sections, 1), 1.0), F32),
        ema_accept=scalar(0.5, F32),
        t=scalar(0, torch.int32),
        sigma_scale=scalar(1.0, F32),
    )
    if num_chains is None:
        return st
    return tree_map(lambda l: l.repeat(num_chains), st)


def controller_params(state: ControllerState, buckets):
    """The knobs a transition runs with: (epsilon f32, batch_eff int32).
    ``buckets`` is the static tuple, or the same values as an int32 tensor
    on the state's device (which saves a copy to the card per call)."""
    if not isinstance(buckets, torch.Tensor):
        buckets = torch.tensor(buckets, dtype=torch.int32, device=state.bucket.device)
    return state.epsilon, buckets[state.bucket.clamp(0, len(buckets) - 1).long()]


# XLA's float32 exp on the CPU: the Cephes polynomial its code generator
# emits, with each multiply-add fused as it fuses them.
_EXP_LO, _EXP_HI = float(torch.tensor(-87.8, dtype=F32)), float(torch.tensor(88.8, dtype=F32))
_EXP_C = tuple(float.fromhex(s) for s in ("0x1.715476p+0", "0x1.63p-1", "-0x1.bd0106p-13"))
_EXP_P = tuple(float.fromhex(s) for s in ("0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7",
                                          "0x1.555382p-5", "0x1.555554p-3")) + (0.5,)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32: the product of two floats is exact
    in float64."""
    d = lambda v: v.double() if isinstance(v, torch.Tensor) else v
    return (d(a) * d(b) + d(c)).to(F32)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, bit for bit XLA's on the CPU wherever the result is a
    normal float (XLA flushes subnormal results to zero)."""
    log2e, c1, c2 = _EXP_C
    x = x.to(F32).clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(_fma(x, log2e, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-c2, n, _fma(-c1, n, x))
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, a, p)
    z = 1.0 + _fma(z, a * a, a)
    return z * ((n.to(torch.int32) + 127) << 23).view(F32)


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float: a scalar operand that
    PyTorch applies as this float32 value (the reference's weakly typed
    Python constants and float32 scalars), with no tensor on the device."""
    return float(np.float32(v))


def controller_update(state: ControllerState, info, sched: ScheduleConfig,
                      buckets: tuple[int, ...], num_sections: int,
                      epsilon_floor: float) -> ControllerState:
    """Fold one completed transition's ``info`` (its ``rounds``,
    ``n_evaluated`` and ``accepted``) into the controller: hysteretic bucket
    moves (one step per transition), multiplicative epsilon moves clamped to
    ``[epsilon_floor, epsilon_max]``, and with ``adapt_proposal`` the sigma
    scale. The three EMAs are mixed as one stacked tensor: the same float32
    operations element by element."""
    decay = np.float32(2.0 ** (-1.0 / max(sched.ema_halflife, 1e-6)))
    old = torch.stack([state.ema_rounds, state.ema_frac, state.ema_accept])
    new = torch.stack([info.rounds.to(F32), info.n_evaluated.to(F32) / _f32(max(num_sections, 1)),
                       info.accepted.to(F32)])
    ema_rounds, ema_frac, ema_accept = old * float(decay) + new * float(np.float32(1.0) - decay)

    up = ema_rounds > _f32(sched.rounds_high)
    down = (ema_rounds < _f32(sched.rounds_low)) & ~up
    bucket = state.bucket
    if sched.adapt_batch_size:
        bucket = (bucket + up.to(torch.int32) - down.to(torch.int32)).clamp(0, len(buckets) - 1)

    eps = state.epsilon
    if sched.adapt_epsilon:
        hard = info.n_evaluated.to(F32) >= _f32(sched.exhaust_frac * num_sections)
        eps = torch.where(hard, eps * _f32(sched.epsilon_grow), eps * _f32(sched.epsilon_decay))
        eps = eps.clamp(_f32(epsilon_floor), _f32(sched.epsilon_max))

    sigma_scale = state.sigma_scale
    if sched.adapt_proposal:
        gain = _f32(sched.proposal_gain)
        if sched.adapt_gain_decay:
            base = (1.0 + state.t.to(F32)).double()
            gain = gain * torch.pow(base, _f32(-sched.adapt_gain_decay)).to(F32)
        sigma_scale = sigma_scale * _exp_f32(gain * (ema_accept - _f32(sched.accept_target)))
        sigma_scale = sigma_scale.clamp(_f32(sched.scale_min), _f32(sched.scale_max))

    return ControllerState(bucket=bucket, epsilon=eps, ema_rounds=ema_rounds,
                           ema_frac=ema_frac, ema_accept=ema_accept,
                           t=state.t + 1, sigma_scale=sigma_scale)
