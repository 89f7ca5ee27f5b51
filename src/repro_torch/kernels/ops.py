"""Public wrappers: the hand kernel for CUDA tensors, the plain version for
CPU tensors.

The dispatch vocabulary is the JAX package's (``repro.kernels.ops``):

  ``mode="auto"``    the kernel for tensors on the card, the plain version
                     for tensors on the CPU — unless ``REPRO_FUSED`` pins
                     another default. The choice follows the tensors' device,
                     not whether a card happens to be present;
  ``mode="always"``  the kernel; raises for tensors on the CPU, where no
                     kernel runs (there is no interpret mode);
  ``mode="never"``   the plain PyTorch version, wherever the tensors are.

``mode="kernel"`` / ``mode="ref"`` are deprecated aliases for ``always`` /
``never`` and emit a ``DeprecationWarning``.

``precision="fp32"`` is float32 end to end; ``precision="bf16"`` reads the
data rows (and rounds the weight pair) as bfloat16 while every kernel still
accumulates in float32; ``precision="auto"`` defers to ``REPRO_PRECISION``,
defaulting to fp32. The plain route makes bf16 copies; the logit, CE and
AR(1) kernels round fp32 operands to bf16 as they load them, so a bf16 call
is one launch and no pool or (K, V, D) table is copied (a bf16 pool halves
the bytes read).

Launch parameters (warps a block of the pair and AR(1) deltas) come from
:mod:`repro_torch.kernels.autotune` on the kernel route of the five tuned
families (the two CE families have a grid of one); explicit launch keyword
arguments win over the tuner, and ``REPRO_AUTOTUNE=0`` pins the sources' own
choices. Every choice gives the same bits.

There is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import os
import warnings

import torch

from . import _build, autotune, ref
from .batched_loglik import batched_logit_delta as _batched_kernel
from .batched_loglik import gather_and_delta as _gather_kernel
from .fused_ce import batched_fused_ce as _batched_ce_kernel
from .fused_ce import fused_ce as _ce_kernel
from .fused_ce import gather_fused_ce as _gather_ce_kernel
from .fy_draw import fy_draw as _fy_kernel
from .fy_draw import fy_draw_ref
from .gaussian_ar1 import batched_gaussian_ar1_delta as _ar1_batched_kernel
from .gaussian_ar1 import gather_ar1_delta as _ar1_gather_kernel
from .gibbs_z import gibbs_z_sweep as _gibbs_z_kernel
from .gibbs_z import gibbs_z_sweep_ref
from .logit_loglik import logit_delta as _logit_kernel
from .logit_loglik import select_rows
from .pgibbs import pgibbs_sweep as _pgibbs_kernel
from .pgibbs import pgibbs_sweep_ref
from .t_test_round import t_test_round as _t_test_kernel
from .t_test_round import t_test_round_ref

MODES = ("auto", "always", "never")
_DEPRECATED_ALIASES = {"kernel": "always", "ref": "never"}
ENV_VAR = "REPRO_FUSED"

PRECISIONS = ("auto", "fp32", "bf16")
PRECISION_ENV_VAR = "REPRO_PRECISION"


def normalize_mode(mode: str) -> str:
    """Canonicalize a dispatch mode, accepting (and warning on) the
    deprecated ``kernel``/``ref`` spellings."""
    if mode in _DEPRECATED_ALIASES:
        canon = _DEPRECATED_ALIASES[mode]
        warnings.warn(
            f"mode={mode!r} is deprecated; use mode={canon!r}",
            DeprecationWarning,
            stacklevel=3,
        )
        return canon
    if mode not in MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; expected one of {MODES}")
    return mode


def resolve_mode(mode: str = "auto") -> str:
    """``auto`` after the ``REPRO_FUSED`` default is applied."""
    mode = normalize_mode(mode)
    if mode == "auto":
        env = os.environ.get(ENV_VAR, "auto")
        mode = normalize_mode(env) if env != "auto" else "auto"
    return mode


def use_kernel(mode: str = "auto", tensor: torch.Tensor | None = None) -> bool:
    """Resolve a dispatch mode for tensors living where ``tensor`` lives:
    "run the hand kernel?" Raises for ``always`` on CPU tensors."""
    mode = resolve_mode(mode)
    on_cuda = tensor is not None and tensor.device.type == "cuda"
    if mode == "never":
        return False
    if mode == "always" and not on_cuda:
        where = "no tensor" if tensor is None else f"tensors on {tensor.device}"
        raise RuntimeError(f"mode='always' needs CUDA tensors; got {where}")
    return on_cuda


def resolve_precision(precision: str = "auto") -> str:
    """Resolve a precision mode to ``fp32``/``bf16``; ``auto`` defers to
    ``$REPRO_PRECISION`` and defaults to exact fp32."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    if precision == "auto":
        env = os.environ.get(PRECISION_ENV_VAR, "fp32")
        if env not in ("fp32", "bf16"):
            raise ValueError(
                f"${PRECISION_ENV_VAR}={env!r}; expected 'fp32' or 'bf16'"
            )
        return env
    return precision


def _bf16_rows(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)


def _bf16_round(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16).to(torch.float32)


def _logit_args(x, w_cur, w_prop, mode, precision):
    """Dispatch for the logit family: (run the kernel?, x, w, w', round in
    the kernel?). On the plain route bf16 is a copy of the rows in bf16 and
    the pair rounded through bf16; the kernel rounds both as it loads them."""
    kernel = use_kernel(mode, x)
    bf16 = resolve_precision(precision) == "bf16"
    w_cur, w_prop = w_cur.to(torch.float32), w_prop.to(torch.float32)
    if bf16 and not kernel:
        return False, _bf16_rows(x), _bf16_round(w_cur), _bf16_round(w_prop), False
    return kernel, x, w_cur.contiguous(), w_prop.contiguous(), bf16 and kernel


def _tuned(family: str, shape, tensor: torch.Tensor, launch: dict) -> dict:
    """Launch parameters for the kernel route: explicit ones win, else the
    tuner's for ``shape`` on ``tensor``'s device."""
    if any(k in launch for k in autotune.DEFAULT_TILES[family]):
        return launch
    merged = autotune.tiles_for(family, tuple(int(d) for d in shape), device=tensor.device)
    merged.update(launch)
    return merged


def _rows(idx, n: int) -> int:
    """Rows a call scores: all ``n`` of the pool, or ``idx``'s."""
    if idx is None:
        return n
    return len(idx) if isinstance(idx, range) else int(idx.shape[-1])


def dispatch_summary() -> str:
    """One attribution line for logs: which path ``auto`` takes for tensors
    on the card, at what precision, with tuning on or off, and what card
    there is."""
    mode = resolve_mode("auto")
    path = {"auto": "cuda-kernels(cuda tensors)/plain(cpu tensors)",
            "always": "cuda-kernels", "never": "plain"}[mode]
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none"
    return (
        f"kernels: dispatch={path} ({ENV_VAR}={os.environ.get(ENV_VAR, 'auto')}) "
        f"precision={resolve_precision()} "
        f"autotune={'on' if autotune.enabled() else 'off'} device={card}"
    )


def logit_delta(x, y, w_cur, w_prop, *, idx=None, mode: str = "auto",
                precision: str = "auto", **launch):
    """BayesLR pair delta for one chain: x (N, D), y (N,), w_* (D,) -> (N,),
    or only rows ``idx`` of the pool -> (m,): an int tensor (m,), or
    ``range(start, stop)`` for a contiguous run, which the kernel reads with
    no index tensor (the exact transition's full pass). ``launch``
    (``warps``) goes to the kernel."""
    kernel, x, w_cur, w_prop, rnd = _logit_args(x, w_cur, w_prop, mode, precision)
    y = y.to(torch.float32)
    if not kernel:
        return ref.logit_delta_ref(*select_rows(x, y, idx), w_cur, w_prop)
    launch = _tuned("logit_delta", (_rows(idx, x.shape[0]), x.shape[-1]), x, launch)
    return _logit_kernel(x, y, w_cur, w_prop, idx=idx, round_bf16=rnd, **launch)


def batched_logit_delta(xg, yg, w_cur, w_prop, *, mode: str = "auto",
                        precision: str = "auto", **launch):
    """Ensemble-batched (K, m) BayesLR delta block on gathered rows."""
    kernel, xg, w_cur, w_prop, rnd = _logit_args(xg, w_cur, w_prop, mode, precision)
    yg = yg.to(torch.float32)
    if not kernel:
        return ref.batched_logit_delta_ref(xg, yg, w_cur, w_prop)
    launch = _tuned("batched_loglik", xg.shape, xg, launch)
    return _batched_kernel(xg, yg, w_cur, w_prop, round_bf16=rnd, **launch)


def gather_and_delta(x, y, idx, w_cur, w_prop, *, mode: str = "auto",
                     precision: str = "auto", **launch):
    """(K, m) BayesLR delta block on rows ``idx`` of the shared pool — one
    call per multi-chain sequential-test round."""
    kernel, x, w_cur, w_prop, rnd = _logit_args(x, w_cur, w_prop, mode, precision)
    y = y.to(torch.float32)
    if not kernel:
        return ref.gather_and_delta_ref(x, y, idx, w_cur, w_prop)
    launch = _tuned("batched_loglik", (*idx.shape, x.shape[-1]), x, launch)
    return _gather_kernel(x, y, idx, w_cur, w_prop, round_bf16=rnd, **launch)


def _ce_args(h, table, targets, mode, precision):
    """Dispatch for the CE family: (run the kernel?, h, table, targets, round
    in the kernel?). On the plain route bf16 is a copy in bf16; the kernel
    rounds fp32 operands as it loads them, so no (K, V, D) table is copied
    on every call."""
    kernel = use_kernel(mode, h)
    bf16 = resolve_precision(precision) == "bf16"
    if bf16 and not kernel:
        h, table = _bf16_rows(h), _bf16_rows(table)
    return kernel, h, table, targets.to(torch.int32), bf16 and kernel


def fused_ce(h, table, targets, *, idx=None, mode: str = "auto", precision: str = "auto",
             **tiles):
    """Per-token log-likelihood of one chain: log softmax(h table^T)[target].
    h (T, D), table (V, D), targets (T,) -> (T,) f32; with ``idx`` (m,),
    rows ``idx`` of the pool h (N, D) and targets (N,) -> (m,). ``tiles``
    (``tile_t``, ``tile_v``) go to the kernel."""
    kernel, h, table, targets, rnd = _ce_args(h, table, targets, mode, precision)
    if not kernel:
        if idx is not None:
            h, targets = h[idx.long()], targets[idx.long()]
        return ref.fused_ce_ref(h, table, targets)
    tiles = _tuned("fused_ce", (_rows(idx, h.shape[0]), h.shape[-1], table.shape[0]), h, tiles)
    return _ce_kernel(h, table, targets, idx=None if idx is None else idx.to(torch.int32),
                      round_bf16=rnd, **tiles)


def batched_fused_ce(h, table, targets, *, mode: str = "auto", precision: str = "auto",
                     **tiles):
    """Ensemble-batched (K, T) per-token log-likelihood: h (K, T, D) against a
    shared (V, D) or per-chain (K, V, D) table."""
    kernel, h, table, targets, rnd = _ce_args(h, table, targets, mode, precision)
    if not kernel:
        return ref.batched_fused_ce_ref(h, table, targets)
    tiles = _tuned("batched_fused_ce", (*h.shape, table.shape[-2]), h, tiles)
    return _batched_ce_kernel(h, table, targets, round_bf16=rnd, **tiles)


def gather_fused_ce(h, targets, idx, table, *, mode: str = "auto", precision: str = "auto",
                    **tiles):
    """(K, m) per-token log-likelihood on rows ``idx`` (K, m) of the shared
    pool h (N, D), targets (N,) — one call per side of a multi-chain round of
    the ``ce`` family."""
    kernel, h, table, targets, rnd = _ce_args(h, table, targets, mode, precision)
    if not kernel:
        return ref.gather_fused_ce_ref(h, targets, idx, table)
    tiles = _tuned("batched_fused_ce", (*idx.shape, h.shape[-1], table.shape[-2]), h, tiles)
    return _gather_ce_kernel(h, targets, idx.to(torch.int32), table, round_bf16=rnd, **tiles)


def _chain_params(like: torch.Tensor, *vals) -> list[torch.Tensor]:
    """Each per-chain parameter as a (K,) float32 tensor on the pools'
    device (one chain's 0-d parameter becomes (1,))."""
    return [torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(-1)
            for v in vals]


def _ar1_args(xt, xp, mode, precision, *vals):
    """Dispatch for the AR(1) family: (run the kernel?, xt, xp, the (K,)
    parameters, round in the kernel?). On the plain route bf16 is a copy of
    the pools in bf16; the kernel rounds fp32 pools as it loads them."""
    kernel = use_kernel(mode, xt)
    bf16 = resolve_precision(precision) == "bf16"
    params = _chain_params(xt, *vals)
    if bf16 and not kernel:
        xt, xp = _bf16_rows(xt), _bf16_rows(xp)
    return kernel, xt, xp, params, bf16 and kernel and xt.dtype == torch.float32


def batched_gaussian_ar1_delta(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop, *,
                               mode: str = "auto", precision: str = "auto", **launch):
    """Ensemble-batched (K, m) AR(1) transition-factor delta block on
    gathered sections (the stochvol sigma^2/phi local sections)."""
    kernel, xt, xp, params, rnd = _ar1_args(xt, xp, mode, precision,
                                            phi_cur, s2_cur, phi_prop, s2_prop)
    if not kernel:
        return ref.batched_gaussian_ar1_delta_ref(xt, xp, *params)
    launch = _tuned("gaussian_ar1", xt.shape, xt, launch)
    return _ar1_batched_kernel(xt, xp, *params, round_bf16=rnd, **launch)


def gather_ar1_delta(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop, *,
                     mode: str = "auto", precision: str = "auto", **launch):
    """(K, m) AR(1) delta block on sections ``idx`` (K, m) of shared (N,) or
    per-chain (K, N) pools — one call per sequential-test round (K = 1 for a
    single chain) — or (1, m) on ``range(start, stop)`` of shared pools, the
    exact transition's full pass, which the kernel reads with no index
    tensor."""
    kernel, xt, xp, params, rnd = _ar1_args(xt, xp, mode, precision,
                                            phi_cur, s2_cur, phi_prop, s2_prop)
    if not kernel:
        return ref.gather_ar1_delta_ref(xt, xp, idx, *params)
    shape = (1, len(idx)) if isinstance(idx, range) else idx.shape
    launch = _tuned("gaussian_ar1", shape, xt, launch)
    return _ar1_gather_kernel(xt, xp, idx, *params, round_bf16=rnd, **launch)


def fy_draw(u, idx, pos, size, m: int, active=None, *, mode: str = "auto", m_eff=None):
    """The m partial Fisher–Yates swaps of every active chain, in place on
    ``idx`` (see :mod:`repro_torch.kernels.fy_draw`); ``m_eff`` (K,) int32
    bounds each chain's valid lanes and advance. Returns
    ``(indices, valid, new_pos)``."""
    fn = _fy_kernel if use_kernel(mode, idx) else fy_draw_ref
    return fn(u, idx, pos, size, m, active, m_eff)


def pgibbs_sweep(noise, u, u_pick, obs, h, phi, s2, *, h0: float = 0.0, mode: str = "auto"):
    """One conditional-SMC sweep of every chain's series from given random
    numbers (see :mod:`repro_torch.kernels.pgibbs`) -> new paths (K, S, T)."""
    fn = _pgibbs_kernel if use_kernel(mode, h) else pgibbs_sweep_ref
    return fn(noise, u, u_pick, obs, h, phi, s2, h0=h0)


def gibbs_z_sweep(x, y, z, w, log_alpha, stats, points, nrm, u, prior, w_sd: float, *,
                  mode: str = "auto") -> None:
    """One collapsed Gibbs sweep of every replica's assignments from given
    random numbers, in place on z, w and the statistics (see
    :mod:`repro_torch.kernels.gibbs_z`)."""
    fn = _gibbs_z_kernel if use_kernel(mode, z) else gibbs_z_sweep_ref
    fn(x, y, z, w, log_alpha, stats, points, nrm, u, prior, w_sd)


def t_test_round(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds,
                 rounds, done, decision, pval, *, mode: str = "auto") -> None:
    """One lock-step sequential-test round, in place (see
    :mod:`repro_torch.kernels.t_test_round`); ``n_total`` is a number or a
    (K,) float32 tensor of per-chain pool sizes."""
    fn = _t_test_kernel if use_kernel(mode, l) else t_test_round_ref
    fn(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds, rounds, done,
       decision, pval)


launches = _build.LAUNCHES
slot_launches = _build.SLOT_LAUNCHES
reset_launches = _build.reset_launches
