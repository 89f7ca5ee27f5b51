"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each hand kernel under :mod:`repro_torch.kernels` has its plain version here
or beside its wrapper. The CPU tests run them, ``chip_smoke.py`` holds the
kernels against them on the card, and the dispatch in
:mod:`repro_torch.kernels.ops` takes them only for tensors on the CPU.

This module also owns the float32 arithmetic of the sequential test's round
(Welford merge, Student-t tail) so that :mod:`repro_torch.core.stats`, the
round kernel's plain version and the CUDA source share one definition.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _softplus(a: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(a)) in the stable form ``logaddexp(0, a)`` uses."""
    return torch.clamp_min(a, 0.0) + torch.log1p(torch.exp(-torch.abs(a)))


def logit_loglik(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-observation log Logit(y | x, w) = -log(1 + exp(-y x.w)).

    w: (D,), x: (..., D), y: (...) in {-1, +1} -> (...) f32.
    """
    return -_softplus(-y * (x.to(F32) @ w.to(F32)))


def batched_logit_delta_ref(
    xg: torch.Tensor, yg: torch.Tensor, w_cur: torch.Tensor, w_prop: torch.Tensor
) -> torch.Tensor:
    """l[k, i] = log sig(y x.w'_k) - log sig(y x.w_k), accumulated in fp32.

    xg: (K, m, D) f32 or bf16, yg: (K, m), w_*: (K, D) -> (K, m) f32.

    Each row's dot is a product and a sum over its own D values, so a row's
    bits do not depend on K, m or where the row sits: a (K, m) block split
    over a mesh's slots gives the whole block's bits. (A batched matmul
    picks its order of summation by the block's shape.)
    """
    xf = xg.to(F32)
    z_c = (xf * w_cur.to(F32)[:, None, :]).sum(-1)
    z_p = (xf * w_prop.to(F32)[:, None, :]).sum(-1)
    y = yg.to(F32)
    return -_softplus(-y * z_p) + _softplus(-y * z_c)


def logit_delta_ref(
    x: torch.Tensor, y: torch.Tensor, w_cur: torch.Tensor, w_prop: torch.Tensor
) -> torch.Tensor:
    """Single-chain form: x (N, D), y (N,), w_* (D,) -> (N,) f32. The same
    arithmetic as the K = 1 row of :func:`batched_logit_delta_ref`."""
    return batched_logit_delta_ref(x[None], y[None], w_cur[None], w_prop[None])[0]


def gather_and_delta_ref(x, y, idx, w_cur, w_prop) -> torch.Tensor:
    """Gather each chain's rows ``idx`` (K, m) from the shared (N, D) pool,
    then the batched delta."""
    idx = idx.long()
    return batched_logit_delta_ref(x[idx], y[idx], w_cur, w_prop)


def lane_order_cdf(logw: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of softmax(logw) over the last axis (P
    particles or K_max clusters), with the float32 additions of a warp in
    its order (the particle-Gibbs and the collapsed Gibbs sweep kernels).
    Entry i = g + G r sits on lane g of a group of G lanes (G the smallest
    power of two >= P, at most 32): the sum is each lane's partial over r,
    then an xor butterfly across the group; the scan adds across the
    group's lanes (Hillis-Steele) within each chunk r, plus the total of the
    chunks before. A kernel that runs the butterfly and the scan over all
    32 lanes with zeros past P adds the same nonzero terms in the same
    order. So kernel and plain version pick alike wherever their
    exponentials agree."""
    p = logw.shape[-1]
    g = 1
    while g < min(p, 32):
        g *= 2
    r_n = -(-p // g)
    e = torch.exp(logw - logw.amax(-1, keepdim=True))
    pad = e.new_zeros(e.shape[:-1] + (r_n * g - p,))
    lanes = torch.cat([e, pad], -1).unflatten(-1, (r_n, g))  # (..., r, lane)
    tot = lanes[..., 0, :]
    for r in range(1, r_n):
        tot = tot + lanes[..., r, :]
    lane = torch.arange(g, device=e.device)
    off = g // 2
    while off:
        tot = tot + tot[..., lane ^ off]
        off //= 2
    v = lanes / tot[..., None, :1]  # every lane holds the same total
    off = 1
    while off < g:
        v = torch.where(lane >= off, v + torch.roll(v, off, -1), v)
        off *= 2
    carry = torch.zeros_like(tot[..., :1])
    chunks = []
    for r in range(r_n):
        chunks.append(carry + v[..., r, :])
        carry = carry + v[..., r, g - 1:]
    return torch.cat(chunks, -1)[..., :p].contiguous()



# ---------------------------------------------------------------------------
# The LM likelihood: per-token log softmax(h W^T)[target].
#
# The operands are upcast before the product, so the logits are float32 from
# bf16 inputs too: what the Pallas kernel computes (preferred_element_type),
# where the JAX package's own oracle rounds the logits to the input dtype.
# ---------------------------------------------------------------------------


def _ce_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return tgt - logz


def fused_ce_ref(h: torch.Tensor, table: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """h (T, D), table (V, D), targets (T,) -> (T,) f32."""
    return _ce_from_logits(h.to(F32) @ table.to(F32).T, targets)


def batched_fused_ce_ref(h: torch.Tensor, table: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """h (K, T, D); table (V, D) shared or (K, V, D) per chain; targets
    (K, T) -> (K, T) f32."""
    hf, tab = h.to(F32), table.to(F32)
    logits = hf @ tab.T if tab.ndim == 2 else torch.bmm(hf, tab.transpose(1, 2))
    return _ce_from_logits(logits, targets)


def gather_fused_ce_ref(h: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (K, m) of the shared pool h (N, D), targets (N,), scored
    against a shared (V, D) or per-chain (K, V, D) table -> (K, m) f32."""
    idx = idx.long()
    return batched_fused_ce_ref(h[idx], table, targets[idx])


# ---------------------------------------------------------------------------
# Stochastic volatility: the AR(1) transition factor and the observation
# factor, shared by the MH delta and the particle-Gibbs sweep.
# ---------------------------------------------------------------------------

LOG2PI = 1.8378770664093453
S2_FLOOR = 1e-12  # sigma^2 clip: out-of-support proposals stay finite


def ar1_propagate(h_prev, noise, phi, s2) -> torch.Tensor:
    """AR(1) transition sample ``phi * h_prev + sqrt(clip(s2)) * z``: the
    sampling twin of :func:`gaussian_ar1_delta_ref`'s density."""
    return phi * h_prev + torch.sqrt(torch.clamp_min(s2, S2_FLOOR)) * noise


def sv_obs_loglik(x, h) -> torch.Tensor:
    """Stochastic-volatility observation factor log N(x | 0, exp(h)),
    elementwise: the particle weight of the pgibbs sweep."""
    return -0.5 * (x * x * torch.exp(-h) + h + LOG2PI)


def gaussian_ar1_delta_ref(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop) -> torch.Tensor:
    """AR(1) transition-factor delta (the stochvol local sections):

        l_i = log N(xt_i | phi' xp_i, s2') - log N(xt_i | phi xp_i, s2)

    in float32; the 2 pi constant cancels in the pair, and sigma^2 is clipped
    at 1e-12 so out-of-support proposals (rejected by the -inf prior) still
    give finite local values. xt, xp: (..., m) f32 or bf16; the parameters
    broadcast against them -> (..., m) f32.
    """
    s2c = torch.clamp_min(torch.as_tensor(s2_cur, dtype=F32), S2_FLOOR)
    s2p = torch.clamp_min(torch.as_tensor(s2_prop, dtype=F32), S2_FLOOR)
    xt, xp = xt.to(F32), xp.to(F32)
    lc = -0.5 * ((xt - phi_cur * xp) ** 2 / s2c + torch.log(s2c))
    lp = -0.5 * ((xt - phi_prop * xp) ** 2 / s2p + torch.log(s2p))
    return lp - lc


def batched_gaussian_ar1_delta_ref(xt, xp, phi_cur, s2_cur, phi_prop, s2_prop) -> torch.Tensor:
    """Ensemble-batched AR(1) delta: xt, xp (K, m), parameters (K,) -> (K, m)."""
    col = lambda v: torch.as_tensor(v, dtype=F32, device=xt.device)[:, None]
    return gaussian_ar1_delta_ref(xt, xp, col(phi_cur), col(s2_cur), col(phi_prop), col(s2_prop))


def check_range(idx: range, n: int) -> None:
    """Raise unless ``idx`` is a run of step 1 within a pool of ``n`` rows."""
    if idx.step != 1 or not 0 <= idx.start <= idx.stop <= n:
        raise ValueError(f"idx must be a range of step 1 within [0, {n}), got {idx}")


def gather_pool(pool, idx) -> torch.Tensor:
    """Rows ``idx`` (K, m) of a shared (N,) pool or of per-chain (K, N)
    pools; ``range(start, stop)`` is a run of a shared pool, (1, m)."""
    if isinstance(idx, range):
        if pool.ndim != 1:
            raise ValueError(f"a range of sections reads a shared (N,) pool, "
                             f"got {tuple(pool.shape)}")
        check_range(idx, pool.shape[0])
        return pool[None, idx.start:idx.stop]
    idx = idx.long()
    return pool[idx] if pool.ndim == 1 else pool.gather(1, idx)


def gather_ar1_delta_ref(xt, xp, idx, phi_cur, s2_cur, phi_prop, s2_prop) -> torch.Tensor:
    """Gather each chain's sections ``idx`` (K, m) from the (N,) or (K, N)
    pools (or slice a ``range`` of the (N,) pools), then the batched delta."""
    return batched_gaussian_ar1_delta_ref(gather_pool(xt, idx), gather_pool(xp, idx),
                                          phi_cur, s2_cur, phi_prop, s2_prop)


# ---------------------------------------------------------------------------
# Student-t tail: JAX's float32 regularized incomplete beta, step for step.
#
# ``repro.core.stats.student_t_sf`` calls ``jax.scipy.special.betainc`` in
# float32. That is a Lentz-Thompson-Barnett continued fraction capped at 200
# iterations with small = threshold = eps/2, after the symmetry swap at
# x >= (a+1)/(a+b+2), times a prefactor built from XLA's Lanczos lgamma. Its
# error against the exact tail grows with df (2e-5 at df=99, 6e-2 at
# df=1e5), so an exact tail would disagree with the reference's decisions.
# The port computes the same recurrence. It stops each element at its own
# convergence, as the reference does for one chain.
# ---------------------------------------------------------------------------

LANCZOS_G = 7.0
LANCZOS_COEFFS = (
    676.520368121885098567009190444019,
    -1259.13921672240287047156078755283,
    771.3234287776530788486528258894,
    -176.61502916214059906584551354,
    12.507343278686904814458936853,
    -0.13857109526572011689554706,
    9.984369578019570859563e-6,
    1.50563273514931155834e-7,
)
BETAINC_MAX_ITERS = 200
EPS_HALF = float(torch.finfo(F32).eps) / 2.0
TINY2 = float(torch.finfo(F32).tiny) * 2.0


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=F32, device=like.device)


def lgamma_fp32(inp: torch.Tensor) -> torch.Tensor:
    """XLA's float32 Lanczos lgamma (g = 7, 8 terms), in the operation order
    of XLA's compiled HLO: the base coefficient rounds to 1, each term is
    c_i / (z + (i + 1)), and log t = log1p(z * (1/7.5)) + log 7.5, with
    z = x - 1. Below 0.5 XLA reflects, lgamma(x) = log pi - log|sin(pi x)|
    - lgamma(1 - x), with z = -x and sin(pi x) taken on the fractional part
    folded into [0, 0.5] (the DP concentration alpha reaches there). The
    t-test reaches only a = df/2 >= 0.5 and b = 0.5, where the reflection's
    selects leave the Lanczos value as it is."""
    reflect = inp < 0.5
    z = torch.where(reflect, -inp, inp + (-1.0))
    coeffs = torch.tensor(LANCZOS_COEFFS, dtype=F32, device=inp.device)
    acc = coeffs[0] / (z + 1.0) + 1.0
    for i in range(1, len(LANCZOS_COEFFS)):
        acc = acc + coeffs[i] / (z + float(i + 1))
    log_t = torch.log1p(z * _c(1.0 / (LANCZOS_G + 0.5), inp)) + _c(math.log(LANCZOS_G + 0.5), inp)
    t = z + (LANCZOS_G + 0.5)
    log_sqrt_2pi = _c((math.log(2.0) + math.log(math.pi)) / 2.0, inp)
    log_y = ((z + 0.5) - t / log_t) * log_t + log_sqrt_2pi + torch.log(acc)
    frac = inp.abs() - torch.floor(inp.abs())
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    denom = torch.log(torch.sin(_c(math.pi, inp) * frac))
    refl = torch.where(torch.isfinite(denom), (_c(math.log(math.pi), inp) - denom) - log_y, -denom)
    out = torch.where(reflect, refl, log_y)
    return torch.where(torch.isinf(inp), torch.full_like(out, math.inf), out)


def betainc_fp32(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 lgamma=lgamma_fp32, check_every: int | None = None) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b) by JAX's float32 recurrence.
    ``lgamma`` is the log-gamma of the prefactor (a test hook: the prefactor
    is where the tail's rounding error lives at large a). The recurrence
    stops once every element has converged, looked at every
    ``check_every`` steps (default: every step on the CPU, every 16th on
    the card, where a look is a synchronisation); a converged element is
    frozen, so every choice gives the same bits as running the cap."""
    a, b, x = torch.broadcast_tensors(a.to(F32), b.to(F32), x.to(F32))
    small = _c(EPS_HALF, x)
    a_is_zero = (a == 0) | (b == math.inf)
    b_is_zero = (b == 0) | (a == math.inf)
    x_is_zero, x_is_one = x == 0, x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_is_zero & b_is_zero) | is_nan

    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    # partial denominators: 0 at iteration 0, else 1; h starts at `small`.
    # A converged element keeps its h; its c and d may run on, unused.
    apb = a + b
    h = torch.full_like(x, EPS_HALF)
    c = h.clone()
    d = torch.zeros_like(x)
    live = torch.ones_like(x, dtype=torch.bool)
    if check_every is None:
        check_every = 1 if x.device.type == "cpu" else 16
    for it in range(1, BETAINC_MAX_ITERS):
        if it == 1:
            num = torch.ones_like(x)
        else:
            mm = float((it - 1) // 2)
            if it % 2 == 0 and mm == 0:
                num = -apb * x / (a + 1.0)
            elif it % 2 == 0:
                a2m = a + 2.0 * mm
                num = -(a + mm) * (apb + mm) * x / (a2m * (a2m + 1.0))
            else:
                a2m = a + 2.0 * mm
                num = mm * (b - mm) * x / ((a2m - 1.0) * a2m)
        c = 1.0 + num / c
        c = torch.where(c.abs() < small, small, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < small, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = torch.where(live, h * delta, h)
        live = live & ((delta - 1.0).abs() >= small)
        if it % check_every == 0 and not bool(live.any()):
            break

    lg_b, lg_ab, lg_a = lgamma(torch.stack([b, a + b, a]))  # one pass for the three
    lbeta_small_a = lg_b - lg_ab
    lbeta = lg_a + lbeta_small_a
    factor = torch.where(
        a < TINY2,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    result = h * factor
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, torch.zeros_like(result), result)
    result = torch.where(result_is_one, torch.ones_like(result), result)
    return torch.where(result_is_nan, torch.full_like(result, math.nan), result)


def student_t_sf_ref(t: torch.Tensor, df: torch.Tensor, lgamma=lgamma_fp32) -> torch.Tensor:
    """P(T > t) for T ~ Student-t(df), t >= 0: 0.5 I_{df/(df+t^2)}(df/2, 1/2)."""
    t = torch.as_tensor(t, dtype=F32)
    df = torch.as_tensor(df, dtype=F32, device=t.device)
    x = df / (df + t * t)
    return 0.5 * betainc_fp32(df / 2.0, torch.full_like(x, 0.5), x, lgamma)


# ---------------------------------------------------------------------------
# One sequential-test round: masked Welford merge + the stopping rule.
# ---------------------------------------------------------------------------


def welford_merge_ref(count, mean, m2, values, mask=None):
    """Chan's merge of a batch (last axis) into (count, mean, m2), float32,
    in the reference's operation order. ``mask`` selects valid entries; an
    empty batch leaves the state untouched."""
    values = values.to(F32)
    if mask is None:
        nb = torch.full_like(mean, float(values.shape[-1]))
        mb = values.mean(-1)
        m2b = ((values - mb[..., None]) ** 2).sum(-1)
    else:
        mask = mask.to(F32)
        nb = mask.sum(-1)
        mb = (values * mask).sum(-1) / torch.clamp_min(nb, 1.0)
        m2b = (mask * (values - mb[..., None]) ** 2).sum(-1)
    na = count
    n = na + nb
    delta = mb - mean
    safe_n = torch.clamp_min(n, 1.0)
    new_mean = mean + delta * nb / safe_n
    new_m2 = m2 + m2b + delta * delta * na * nb / safe_n
    keep = nb > 0
    return (torch.where(keep, n, na), torch.where(keep, new_mean, mean),
            torch.where(keep, new_m2, m2))


def welford_std_ref(count, m2):
    return torch.sqrt(m2 / torch.clamp_min(count - 1.0, 1.0))


def finite_population_std_err_ref(count, m2, population):
    """s = s_l / sqrt(n) * sqrt(1 - (n-1)/(N-1))   (Alg. 2, step 7)."""
    big_n = torch.as_tensor(population, dtype=F32, device=count.device)
    corr = torch.clamp(1.0 - (count - 1.0) / torch.clamp_min(big_n - 1.0, 1.0), 0.0, 1.0)
    return welford_std_ref(count, m2) / torch.sqrt(torch.clamp_min(count, 1.0)) * torch.sqrt(corr)


def round_decision_ref(count, mean, m2, mu0, n_total, epsilon):
    """Alg. 2 steps 7-14 on the running accumulator: returns
    ``(decision, pvalue, test_ok, exhausted)``."""
    exhausted = count >= n_total
    s = finite_population_std_err_ref(count, m2, n_total)
    df = torch.clamp_min(count - 1.0, 1.0)
    pos = s > 0
    tstat = torch.where(pos, torch.abs(mean - mu0) / torch.clamp_min(s, 1e-30),
                        torch.full_like(s, math.inf))
    pval = torch.where(pos, 2.0 * student_t_sf_ref(tstat, df), torch.zeros_like(s))
    test_ok = (welford_std_ref(count, m2) > 0) & (pval < epsilon)
    return mean > mu0, pval, test_ok, exhausted
