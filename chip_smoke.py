#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit (``nvcc``). The hand kernels build from ``src/repro_torch/kernels/csrc``
into ``build/repro_torch_kernels/`` at first use. Phases:

  A  every kernel against its plain PyTorch version (fp32 and bf16) at the
     main path's shapes, with kernel, plain and bound times (and the library
     composite's for the logit and CE kernels); the Fisher–Yates draw's and
     the round op's edge cases; the launch floor (``torch.cuda._sleep(0)``
     in the same timing harness);
  B  one chain: BayesLR at N=12214, D=50, 1000 subsampled transitions and
     20 exact ones;
  B' the same chain from B's last sample under MALA (the gradient of the
     first 100 rows, rescaled): a short sweep of the step, then 200
     transitions;
  C  K=32 chains in lock-step (``ChainEnsemble`` as
     ``bayeslr.run_posterior_ensemble`` drives it), then the fused route
     against ``fused_kernels="never"`` on 200 fixed proposals;
  K  C's configuration with ``stepping="masked"`` for C's first 250 steps:
     C's samples and infos bit for bit, in fewer supersteps than C's
     lock-step rounds over those steps;
  L  the adaptive form: masked stepping with ``ScheduleConfig(epsilon_max=0.2)``
     and the Fisher–Yates sampler (the bounded draw, per-chain m_eff), K=32,
     1000 steps, the knobs held to their bounds; then 20 steps through the
     fused route against ``fused_kernels="never"``;
  D  the paper's Fig. 5 on the card: evaluated sections per transition at
     fixed theta for N = 1e4, 1e5, 1e6;
  E  stochastic volatility (Sec. 4.3), one chain: S=200 series x T=5, the
     paper's cycle (particle-Gibbs sweep with P=25, then subsampled-MH moves
     on phi and sigma^2 with the Fisher–Yates sampler), 500 cycle steps;
  F  the same cycle on K=32 chains in lock-step, 500 steps, then the fused
     route against ``fused_kernels="never"`` on 200 fixed phi proposals;
  G  the sublinear section count on dependent sections: h fixed at the true
     paths, the phi move at fixed theta for S = 200, 2000, 20000
     (N = 1e3, 1e4, 1e5), with one exact transition's time beside it;
  A  (joint DP mixture) the Gibbs sweep kernel against its plain version at
     K = 8 and K = 1 (N = 10 000, K_max = 20, P = 5 000, D = 2), the round
     op with a ragged per-chain n_total and with a null one against saved
     bits, the logit delta on [x, 1] (D + 1 = 3);
  M  the joint DP mixture (Sec. 4.2), one replica, the reference's full
     setting (N = 10 000, 1 000 test points, K_max = 20, Fig. 7's cycle with
     batch 100, epsilon 0.1, sigma 0.3, half the points a sweep, 10 w moves
     a cycle), 30 cycles: cycles/s, each component's time, the w moves'
     evaluated fraction and rounds, test accuracy before and after; then 20
     exact against 20 subsampled w moves from the final state;
  N  the same program on K = 8 lock-step replicas, 30 cycles; then an
     ensemble of one replica against the sequential run, bit for bit;
  A  (CE) the fused CE kernel against its plain version and the library
     composite (torch.matmul + F.cross_entropy): ragged and extreme shapes,
     fp32 and bf16, shared and per-chain tables, the gather form, and the
     path's shapes (m=100 of N=8128 at D=4096, V=65024; K=1 and K=8);
  H  the LM launcher (``repro_torch.launch.train``) for chatglm3-6b at full
     width and depth with its defaults: 20 subsampled and 3 exact steps,
     then a run stopped by an injected failure and resumed from its
     checkpoint, against the uninterrupted run;
  I  the ``ce`` family on one chain: the fp32 unembedding table of H's model
     under subsampled MH over N = 64 x 127 next-token sections (final hidden
     states of MarkovStream sequences), 50 transitions, then the fused route
     against ``fused_kernels="never"`` on 20 fixed proposals;
  J  the same target on K=8 lock-step chains with per-chain (8, V, D) fp32
     tables, 20 steps;
  P  compiled programs (``repro_torch.ppl``): the BayesLR program on B's
     data, compiled onto the ``logit`` family, held bit for bit to B's
     hand-built target on C's 200 fixed proposals, then K=32 lock-step
     chains at C's settings for 200 steps (the pair-delta kernel) and one
     chain for 200 transitions (the graph route); an AR(1) program over
     N = 1e5 transition factors, compiled onto ``gaussian_ar1``, K=32 chains
     for 30 steps with the Fisher–Yates sampler, then the fused route
     against ``fused_kernels="never"`` on 200 fixed proposals;
  S  the Sec. 3.3 safeguard (``trial_run_report``) from B's last sample on
     B's hand-built target, then on P's compiled program: 20 trials, batch
     100, epsilon 0.05;
  Q  posterior serving through ``repro_torch.launch.serve.serve_posterior``
     at the front end's non-smoke defaults (K=8, refresh 64, window 128,
     min_draws 512, 8-row requests, max_batch 16, deadline 250 ms): BayesLR
     (N=12 000, D=20, batch 500) for 400 requests (Q), the same with a
     background refresh, then the refresh's rate alone and beside a query
     loop (Q-bg), chunked refreshes against one offline run and a checkpoint
     round trip on the card, bit for bit (Q-resume), then stochvol, the
     joint DP mixture and the compiled BayesLR program at their non-smoke
     sizes for 400 requests each (Q-sv, Q-jdpm, Q-ppl); every served batch
     of a default class is held to float64 numpy on the same draws, and in
     Q, Q-sv, Q-jdpm and Q-ppl the first and tenth call of each kernel
     wrapper at each call shape is copied as it runs and replayed through
     the kernel and its plain version at phase A's tolerances;
  R  the serving fleet through ``repro_torch.launch.serve.serve_fleet`` at
     Q's settings, 400 requests a cell: ``--fleet --replicas 2`` (R: a
     replica's answer bit for bit its writer's), ``--subposterior 4
     --combine consensus --stream`` (R-sub: 750 rows appended mid-serve
     reach all four writers, every answer comes from the combined window,
     which equals ``combine_snapshots`` of the writers' snapshots, and a
     combined batch is held to float64 numpy), the conjugate harness of
     the reference's tests on the card at P = 1, 2, 4 (R-truth), then the
     fleet's background refresh beside 8 requests every 5 ms for 10 of its
     commits, with replicas in this process (R-bg) and each in a spawned
     process (R-proc), against its rate alone with the replicas up and
     after they closed; R's and R-sub's kernel calls are held against
     plain as Q's are.
  O  observability and the closed loop at Q's settings: ``serve_posterior``
     with ``--stats-addr --obs-dir --alerts --trace-dir`` (O: STATS_OK,
     ALERTS_OK, TRACE_OK and SERVE_OK with Q's parity, the streams and
     summary on disk, the fraction of data touched equal to the snapshot's
     sections over N, the run rendered by ``repro_torch.obs.dash``), beside
     the same serve with no obs flag (plain, obs, obs, plain), and the
     refresh with no stats server, with one idle and with one polled;
     ``--fleet --soak --autoscale --alerts`` for 30 s (O-soak: a replica
     killed and restarted mid-load, an overload burst scaled up, a quiesce
     scaled down, every replica bit for bit its writer; each join timed);
     ``--fleet --soak --replica-transport proc --soak-seconds 8`` (O-kill-proc:
     a SIGKILL, the restart's seconds and the card's memory around it).
     O's and O-soak's kernel calls are held against plain as R's are.

Phase A also holds the bounded Fisher–Yates draw (ragged per-chain m_eff,
m_max = 100 and 400) against its plain version. Launch counts are set to 0
before each of B-O and read after it; every
kernel must have launched on the path that runs it. Any failed check exits
nonzero. The last line is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels with their launches, errors and times. The full report
goes to ``chiprun_out/chip_smoke.json``. ``--profile`` instead runs short
windows of phases B, C, P, K, L, E, F, M, N, H, I, J and O (obs flags off
and on) under ``torch.profiler`` and reports
the device's idle share (``chip_profile.json`` beside the report); the windows of
H, I and J use the launcher's initial model. Then ``profile_q_bg`` times Q's
background refresh beside queries and beside other host loads (the host
timeline of both threads, the GIL's switch interval, the device's idle share).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
SF_ITER_FLOPS = 20  # flops of one continued-fraction step of the t-test
COLD_BYTES = 200_000_000  # four times the H100's 50 MB L2


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def time_ms(fn, reps: int, setup=None, queued: bool = True) -> tuple[float, float]:
    """(device ms, host ms) of one ``fn()`` call.

    Device time: ``reps`` calls are queued behind a sleep kernel long enough
    to cover their enqueueing, so the card runs them back to back; CUDA
    events around the run give the device time per call (gaps between
    launches included). The launch queue holds about a thousand kernels, so
    ``reps`` times the kernels per call must stay well below that. Host
    time: the wall time per call of the same loop run alone (the launch
    overhead every call pays). ``setup`` (a state reset for in-place ops)
    runs before each call and is timed with it. ``queued=False`` is for a
    call of thousands of launches, which no queue holds: both numbers are
    then the wall time per call.
    """
    import torch

    for _ in range(2):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    if not queued:
        return host_ms, host_ms
    # the sleep covers ~3x the measured enqueue time at <= 2 GHz; when the
    # host is slower this time (its cores are shared), the run is repeated
    # behind a sleep twice as long, up to three times
    for attempt in range(3):
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(int(3 * 2 ** attempt * host_ms * 1e-3 * reps * 2e9))
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        enqueue_s = time.perf_counter() - t0
        b.record()
        b.synchronize()
        if enqueue_s * 1e3 < e0.elapsed_time(a):
            return a.elapsed_time(b) / reps, host_ms
    raise CheckFailed("device timing: enqueueing outlasted the sleep in front of it three times")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase A: kernels against plain versions
# ---------------------------------------------------------------------------


def logit_library(x, y, w, wp, idx=None, rows=None):
    """The library composite of the pair delta (the yardstick the port never
    calls): the rows (``index_select`` of ``idx`` (K, m), a slice ``rows``,
    or the (K, m, D) slab as it is), one product against the stacked (D, 2)
    pair (``bmm``/``matmul``), ``softplus`` and the difference. bf16 rows
    multiply a bf16 pair and round z to bf16, the library's own bf16 route."""
    import torch
    import torch.nn.functional as F

    w2 = torch.stack([w, wp], -1).to(x.dtype)  # (K, D, 2)
    if idx is not None:
        k, m = idx.shape
        flat = idx.reshape(-1)
        z = torch.bmm(x.index_select(0, flat).view(k, m, -1), w2)
        yy = y.index_select(0, flat).view(k, m, 1)
    elif x.ndim == 3:
        z, yy = torch.bmm(x, w2), y[..., None]
    else:
        xs, yy = (x, y[:, None]) if rows is None else (x[rows.start:rows.stop],
                                                       y[rows.start:rows.stop, None])
        z = torch.matmul(xs, w2[0])
    a = F.softplus(-yy * z.float())
    return a[..., 0] - a[..., 1]


def phase_a_logit(report):
    """The pair-delta kernel (``logit_delta``, ``batched_logit_delta``)
    against its plain version and the library composite, at the main path's
    shapes: the rounds of B (m=100 of N=12214, D=50) and D (m=100 of N=1e4,
    1e5, 1e6, D=2), C's gathered K=32 round, L's (K=32, m_max=400), and the
    exact transition's full
    pass in the form ``exact_decide`` takes (a ``range`` of the pool: B's
    N=12214 at D=50, D's N=1e4..1e6 at D=2), with the full pool at N=1e6,
    D=50 beside them. A pool smaller than the card's L2 (50 MB) stays there
    across back-to-back calls, so each full pass of one is also timed cold:
    the calls cycle through copies of the pool that hold ``COLD_BYTES`` in
    all, and each call reads a copy that later ones pushed out of L2."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {"fp32": 1e-5, "bf16": 1e-5}  # both compare fp32 sums of the same products

    def pool(n, d):
        x = torch.randn(n, d, generator=gen, device=dev) / np.sqrt(d)
        y = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 1.0, -1.0)
        return x, y

    def weights(k, d):
        w = 2.0 * torch.randn(k, d, generator=gen, device=dev)
        return w, w + 0.05 * torch.randn(k, d, generator=gen, device=dev)

    print("phase A: the pair-delta kernel against its plain version and the library composite")
    cases = []
    pools = {}
    # logit_delta: rows of the pool (B's and D's rounds), the exact pass over
    # a range of it, and the full pool; "main" marks the kernel line's shape
    for (n, d, form, precs) in [(12214, 50, "rounds", ("fp32", "bf16")),
                                (10_000, 2, "rounds", ("fp32",)),
                                (100_000, 2, "rounds", ("fp32",)),
                                (1_000_000, 2, "rounds", ("fp32",)),
                                (12214, 50, "range", ("fp32", "bf16")),
                                (10_000, 2, "range", ("fp32",)),
                                (100_000, 2, "range", ("fp32",)),
                                (1_000_000, 2, "range", ("fp32",)),
                                (1_000_000, 50, "range", ("fp32", "bf16")),
                                (12214, 50, "pool", ("fp32", "bf16")),
                                (1_000_000, 50, "pool", ("fp32", "bf16"))]:
        if (n, d) not in pools:
            pools[n, d] = pool(n, d)
        x, y = pools[n, d]
        w, wp = weights(1, d)
        lib_idx = lib_rows = None
        if form == "rounds":
            idx = torch.randint(0, n, (100,), generator=gen, device=dev, dtype=torch.int32)
            lib_idx, what = idx[None], f"rounds: m=100 of N={n} D={d}"
        elif form == "range":
            idx = lib_rows = range(0, n)
            what = f"full pass (range): N={n} D={d}"
        else:
            idx, what = None, f"full pool: N={n} D={d}"
        rows = n if idx is None or isinstance(idx, range) else idx.shape[0]
        reads_idx = idx is not None and not isinstance(idx, range)
        for prec in precs:
            xx = x.to(torch.bfloat16) if prec == "bf16" else x
            bx = 2 if prec == "bf16" else 4
            run = lambda xx=xx, y=y, w=w, wp=wp, idx=idx, p=prec: ops.logit_delta(
                xx, y, w[0], wp[0], idx=idx, precision=p)
            plain = lambda xx=xx, y=y, w=w, wp=wp, idx=idx, p=prec: ops.logit_delta(
                xx, y, w[0], wp[0], idx=idx, precision=p, mode="never")
            lib = lambda xx=xx, y=y, w=w, wp=wp, i=lib_idx, r=lib_rows: logit_library(
                xx, y, w, wp, idx=i, rows=r)
            byts = rows * (d * bx + 4 + 4 + (4 if reads_idx else 0)) + 2 * d * 4
            cold = None
            if form != "rounds" and byts < COLD_BYTES:
                cold = ((xx, y), lambda cx, cy, w=w, wp=wp, idx=idx, p=prec: ops.logit_delta(
                    cx, cy, w[0], wp[0], idx=idx, precision=p))
            cases.append(("logit_delta", f"{what} {prec}", prec, run, plain, lib, byts,
                          rows * (4 * d + 30), (form, n, d, prec) == ("rounds", 12214, 50, "fp32"),
                          cold))
    # batched (pre-gathered) and gathered forms; "fp32 x, precision bf16"
    # rounds the rows and the pair in the kernel
    x, y = pools[12214, 50]
    for (k, m, d) in [(32, 100, 50), (32, 400, 50), (32, 1000, 50), (1, 7, 50)]:
        w, wp = weights(k, d)
        idx = torch.randint(0, 12214, (k, m), generator=gen, device=dev, dtype=torch.int32)
        for prec in ("fp32", "bf16", "fp32 x, precision bf16"):
            if prec.startswith("fp32 x") and (k, m) != (32, 100):
                continue
            p = prec.split()[-1]
            xp = x.to(torch.bfloat16) if prec == "bf16" else x
            xg, yg = xp[idx.long()].contiguous(), y[idx.long()].contiguous()
            bx = 2 if prec == "bf16" else 4
            cases.append(("batched_logit_delta", f"batched K={k} m={m} D={d} {prec}", p,
                          lambda xg=xg, yg=yg, w=w, wp=wp, p=p: ops.batched_logit_delta(xg, yg, w, wp, precision=p),
                          lambda xg=xg, yg=yg, w=w, wp=wp, p=p: ops.batched_logit_delta(xg, yg, w, wp, precision=p, mode="never"),
                          lambda xg=xg, yg=yg, w=w, wp=wp: logit_library(xg, yg, w, wp),
                          k * m * (d * bx + 4 + 4) + 2 * k * d * 4, k * m * (4 * d + 30), False,
                          None))
            cases.append(("batched_logit_delta", f"gather K={k} m={m} D={d} {prec}", p,
                          lambda xp=xp, y=y, idx=idx, w=w, wp=wp, p=p: ops.gather_and_delta(xp, y, idx, w, wp, precision=p),
                          lambda xp=xp, y=y, idx=idx, w=w, wp=wp, p=p: ops.gather_and_delta(xp, y, idx, w, wp, precision=p, mode="never"),
                          lambda xp=xp, y=y, idx=idx, w=w, wp=wp: logit_library(xp, y, w, wp, idx=idx),
                          k * m * (d * bx + 4 + 4 + 4) + 2 * k * d * 4, k * m * (4 * d + 30),
                          (k, m, prec) == (32, 100, "fp32"), None))
    for name, label, prec, run, plain, lib, byts, flops, main_shape, cold in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= tol[prec], f"{name} {label} within {tol[prec]:g} of its plain version")
        # one launch per kernel call, ~7 per library call and ~25 per plain
        # call: keep each timed queue near 300 launches
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 10)
        lib_ms, _ = time_ms(lib, 30)
        cold_ms = cold and time_cold(*cold)
        record(report, name, label, err, ms, plain_ms, byts, flops, host_ms, plain_host_ms,
               main_shape, library_ms=lib_ms, cold_ms=cold_ms)
        if cold_ms:
            print(f"    pool out of L2: kernel={cold_ms * 1e3:9.2f}us, "
                  f"{byts / HBM_BYTES_PER_S * 1e3 / cold_ms:.1%} of the byte bound")
    del pools


def time_cold(pools, fn) -> float:
    """Device ms of one ``fn(*pools)`` call whose pools are not in L2: the
    calls cycle through copies of the pools that hold ``COLD_BYTES`` in
    all, and each call reads a copy that later ones pushed out of L2."""
    import itertools

    size = sum(t.nbytes for t in pools)
    copies = itertools.cycle([tuple(t.clone() for t in pools)
                              for _ in range(-(-COLD_BYTES // size))])
    return time_ms(lambda: fn(*next(copies)), 60)[0]


def phase_a(report):
    """The sequential-test round op against its plain version, its edge
    cases, and the launch floor."""
    import numpy as np
    import torch

    from repro_torch.kernels.t_test_round import t_test_round, t_test_round_ref

    dev = torch.device("cuda")
    kern = report["kernels"]
    print("phase A: the round op against its plain version")

    # t_test_round: 32 chains whose df spans 1 .. 1e5, with an s == 0 lane
    # and an exhausted lane
    k, m, n_total = 32, 100, 100_200
    rng = np.random.default_rng(0)
    prior_n = np.floor(np.logspace(1, 5, k)).astype(np.float32)
    nvalid = np.full(k, m)
    prior_n[:3] = 0
    nvalid[0], nvalid[1] = 2, 3  # df = 1 and 2 after the merge
    prior_n[3] = n_total - m  # exhausted after the merge
    tstat = rng.uniform(0.0, 4.0, k)
    sigma = 1.0
    mu0 = rng.normal(0, 0.1, k).astype(np.float32)
    mean0 = (mu0 + tstat * sigma / np.sqrt(np.maximum(prior_n + nvalid, 1))).astype(np.float32)
    l = (mean0[:, None] + sigma * rng.standard_normal((k, m))).astype(np.float32)
    l[2] = 0.25  # s == 0: every value equal
    valid = np.arange(m)[None, :] < nvalid[:, None]
    m2 = (sigma ** 2 * np.maximum(prior_n - 1, 0)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    base = [t(prior_n), t(mean0), t(m2), t(mu0), t(np.full(k, 0.05, np.float32)),
            t(np.zeros(k), torch.int32), t(np.zeros(k), torch.bool), t(np.zeros(k), torch.bool),
            t(np.ones(k))]
    lt, vt = t(l), t(valid, torch.bool)
    sk, sp = [b.clone() for b in base], [b.clone() for b in base]
    reset_k = lambda: [s.copy_(b) for s, b in zip(sk, base)]
    reset_p = lambda: [s.copy_(b) for s, b in zip(sp, base)]
    run = lambda: t_test_round(lt, vt, sk[0], sk[1], sk[2], sk[3], sk[4], n_total, 10_000, *sk[5:])
    plain = lambda: t_test_round_ref(lt, vt, sp[0], sp[1], sp[2], sp[3], sp[4], n_total, 10_000, *sp[5:])
    reset_k(); run(); reset_p(); plain()
    torch.cuda.synchronize()
    df = (sp[0] - 1).clamp_min(1).cpu().numpy()
    print(f"  t_test_round df span {df.min():.0f} .. {df.max():.0f}; "
          f"exhausted lane done={bool(sk[6][3])}, s==0 lane pval={float(sk[8][2])}")
    check(df.min() == 1 and df.max() >= 1e5, "t_test_round case spans df 1 .. 1e5")
    check(bool(sk[6][3]) and float(sk[8][2]) == 0.0, "exhausted and s == 0 lanes take their guards")
    errs, rel_p = compare_round(sk, sp, f"K={k} m={m} df 1..1e5")
    # other (K, m): lanes without a value (m = 4), several values in a
    # lane's partial (m = 37, 512), warps of the last block without a chain
    # (K = 1, 5, 33), random states; and 8 chains whose deltas equal their
    # mean (multiples of 2^-10, so the sums are exact): s ~ 1e-14 and
    # x < 2^-60, where the kernel's divisions leave their fast form's range;
    # and phase L's round, (32, 400) with the lanes a bounded draw leaves
    # valid: s < m_eff for a ragged per-chain m_eff in the buckets, 0
    # included, and pools that run out partway
    for (k2, m2_, kind) in [(1, 4, "random"), (5, 37, "random"), (32, 100, "random"),
                            (33, 512, "random"), (8, 100, "constant"), (32, 400, "ragged")]:
        near_constant = kind == "constant"
        r2 = np.random.default_rng(k2 * 1000 + m2_)
        cnt = r2.integers(100 if near_constant else 0, 5000, k2).astype(np.float32)
        mn = r2.normal(0, 0.05, k2).astype(np.float32)
        if near_constant:
            mn = (np.round(mn * 1024) / 1024).astype(np.float32)
            m2v, l2 = (cnt - 1) * 1e-24, np.repeat(mn[:, None], m2_, axis=1)
        else:
            m2v = np.maximum(cnt - 1, 0) * r2.uniform(0.5, 2.0, k2)
            l2 = mn[:, None] + r2.standard_normal((k2, m2_))
        state = [t(cnt), t(mn), t(m2v), t(r2.normal(0, 0.05, k2)), t(np.full(k2, 0.05, np.float32)),
                 t(np.zeros(k2), torch.int32), t(np.zeros(k2), torch.bool),
                 t(np.zeros(k2), torch.bool), t(np.ones(k2))]
        if kind == "ragged":
            meff = r2.choice([0, 50, 100, 200, 400], k2)
            meff[:5] = (0, 50, 100, 200, 400)
            left = np.where(r2.uniform(size=k2) < 0.25, r2.integers(0, 400, k2), 400)
            v2 = t(np.arange(m2_)[None, :] < np.minimum(meff, left)[:, None], torch.bool)
            state[6] = t(r2.uniform(size=k2) < 0.2, torch.bool)  # chains not in flight
        else:
            v2 = t(r2.uniform(size=(k2, m2_)) < (2.0 if near_constant else 0.9), torch.bool)
        l2 = t(l2)
        s2k, s2p = [b.clone() for b in state], [b.clone() for b in state]
        t_test_round(l2, v2, *s2k[:5], 12214, 123, *s2k[5:])
        t_test_round_ref(l2, v2, *s2p[:5], 12214, 123, *s2p[5:])
        torch.cuda.synchronize()
        label = f"K={k2} m={m2_}" + (" deltas equal to their mean" if near_constant else
                                     " ragged m_eff" if kind == "ragged" else "")
        e2, rel2 = compare_round(s2k, s2p, label)
        kern["t_test_round"]["cases"].append({"case": label, **e2, "pval_rel": rel2})
    launch_floor, _ = time_ms(lambda: torch.cuda._sleep(0), 60)
    report["launch_floor_ms"] = launch_floor
    print(f"  launch floor: torch.cuda._sleep(0) in the same harness {launch_floor * 1e3:.2f}us a call")
    # the state reset (9 copies) runs inside the timed window: measure it
    # alone and take it off; the plain version is ~5000 launches a call
    (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 30, reset_k), \
        time_ms(plain, 5, reset_p, queued=False)
    reset_ms, _ = time_ms(lambda: None, 30, reset_k)
    ms -= reset_ms
    iters = cf_iterations(sp, df)
    flops = k * m * 8 + iters * SF_ITER_FLOPS + k * 200
    byts = k * m * 5 + k * 10 * 4 * 2
    bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    print(f"  t_test_round K={k} m={m} kernel={ms * 1e3:8.2f}us plain={plain_ms * 1e3:8.2f}us "
          f"bound={bound * 1e3:8.4f}us host/call: kernel {host_ms * 1e3:6.1f}us "
          f"plain {plain_host_ms * 1e3:8.1f}us (continued-fraction steps: {iters})")
    kern["t_test_round"].update(max_abs_err=errs["pval"], ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                                else "operations")
    kern["t_test_round"]["cases"].append({"case": f"K={k} m={m} df 1..1e5", **errs,
                                          "pval_rel": rel_p, "ms": ms, "plain_ms": plain_ms,
                                          "bound_ms": bound, "host_ms": host_ms,
                                          "plain_host_ms": plain_host_ms})


def compare_round(sk, sp, label):
    """Check the round op's state after a kernel round (``sk``) against the
    plain version's (``sp``): rounds, done and decision exact, count exact,
    mean 1e-5, m2 1e-6 of the largest, p-value 1e-4 relative (the merge sums
    in another order). Returns the errors and the p-value's relative error."""
    import torch

    for i in (5, 6, 7):  # rounds, done, decision: exact
        check(torch.equal(sk[i], sp[i]), f"t_test_round {label}: {('rounds', 'done', 'decision')[i - 5]} equal")
    errs = {name: float((sk[i] - sp[i]).abs().max()) for i, name in
            ((0, "count"), (1, "mean"), (2, "m2"), (8, "pval"))}
    rel_p = float(((sk[8] - sp[8]).abs() / sp[8].abs().clamp_min(1e-30)).max())
    print(f"  t_test_round {label} errors {errs} pval max rel {rel_p:.3e}")
    check(errs["count"] == 0 and errs["mean"] <= 1e-5 and errs["m2"] <= 1e-6 * float(sp[2].abs().max())
          and rel_p <= 1e-4, f"t_test_round {label} within tolerance (count exact, mean 1e-5, m2 1e-6 "
          "of max, pval 1e-4 relative: the merge sums in another order)")
    return errs, rel_p


def record(report, name, label, err, ms, plain_ms, byts, ops_, host_ms, plain_host_ms,
           main_shape, library_ms=None, tc_flops=None, **extra):
    """Print one kernel case and keep it; the main path's shape also fills the
    kernel's line. The bound is the larger of the bytes over the memory rate
    and ``ops_`` over the fp32 rate of the CUDA cores; for a tensor-core
    kernel (``tc_flops``: its bf16 products' flops) the line's bound is the
    larger of the bytes and ``tc_flops`` over the bf16 tensor-core rate, with
    the CUDA-core bound kept beside it as ``bound_fp32_ms``."""
    bound = max(byts / HBM_BYTES_PER_S, ops_ / FP32_FLOPS) * 1e3
    bound_by = "bytes" if byts / HBM_BYTES_PER_S >= ops_ / FP32_FLOPS else "operations"
    both = ""
    if tc_flops is not None:
        extra["bound_fp32_ms"], extra["bound_fp32_by"] = bound, bound_by
        bound = max(byts / HBM_BYTES_PER_S, tc_flops / BF16_TC_FLOPS) * 1e3
        bound_by = "bytes" if byts / HBM_BYTES_PER_S >= tc_flops / BF16_TC_FLOPS else "operations"
        both = (f" (tensor cores; fp32 CUDA cores {extra['bound_fp32_ms'] * 1e3:.3f}us "
                f"{extra['bound_fp32_by']}) at {bound / ms:.1%} of the bound")
    lib = "" if library_ms is None else f" library={library_ms * 1e3:9.2f}us"
    print(f"  {name:20s} {label:38s} err={err:.2e} kernel={ms * 1e3:9.2f}us "
          f"plain={plain_ms * 1e3:10.2f}us bound={bound * 1e3:8.3f}us ({bound_by}){both}{lib} "
          f"host/call: kernel {host_ms * 1e3:6.1f}us plain {plain_host_ms * 1e3:8.1f}us")
    e = report["kernels"][name]
    e["max_abs_err"] = max(e["max_abs_err"], err)
    e["cases"].append({"case": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": bound_by, "host_ms": host_ms,
                       "plain_host_ms": plain_host_ms, "library_ms": library_ms, **extra})
    if main_shape:
        e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                 library_ms=library_ms)


def phase_a_sv(report):
    """The stochvol kernels against their plain versions."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.pgibbs import draw_sweep_randomness

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    print("phase A (stochvol kernels): AR(1) delta, Fisher-Yates draw, pgibbs sweep")

    # AR(1) pair delta at the main path's shapes: the rounds (m=100) of E
    # (one chain, shared pools of N=1000), F (K=32, per-chain pools of
    # N=1000) and G (one chain, shared pools of N = 1e4, 1e5; at N = 1e3 it is
    # E's shape), G's exact pass over each whole pool (N = 1e3, 1e4, 1e5) as
    # the range exact_decide passes (warm, and
    # cold: pools out of L2) and through an index tensor beside it, and the
    # pre-gathered (K, m) form; E's and F's rounds also on bf16 pools and on
    # fp32 pools at precision bf16 (rounded in the kernel, one launch). ~16
    # flops a section (two pairs of multiply, subtract, square, divide, add
    # and the scale; the logs are per chain).
    floor, _ = time_ms(lambda: torch.cuda._sleep(0), 60)
    report["launch_floor_sv_ms"] = floor
    print(f"  launch floor: torch.cuda._sleep(0) in the same harness {floor * 1e3:.2f}us a call")
    tol = 1e-4  # the same float32 operations; sums of terms up to ~1e3
    ar1 = []
    for (what, k, n, precs) in [("E's round", 1, 1000, ("fp32", "bf16", "fp32 pools, bf16")),
                                ("F's round", 32, 1000, ("fp32", "bf16", "fp32 pools, bf16")),
                                ("G's round", 1, 10_000, ("fp32",)),
                                ("G's round", 1, 100_000, ("fp32",)),
                                ("P's round", 32, 100_000, ("fp32",)),
                                ("G's exact pass", 1, 1000, ("fp32",)),
                                ("G's exact pass", 1, 10_000, ("fp32",)),
                                ("G's exact pass", 1, 100_000,
                                 ("fp32", "bf16", "fp32 pools, bf16")),
                                ("pre-gathered", 32, 100, ("fp32",))]:
        for prec in precs:
            # P's shape draws from a generator of its own, so the other
            # cases' inputs do not depend on it
            g = torch.Generator(device=dev).manual_seed(2) if what == "P's round" else gen
            pools = [0.3 * torch.randn(k, n, generator=g, device=dev) for _ in range(2)]
            if prec == "bf16":
                pools = [p.to(torch.bfloat16) for p in pools]
            bx = 2 if prec == "bf16" else 4
            precision = "fp32" if prec == "fp32" else "bf16"
            phi = 0.9 + 0.05 * torch.rand(k, generator=g, device=dev)
            s2 = 0.005 + 0.01 * torch.rand(k, generator=g, device=dev)
            par = (phi, s2, phi + 0.01, s2 * 1.05)
            shared = k == 1 or what == "P's round"
            if shared:
                pools = [p[0] for p in pools]  # shared (N,) pools
            if what == "pre-gathered":
                fn = lambda xt, xp, par=par, mode="always", p=precision: \
                    ops.batched_gaussian_ar1_delta(xt, xp, *par, mode=mode, precision=p)
                byts, m = k * n * (2 * bx + 4) + k * 16, n
                label = f"pre-gathered K={k} m={n} {prec}"
            elif what == "G's exact pass":
                fn = lambda xt, xp, par=par, n=n, mode="always", p=precision: ops.gather_ar1_delta(
                    xt, xp, range(0, n), *par, mode=mode, precision=p)
                byts, m, label = n * (2 * bx + 4) + 16, n, f"{what} range N={n} {prec}"
            else:
                m = 100
                idx = torch.randint(0, n, (k, m), generator=g, device=dev, dtype=torch.int32)
                fn = lambda xt, xp, idx=idx, par=par, mode="always", p=precision: \
                    ops.gather_ar1_delta(xt, xp, idx, *par, mode=mode, precision=p)
                byts = k * m * (2 * bx + 4 + 4) + k * 16
                label = f"{what} K={k} m={m} of N={n} {'shared' if shared else 'per-chain'} {prec}"
            ar1.append((label, fn, pools, byts, k * m * 16, what == "G's exact pass",
                        (k, n, prec, what) == (32, 1000, "fp32", "F's round")))
            if what == "G's exact pass" and prec == "fp32":
                full = torch.arange(n, dtype=torch.int32, device=dev)[None]
                fn = lambda xt, xp, idx=full, par=par, mode="always": ops.gather_ar1_delta(
                    xt, xp, idx, *par, mode=mode)
                ar1.append((f"{what} index tensor N={n} {prec}", fn, pools,
                            n * (2 * bx + 4 + 4) + 16, n * 16, False, False))
    for label, fn, pools, byts, flops, cold, main_shape in ar1:
        run = lambda fn=fn, pools=pools: fn(*pools)
        plain = lambda fn=fn, pools=pools: fn(*pools, mode="never")
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= tol * max(1.0, float(want.abs().max())),
              f"gaussian_ar1_delta {label} within {tol:g} (relative to max |l|) of its plain version")
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 10)
        cold_ms = cold and time_cold(pools, fn)
        record(report, "gaussian_ar1_delta", label, err, ms, plain_ms, byts, flops, host_ms,
               plain_host_ms, main_shape, cold_ms=cold_ms, above_floor_ms=ms - floor)
        print(f"    above the launch floor: {(ms - floor) * 1e3:.2f}us" + (
            f"; pools out of L2: kernel={cold_ms * 1e3:.2f}us, "
            f"{byts / HBM_BYTES_PER_S * 1e3 / cold_ms:.1%} of the byte bound" if cold_ms else ""))

    # Fisher-Yates draw: 32 chains over N=1000, m=100, rounds to exhaustion
    # with ~20% of the chains inactive each round: identical everything.
    k, n, m = 32, 1000, 100
    bufs = [torch.arange(n, dtype=torch.int32, device=dev).repeat(k, 1) for _ in range(2)]
    pos = [torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(2)]
    size = torch.full((k,), n, dtype=torch.int32, device=dev)
    size[5] = 937
    rounds = 0
    while bool((pos[0] < size).any()):
        u = torch.rand((k, m), generator=gen, dtype=torch.float64, device=dev)
        active = torch.rand(k, generator=gen, device=dev) < 0.8
        outs = [ops.fy_draw(u, bufs[i], pos[i], size, m, active, mode=mode)
                for i, mode in enumerate(("always", "never"))]
        check(all(torch.equal(a, b) for a, b in zip(*outs)) and torch.equal(*bufs),
              f"fy_draw round {rounds}: indices, valid flags, positions and buffers identical")
        pos = [outs[0][2], outs[1][2]]
        rounds += 1
    check(all(torch.equal(row.sort().values, torch.arange(n, dtype=torch.int32, device=dev))
              for row in bufs[0]), f"fy_draw: every buffer still a permutation after {rounds} rounds")
    # edge cases, each from permuted buffers, kernel and plain version on
    # copies with the same uniforms (a number: every step's uniform):
    # (label, K, capacity, size, pos, m, uniforms, inactive share, rounds)
    for (label, k, cap, sz, p_, m_, uni, inactive, nr) in [
            ("duplicate targets (equal uniforms near 1)", 4, 1000, 1000, 0, 100, 1 - 2 ** -30, 0.0, 1),
            ("targets inside the window ahead (u = 0.05)", 4, 1000, 1000, 0, 100, 0.05, 0.0, 1),
            ("pos + m past the capacity", 4, 1000, 1000, 950, 100, None, 0.0, 2),
            ("exhausted pool", 4, 1000, 1000, 1000, 100, None, 0.0, 1),
            ("size below capacity", 4, 1000, 600, 550, 100, None, 0.0, 2),
            ("m above size", 4, 64, 40, 0, 100, None, 0.0, 1),
            ("K=1", 1, 1000, 1000, 0, 100, None, 0.0, 3),
            ("K=5, inactive chains", 5, 1000, 1000, 0, 100, None, 0.2, 3),
            ("K=33, inactive chains", 33, 1000, 1000, 0, 100, None, 0.2, 3),
            ("K=1 of N=1e5", 1, 100_000, 100_000, 0, 100, None, 0.0, 3),
            ("m=300: three chunks of steps", 3, 1000, 1000, 0, 300, None, 0.0, 4)]:
        start = torch.argsort(torch.rand(k, cap, generator=gen, device=dev), dim=1).int()
        bufs = [start.clone(), start.clone()]
        sizes = torch.full((k,), sz, dtype=torch.int32, device=dev)
        pos = [torch.clamp_max(torch.full_like(sizes, p_), sizes) for _ in range(2)]
        same = True
        for _ in range(nr):
            u = torch.rand((k, m_), generator=gen, dtype=torch.float64, device=dev)
            if uni is not None:
                u.fill_(uni)
            active = torch.rand(k, generator=gen, device=dev) >= inactive
            outs = [ops.fy_draw(u, bufs[i], pos[i], sizes, m_, active, mode=mode)
                    for i, mode in enumerate(("always", "never"))]
            same &= all(torch.equal(a, b) for a, b in zip(*outs)) and torch.equal(*bufs)
            pos = [outs[0][2], outs[1][2]]
        check(same, f"fy_draw {label}, {nr} round(s): indices, valid flags, positions and "
                    "buffers identical")
        report["kernels"]["fy_draw"]["cases"].append({"case": label, "max_abs_err": 0.0 if same else None})
    # the timed shapes, the one chain of phase E among them: one round from
    # a fresh buffer, kernel and plain version on copies with the same
    # uniforms; the error is the largest difference of any output or buffer
    # entry (the plain version's valid flags and positions included)
    for (k, n) in [(32, 1000), (1, 1000), (1, 100_000)]:
        start = torch.arange(n, dtype=torch.int32, device=dev).repeat(k, 1)
        p0 = torch.zeros(k, dtype=torch.int32, device=dev)
        sz = torch.full((k,), n, dtype=torch.int32, device=dev)
        u = torch.rand((k, m), generator=gen, dtype=torch.float64, device=dev)
        bufs = [start.clone(), start.clone()]
        outs = [ops.fy_draw(u, b, p0, sz, m, mode=mode) for b, mode in zip(bufs, ("always", "never"))]
        torch.cuda.synchronize()
        err = max(float((a.long() - b.long()).abs().max())
                  for a, b in zip(outs[0] + (bufs[0],), outs[1] + (bufs[1],)))
        label = f"K={k} m={m} of N={n}"
        check(err == 0, f"fy_draw {label}: indices, valid flags, position and buffer identical")
        buf = bufs[0]
        run = lambda buf=buf, p0=p0, sz=sz, u=u: ops.fy_draw(u, buf, p0, sz, m, mode="always")
        plain = lambda buf=buf, p0=p0, sz=sz, u=u: ops.fy_draw(u, buf, p0, sz, m, mode="never")
        # the plain version is ~4 m launches a call: wall time per call
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 3, queued=False)
        # bytes: the uniforms, the 2 m entries read and written, the outputs;
        # ~12 integer operations a swap
        byts = k * m * (8 + 16 + 4 + 1) + k * 12
        record(report, "fy_draw", label, err, ms, plain_ms, byts, k * m * 12, host_ms,
               plain_host_ms, (k, n) == (32, 1000))

    # the bounded draw (the adaptive scheduler's per-chain m_eff): K = 1, 32,
    # 33 x m_max = 100, 400, m_eff ragged per chain (0 and m_max among them),
    # inactive chains, on the BayesLR pool (N=12214) and on a pool of 1000
    # that runs out partway; kernel and plain on copies with the same
    # uniforms, every round: identical everything, buffers still permutations
    for (k, m_max, n, nr, inactive) in [(1, 100, 12214, 4, 0.0), (32, 100, 12214, 4, 0.2),
                                        (33, 100, 1000, 14, 0.0), (1, 400, 12214, 4, 0.0),
                                        (32, 400, 12214, 4, 0.2), (33, 400, 1000, 6, 0.2)]:
        m_eff = torch.randint(0, m_max + 1, (k,), generator=gen, device=dev, dtype=torch.int32)
        m_eff[0] = 0 if k > 1 else m_max // 2
        if k > 1:
            m_eff[1] = m_max
        start = torch.argsort(torch.rand(k, n, generator=gen, device=dev), dim=1).int()
        bufs = [start.clone(), start.clone()]
        pos = [torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(2)]
        sizes = torch.full((k,), n, dtype=torch.int32, device=dev)
        same = True
        for _ in range(nr):
            u = torch.rand((k, m_max), generator=gen, dtype=torch.float64, device=dev)
            active = torch.rand(k, generator=gen, device=dev) >= inactive
            outs = [ops.fy_draw(u, bufs[i], pos[i], sizes, m_max, active, mode=mode, m_eff=m_eff)
                    for i, mode in enumerate(("always", "never"))]
            same &= all(torch.equal(a, b) for a, b in zip(*outs)) and torch.equal(*bufs)
            pos = [outs[0][2], outs[1][2]]
        ran_out = bool((pos[0] == sizes).any())
        label = f"bounded K={k} m_max={m_max} of N={n}, ragged m_eff" + (
            ", pool runs out" if ran_out else "")
        perm = all(torch.equal(row.sort().values, torch.arange(n, dtype=torch.int32, device=dev))
                   for row in bufs[0])
        check(same and perm, f"fy_draw {label}, {nr} rounds: indices, valid flags, positions "
                             "and buffers identical, buffers still permutations")
        report["kernels"]["fy_draw"]["cases"].append({"case": label, "max_abs_err": 0.0})
    # timed: phase L's round (K=32, m_max=400 of N=12214, ragged m_eff) beside
    # the unbounded call at the same shape
    k, m_max, n = 32, 400, 12214
    m_eff = torch.tensor([50, 100, 200, 400] * 8, dtype=torch.int32, device=dev)
    u = torch.rand((k, m_max), generator=gen, dtype=torch.float64, device=dev)
    p0 = torch.zeros(k, dtype=torch.int32, device=dev)
    sz = torch.full((k,), n, dtype=torch.int32, device=dev)
    for me in (m_eff, None):
        bufs = [torch.arange(n, dtype=torch.int32, device=dev).repeat(k, 1) for _ in range(2)]
        outs = [ops.fy_draw(u, b, p0, sz, m_max, mode=mode, m_eff=me)
                for b, mode in zip(bufs, ("always", "never"))]
        torch.cuda.synchronize()
        err = max(float((a.long() - b.long()).abs().max())
                  for a, b in zip(outs[0] + (bufs[0],), outs[1] + (bufs[1],)))
        label = f"K={k} m={m_max} of N={n}" + (" bounded, m_eff 50..400" if me is not None else "")
        check(err == 0, f"fy_draw {label}: indices, valid flags, position and buffer identical")
        run = lambda b=bufs[0], me=me: ops.fy_draw(u, b, p0, sz, m_max, mode="always", m_eff=me)
        plain = lambda b=bufs[1], me=me: ops.fy_draw(u, b, p0, sz, m_max, mode="never", m_eff=me)
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 2, queued=False)
        byts = k * m_max * (8 + 16 + 4 + 1) + k * 12 + (k * 4 if me is not None else 0)
        record(report, "fy_draw", label, err, ms, plain_ms, byts, k * m_max * 12, host_ms,
               plain_host_ms, False, above_floor_ms=ms - floor)
        print(f"    above the launch floor: {(ms - floor) * 1e3:.2f}us")

    # pgibbs sweep: the lattices of phases F and E, and one chain at S=20000
    for (k, s, t, p) in [(32, 200, 5, 25), (1, 200, 5, 25), (1, 20_000, 5, 25)]:
        obs = torch.exp(0.5 * 0.3 * torch.randn(s, t, generator=gen, device=dev)) \
            * torch.randn(s, t, generator=gen, device=dev)
        h = 0.3 * torch.randn(k, s, t, generator=gen, device=dev)
        phi = torch.full((k,), 0.95, device=dev)
        s2 = torch.full((k,), 0.01, device=dev)
        rand = draw_sweep_randomness(gen, k, s, t, p, dev)
        run = lambda rand=rand, obs=obs, h=h, phi=phi, s2=s2: ops.pgibbs_sweep(
            *rand, obs, h, phi, s2, mode="always")
        plain = lambda rand=rand, obs=obs, h=h, phi=phi, s2=s2: ops.pgibbs_sweep(
            *rand, obs, h, phi, s2, mode="never")
        got, want = run(), plain()
        torch.cuda.synchronize()
        same = (got == want).all(-1)
        frac = 1.0 - float(same.float().mean())
        err = float((got - want).abs().max())
        label = f"K={k} S={s} T={t} P={p}"
        print(f"  pgibbs_sweep {label}: {frac:.3e} of the paths differ (max |diff| {err:.3e})")
        check(bool(torch.isfinite(got).all()) and frac <= 0.01,
              f"pgibbs_sweep {label}: finite, paths equal except where a uniform lies within "
              "float32 rounding of a CDF boundary (at most 1% of the paths)")
        # the plain version is ~80 tensor operations a step (its sum and scan follow
        # the kernel's order): wall time per call
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 3, queued=False)
        byts = 2 * t * k * s * p * 4 + k * s * 4 + s * t * 4 + 2 * k * s * t * 4 + 8 * k
        record(report, "pgibbs_sweep", label, err, ms, plain_ms, byts, t * k * s * p * 25,
               host_ms, plain_host_ms, (k, s) == (32, 200), paths_differ_frac=frac,
               above_floor_ms=ms - floor)
        print(f"    above the launch floor: {(ms - floor) * 1e3:.2f}us")


# the ce family's path shapes: m=100 of N = 64 x 127 next-token sections of
# chatglm3-6b (D=4096, V=65024), one chain and K=8 per-chain tables
CE_N, CE_D, CE_V, CE_M, CE_K = 8128, 4096, 65024, 100, 8


def ce_tolerance(want, v):
    """Per-token tolerance of the CE kernel against its plain version, fp32
    and bf16 alike (both sides compute float32 logits from the same
    operands): 1e-4 of log V, or of the largest |per-token value| where
    extreme logits make those large (the JAX package's rtol at extreme
    logits). The sums of the same products run in another order."""
    return 1e-4 * max(math.log(v), float(want.abs().max()))


def phase_a_ce(report):
    """The fused CE kernel against its plain version, with the library
    composite (torch.matmul + F.cross_entropy, which build the (T, V) logits)
    beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    print("phase A (CE kernels): fused_ce, batched_fused_ce (shared / per-chain tables, gather)")

    def library(h, table, targets, idx=None):
        """log softmax(h W^T)[target] from two library calls (plus the row
        gather where the kernel reads rows through idx)."""
        if idx is not None:
            h, targets = h[idx.long()], targets[idx.long()]
        hf, tab = h.float(), table.float()
        logits = hf @ tab.transpose(-1, -2) if tab.ndim == hf.ndim else hf @ tab.T
        return -F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                                reduction="none").reshape(targets.shape)

    def case(name, label, prec, run, plain, lib, byts, flops, tc_flops, main_shape, v, reps):
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = ce_tolerance(want, v)
        lib_err = float((lib() - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"{name} {label} within {tol:.3g} of its plain version (err {err:.2e}; "
              f"library composite {lib_err:.2e})")
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, reps), time_ms(plain, reps)
        lib_ms, _ = time_ms(lib, reps)
        record(report, name, label, err, ms, plain_ms, byts, flops, host_ms, plain_host_ms,
               main_shape, library_ms=lib_ms, tc_flops=tc_flops)

    def ce_cost(k, t, v, d, tables, eh, et, products):
        """Bytes: the tables and h rows once, targets (and indices) and the
        output; operations: 2 T V D per chain for the logits and ~4 per logit
        for the online max, exp and sum; and the tensor cores' flops: 2 T V D
        per chain for each bf16 product the dtypes need (6 for fp32 x fp32,
        3 for bf16 x fp32, 1 for bf16 x bf16 or precision="bf16")."""
        byts = tables * v * d * et + k * t * d * eh + k * t * 12
        return byts, k * t * v * (2 * d + 4), products * k * t * v * 2 * d

    # ragged one-chain shapes (T, V off the tiles; D = 13 takes the plain
    # loads) and 30x extreme logits, fp32 and bf16
    for (t, d, v, scale) in [(37, 16, 129, 0.5), (5, 13, 1000, 0.5), (16, 8, 64, 30.0)]:
        for prec in ("fp32", "bf16"):
            dt = torch.bfloat16 if prec == "bf16" else torch.float32
            h = (scale * torch.randn(t, d, generator=gen, device=dev)).to(dt)
            tab = (scale * torch.randn(v, d, generator=gen, device=dev)).to(dt)
            tg = torch.randint(0, v, (t,), generator=gen, device=dev, dtype=torch.int32)
            e = 2 if prec == "bf16" else 4
            case("fused_ce", f"T={t} D={d} V={v} x{scale:g} {prec}", prec,
                 lambda h=h, tab=tab, tg=tg: ops.fused_ce(h, tab, tg, mode="always"),
                 lambda h=h, tab=tab, tg=tg: ops.fused_ce(h, tab, tg, mode="never"),
                 lambda h=h, tab=tab, tg=tg: library(h, tab, tg),
                 *ce_cost(1, t, v, d, 1, e, e, 6 if prec == "fp32" else 1), False, v, 20)
    # K chains: shared and per-chain tables, pre-gathered rows and the gather form
    k, t, d, v, n = 4, 33, 64, 1000, 500
    pool = 0.5 * torch.randn(n, d, generator=gen, device=dev)
    pool_t = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.randint(0, n, (k, t), generator=gen, device=dev, dtype=torch.int32)
    for per_chain in (False, True):
        tab = 0.5 * torch.randn((k, v, d) if per_chain else (v, d), generator=gen, device=dev)
        hk, tk = pool[idx.long()].contiguous(), pool_t[idx.long()].contiguous()
        kind = "per-chain" if per_chain else "shared"
        cost = ce_cost(k, t, v, d, k if per_chain else 1, 4, 4, 6)
        case("batched_fused_ce", f"K={k} T={t} D={d} V={v} {kind}", "fp32",
             lambda hk=hk, tab=tab, tk=tk: ops.batched_fused_ce(hk, tab, tk, mode="always"),
             lambda hk=hk, tab=tab, tk=tk: ops.batched_fused_ce(hk, tab, tk, mode="never"),
             lambda hk=hk, tab=tab, tk=tk: library(hk, tab, tk), *cost, False, v, 20)
        for prec in ("fp32", "bf16"):
            case("batched_fused_ce", f"gather K={k} m={t} of N={n} {kind} {prec}", prec,
                 lambda tab=tab, p=prec: ops.gather_fused_ce(pool, pool_t, idx, tab,
                                                             mode="always", precision=p),
                 lambda tab=tab, p=prec: ops.gather_fused_ce(pool, pool_t, idx, tab,
                                                             mode="never", precision=p),
                 lambda tab=tab: library(pool, tab, pool_t, idx),
                 *cost[:2], cost[2] // (6 if prec == "bf16" else 1), False, v, 20)

    # the path's shapes: bf16 hidden states (as forward_hidden gives them),
    # fp32 tables at chatglm3-6b's width
    h = torch.randn(CE_N, CE_D, generator=gen, device=dev).to(torch.bfloat16)
    tg = torch.randint(0, CE_V, (CE_N,), generator=gen, device=dev, dtype=torch.int32)
    table = 0.02 * torch.randn(CE_V, CE_D, generator=gen, device=dev)
    idx1 = torch.randint(0, CE_N, (CE_M,), generator=gen, device=dev, dtype=torch.int32)
    case("fused_ce", f"m={CE_M} of N={CE_N} D={CE_D} V={CE_V} (phase I)", "fp32",
         lambda: ops.fused_ce(h, table, tg, idx=idx1, mode="always"),
         lambda: ops.fused_ce(h, table, tg, idx=idx1, mode="never"),
         lambda: library(h, table, tg, idx1),
         *ce_cost(1, CE_M, CE_V, CE_D, 1, 2, 4, 3), True, CE_V, 20)
    tables = table[None].repeat(CE_K, 1, 1)
    tables.add_(0.02 * torch.randn(tables.shape, generator=gen, device=dev))
    idxk = torch.randint(0, CE_N, (CE_K, CE_M), generator=gen, device=dev, dtype=torch.int32)
    case("batched_fused_ce", f"gather K={CE_K} m={CE_M} of N={CE_N} per-chain (phase J)", "fp32",
         lambda: ops.gather_fused_ce(h, tg, idxk, tables, mode="always"),
         lambda: ops.gather_fused_ce(h, tg, idxk, tables, mode="never"),
         lambda: library(h, tables, tg, idxk),
         *ce_cost(CE_K, CE_M, CE_V, CE_D, CE_K, 2, 4, 3), True, CE_V, 5)
    case("batched_fused_ce", f"gather K={CE_K} m={CE_M} of N={CE_N} shared table", "fp32",
         lambda: ops.gather_fused_ce(h, tg, idxk, table, mode="always"),
         lambda: ops.gather_fused_ce(h, tg, idxk, table, mode="never"),
         lambda: library(h, table, tg, idxk),
         *ce_cost(CE_K, CE_M, CE_V, CE_D, 1, 2, 4, 3), False, CE_V, 5)
    del tables, table
    torch.cuda.empty_cache()


def phase_e(report):
    import numpy as np
    import torch

    from repro_torch.experiments import stochvol

    print("phase E: stochastic volatility, one chain, S=200 T=5 P=25, 500 cycle steps")
    steps = 500
    data = stochvol.synth(10, num_series=200, length=5)
    n = data.obs.numel()

    def run():
        stochvol.run_posterior_sequential(0, data, 3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stochvol.run_posterior_sequential(11, data, steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (_, samples, infos), wall = counted(report, "E", run)
    phi = samples["phi"].cpu().numpy()
    sig = np.sqrt(np.maximum(samples["sigma2"].cpu().numpy(), 0))
    r = {"cycle_steps_per_s": steps / wall, "phi_mean_2nd_half": float(phi[steps // 2:].mean()),
         "sigma_mean_2nd_half": float(sig[steps // 2:].mean())}
    for name in ("phi", "sigma2"):
        info = infos[name]
        r[name] = {"accept": float(info.accepted.float().mean()),
                   "mean_rounds": float(info.rounds.float().mean()),
                   "frac_evaluated": float(info.n_evaluated.float().mean()) / n}
    report["phases"]["E"].update(r)
    print(f"  cycle steps/s={r['cycle_steps_per_s']:.1f}  phi: {r['phi']}  sigma2: {r['sigma2']}")
    print(f"  posterior means over the second half: phi={r['phi_mean_2nd_half']:.4f} (generating "
          f"0.95), sigma={r['sigma_mean_2nd_half']:.4f} (generating 0.1)")
    check(np.isfinite(phi).all() and np.isfinite(sig).all() and phi.shape == (steps,),
          f"phase E samples finite, shape {phi.shape}")
    check(all(0.0 < r[v]["accept"] < 1.0 for v in ("phi", "sigma2"))
          and 0 < r["phi_mean_2nd_half"] < 1 and r["sigma_mean_2nd_half"] > 0,
          "phase E: both moves accept and reject; phi in (0, 1), sigma > 0")

    # an ensemble of one chain reproduces the sequential cycle on the card
    small = stochvol.synth(12, num_series=30, length=5)
    kw = dict(batch_size=50, num_particles=12)
    _, s1, i1, _ = stochvol.run_posterior_ensemble(13, small, num_chains=1, num_steps=25, **kw)
    _, s2, i2 = stochvol.run_posterior_sequential(13, small, 25, **kw)
    check(torch.equal(s1["phi"][0], s2["phi"]) and torch.equal(s1["sigma2"][0], s2["sigma2"])
          and all(torch.equal(i1[v].n_evaluated[0], i2[v].n_evaluated) for v in ("phi", "sigma2")),
          "ensemble of one chain == run_posterior_sequential, bit for bit, on the card")


def phase_f(report):
    import numpy as np
    import torch

    from repro_torch.experiments import stochvol

    print("phase F: stochastic volatility, K=32 chains in lock-step, 500 cycle steps")
    k, steps = 32, 500
    data = stochvol.synth(10, num_series=200, length=5)

    def run():
        stochvol.run_posterior_ensemble(0, data, num_chains=k, num_steps=8)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stochvol.run_posterior_ensemble(14, data, num_chains=k, num_steps=steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, samples, infos, diag), wall = counted(report, "F", run)
    r = {"cycle_steps_per_s": k * steps / wall, "rhat_phi": diag["rhat_phi"],
         "rhat_sigma2": diag["rhat_sigma2"], "frac_evaluated": diag["frac_evaluated"],
         "accept": {v: float(np.mean(diag["accept_rate"][v])) for v in ("phi", "sigma2")},
         "mean_rounds": {v: float(infos[v].rounds.float().mean()) for v in ("phi", "sigma2")}}
    report["phases"]["F"].update(r)
    print(f"  cycle steps/s (summed over chains)={r['cycle_steps_per_s']:.1f} split R-hat "
          f"phi={r['rhat_phi']:.3f} sigma2={r['rhat_sigma2']:.3f} acceptance={r['accept']} "
          f"n_evaluated/N={r['frac_evaluated']} rounds={r['mean_rounds']}")
    phi = samples["phi"].cpu().numpy()
    check(np.isfinite(phi).all() and phi.shape == (k, steps)
          and bool(torch.isfinite(samples["sigma2"]).all()), f"phase F samples finite, shape {phi.shape}")
    check(all(0.0 < r["accept"][v] < 1.0 for v in ("phi", "sigma2")),
          "phase F: both moves accept and reject")

    # fused route against the plain route on 200 fixed phi proposals from the
    # chains' final states; both draw the same Fisher-Yates uniforms
    cyc = stochvol.make_inference_cycle(data.obs)
    op = cyc.ops[1]
    reps = 200 // k + 1
    theta = {name: leaf.repeat((reps,) + (1,) * (leaf.ndim - 1))[:200]
             for name, leaf in state.theta.items()}
    g = torch.Generator(device="cuda").manual_seed(15)
    theta_p, _ = op.proposal(g, theta)
    log_u = torch.log(torch.rand(200, generator=g, device="cuda").clamp_min(1e-20))
    report["phases"]["F"]["fused_vs_plain_differ"] = fused_vs_never(
        op.target, theta, theta_p, log_u, op.cfg, "phase F phi", gen_seed=16)


G_EXACT_STEPS = 20  # exact transitions timed at each N: host time varies between them


def phase_g(report):
    import torch

    from repro_torch.core import SubsampledMHConfig, make_kernel, mh_step
    from repro_torch.experiments import stochvol

    print("phase G: sublinear section count on dependent sections (phi move, h = h_true)")
    rows = []

    def run():
        for s in (200, 2000, 20_000):
            data = stochvol.synth(20, num_series=s, length=5)
            n = data.obs.numel()
            target = stochvol.make_param_target(data.h_true, "phi")
            check(target.range_sections, f"phase G N={n}: the exact pass reads ranges of the "
                  "pools, with no index tensor")
            cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="fy")
            rw = stochvol.SingleLeafRW("phi", 0.02)
            state0, step = make_kernel(target, rw, cfg)
            theta = {"phi": torch.tensor(0.95, device="cuda"),
                     "sigma2": torch.tensor(0.01, device="cuda")}
            gen = torch.Generator(device="cuda").manual_seed(21)
            step(gen, theta, state0)  # warm-up
            torch.cuda.synchronize()
            evals, state = [], state0
            t0 = time.perf_counter()
            for _ in range(50):
                _, state, info = step(gen, theta, state)  # theta stays fixed
                evals.append(info.n_evaluated)
            torch.cuda.synchronize()
            sub_s = (time.perf_counter() - t0) / 50
            t0 = time.perf_counter()
            for _ in range(G_EXACT_STEPS):
                mh_step(gen, theta, target, rw)
            torch.cuda.synchronize()
            ex_s = (time.perf_counter() - t0) / G_EXACT_STEPS
            mean_eval = float(torch.stack(evals).float().mean())
            rows.append({"S": s, "N": n, "mean_n_evaluated": mean_eval, "frac": mean_eval / n,
                         "subsampled_us": sub_s * 1e6, "exact_us": ex_s * 1e6})

    counted(report, "G", run)
    for r in rows:
        print(f"  S={r['S']:>6d} N={r['N']:>7d} mean n_evaluated={r['mean_n_evaluated']:8.1f} "
              f"({r['frac']:.4%}) subsampled={r['subsampled_us']:.0f}us exact={r['exact_us']:.0f}us")
    report["phases"]["G"]["rows"] = rows
    fr = [r["frac"] for r in rows]
    check(fr[0] > fr[1] > fr[2], "n_evaluated / N falls as N grows (dependent sections)")


# ---------------------------------------------------------------------------
# Phases M-N and their phase A cases: the joint DP mixture (Sec. 4.2)
# ---------------------------------------------------------------------------

JDPM_N, JDPM_N_TEST, JDPM_K, JDPM_CYCLES = 10_000, 1_000, 8, 30
JDPM_W_TIMED = 20  # exact and subsampled w moves timed from phase M's final state


def gibbs_ops(k, p, n, k_max):
    """Operations a sweep of K replicas needs at D = 2, transcendentals
    counted as one: each step, for every cluster, the predictive's tail
    (the solve, the quadratic form, a log) ~13, the CRP and label terms
    ~13 and its share of the softmax, scan and pick ~6; for the two clusters
    the step changes, the point's removal or addition ~11 and the
    predictive state (mean, scatter, Cholesky factor, log det) ~60; once,
    the count's terms of the counts 0 .. N (two lgammas of ~30 and a log)."""
    return k * p * (k_max * 32 + 2 * 71) + (n + 1) * 65


def gibbs_state(gen, data, cfg, k):
    """K replicas of a phase-M-like state: three random clusters each, w
    from the prior, log alpha 0, the statistics from z."""
    import torch

    from repro_torch.inference.niw import ClusterStats

    dev = data.x.device
    z = torch.randint(0, 3, (k, data.x.shape[0]), generator=gen, device=dev).to(torch.int32)
    w = torch.randn((k, cfg.k_max, cfg.d + 1), generator=gen, device=dev)
    return z, w, torch.zeros(k, device=dev), ClusterStats.from_assignments(data.x, z, cfg.k_max)


def phase_a_jdpm(report, data):
    """The joint DP mixture's kernels at the main path's shapes: the Gibbs
    sweep against its plain version (K = 8 and K = 1, N = 10 000, K_max =
    20, P = 5 000, D = 2) from the same staged randomness, and on the card
    cases of tests/test_torch_cuda.py against the saved bits of the earlier
    sweep kernel; the round op with
    a ragged per-chain n_total against its plain version, and with a null
    one (and a per-chain one equal to the scalar) against the saved bits of
    tests/test_torch_cuda.py; the logit delta on the augmented rows [x, 1]
    (D + 1 = 3) of phases M and N."""
    import numpy as np
    import torch

    from repro_torch.experiments import jointdpm
    from repro_torch.inference.niw import ClusterStats
    from repro_torch.kernels import ops
    from repro_torch.kernels.gibbs_z import (draw_sweep_randomness, first_divergence,
                                             gibbs_z_sweep, gibbs_z_sweep_ref, sums_drift)

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_cuda as saved  # the round op's and the sweep's saved digests, their inputs

    dev = torch.device("cuda")
    cfg = jointdpm.JDPMConfig()
    prior, w_sd = cfg.niw_prior(dev), math.sqrt(cfg.prior_var_w)
    gen = torch.Generator(device=dev).manual_seed(70)
    n, p, d = JDPM_N, JDPM_N // 2, cfg.d
    print("phase A (joint DP mixture): the Gibbs sweep, the round op with a per-chain n_total, "
          "the logit delta on [x, 1]")
    # the kernel at K = 8 and at K = 1; the plain version once over the 9
    # replicas of both (it is vectorised over replicas, so K = 8 alone takes
    # about as long)
    cases = []
    for k in (JDPM_K, 1):
        z, w, la, stats = gibbs_state(gen, data, cfg, k)
        keys = torch.rand((k, n), generator=gen, dtype=torch.float64, device=dev)
        points = torch.argsort(keys, dim=-1, stable=True)[:, :p].to(torch.int32).contiguous()
        nrm, u = draw_sweep_randomness(gen, k, p, d, dev)
        cases.append((z, w, la, stats, points, nrm, u))
    cat = [torch.cat(parts) for parts in zip(*[c[:3] + c[4:] for c in cases])]
    zp, wp, lap, points_p, nrm_p, u_p = cat
    sp = ClusterStats(*(torch.cat(parts) for parts in zip(*[c[3] for c in cases])))
    t0 = time.perf_counter()
    cdf, mass = gibbs_z_sweep_ref(data.x, data.y, zp, wp, lap, sp, points_p, nrm_p, u_p, prior,
                                  w_sd, record=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  gibbs_z_sweep plain version over the {JDPM_K + 1} replicas of both cases: "
          f"{plain_ms / 1e3:.2f}s")
    first = 0
    for z, w, la, stats, points, nrm, u in cases:
        k = z.shape[0]
        rows = slice(first, first + k)
        first += k
        zk, wk, sk = z.clone(), w.clone(), ClusterStats(*(s.clone() for s in stats))

        def reset():
            zk.copy_(z)
            wk.copy_(w)
            for a, b in zip(sk, stats):
                a.copy_(b)

        run = lambda: gibbs_z_sweep(data.x, data.y, zk, wk, la, sk, points, nrm, u, prior, w_sd)
        reset()
        run()
        torch.cuda.synchronize()
        apart = first_divergence(points, u, zk, zp[rows], cdf[rows], mass[rows])
        label = f"K={k} N={n} K_max={cfg.k_max} P={p} D={d}"
        print(f"  gibbs_z_sweep {label}: replicas whose picks part from the plain version's: "
              f"{[(r, t) for r, t, _ in apart]}")
        check(all(b for _, _, b in apart), f"gibbs_z_sweep {label}: picks equal the plain "
              "version's, or part first where the uniform lies within 1e-5 of a CDF boundary")
        counts = torch.stack([torch.bincount(r.long(), minlength=cfg.k_max) for r in zk]).float()
        drift = sums_drift(sk, ClusterStats.from_assignments(data.x, zk, cfg.k_max))
        check(torch.equal(sk.n, counts) and drift <= 1e-5,
              f"gibbs_z_sweep {label}: counts equal z's histogram; sums within 1e-5 of their "
              f"largest magnitude of float64 sums from z ({drift:.2e})")
        same = [r for r in range(k) if r not in {a for a, _, _ in apart}]
        err = max([0.0] + [float((a[same] - b[rows][same]).abs().max()) for a, b in
                           zip((*sk, wk), (*sp, wp))])
        ms, host_ms = time_ms(run, 5, reset)
        reset_ms, _ = time_ms(lambda: None, 5, reset)
        ms -= reset_ms
        byts = k * p * (4 + 4 * (d + 1) + 4 * (d + 1) + 4 + 4) + k * n * 4 \
            + 2 * k * cfg.k_max * (1 + d + d * d + d + 1) * 4
        record(report, "gibbs_z_sweep", label, err, ms, plain_ms, byts,
               gibbs_ops(k, p, n, cfg.k_max), host_ms, plain_ms, k == JDPM_K,
               step_us=ms * 1e3 / p, divergences=len(apart))
        print(f"    a step (the dependent chain the sweep runs P times): {ms * 1e3 / p:.3f}us; "
              f"state differences where the picks agree: {err:.2e}")
    # the card cases of tests/test_torch_cuda.py against the bits of the kernel
    # that recomputed every cluster's whole predictive at every step
    for case in saved._GIBBS_DIGESTS:
        check(saved._gibbs_digest(case, dev) == saved._GIBBS_DIGESTS[case],
              f"gibbs_z_sweep {case}: z, w and the statistics equal the earlier kernel's bits "
              f"({saved._GIBBS_DIGESTS[case]})")

    # the round op: each of 8 chains against its own pool size, as the w
    # moves of phase N give them (N_k of a few hundred to a few thousand)
    from repro_torch.kernels.t_test_round import t_test_round, t_test_round_ref

    rng = np.random.default_rng(71)
    k, m = 8, 100
    sizes = np.array([40, 150, 480, 900, 1500, 2500, 3300, 4000], np.float32)
    count = np.minimum(rng.integers(0, 400, k), sizes - 1).astype(np.float32)
    count[:2] = 0
    mean0 = rng.normal(0, 0.05, k).astype(np.float32)
    state = [count, mean0, (np.maximum(count - 1, 0) * rng.uniform(0.5, 2, k)).astype(np.float32),
             rng.normal(0, 0.05, k).astype(np.float32), np.full(k, 0.05, np.float32),
             np.zeros(k, np.int32), np.zeros(k, bool), np.zeros(k, bool), np.ones(k, np.float32)]
    base = [torch.tensor(a, device=dev) for a in state]
    lt = torch.tensor((mean0[:, None] + rng.standard_normal((k, m))).astype(np.float32), device=dev)
    vt = torch.tensor(np.arange(m)[None, :] < np.minimum(m, sizes - count)[:, None], device=dev)
    nt = torch.tensor(sizes, device=dev)
    sk2, sp2 = [b.clone() for b in base], [b.clone() for b in base]
    reset_k = lambda: [s.copy_(b) for s, b in zip(sk2, base)]
    reset_p = lambda: [s.copy_(b) for s, b in zip(sp2, base)]
    run = lambda: t_test_round(lt, vt, *sk2[:5], nt, 1000, *sk2[5:])
    plain = lambda: t_test_round_ref(lt, vt, *sp2[:5], nt, 1000, *sp2[5:])
    reset_k(); run(); reset_p(); plain()
    torch.cuda.synchronize()
    check(bool(sk2[6][:2].all()), "t_test_round per-chain n_total: the pools of 40 and 150 are "
          "exhausted by their round")
    errs, rel_p = compare_round(sk2, sp2, f"K={k} m={m} per-chain n_total 40..4000")
    (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 30, reset_k), \
        time_ms(plain, 5, reset_p, queued=False)
    reset_ms, _ = time_ms(lambda: None, 30, reset_k)
    ms -= reset_ms
    record(report, "t_test_round", f"K={k} m={m} per-chain n_total (M, N)", errs["pval"], ms,
           plain_ms, k * m * 5 + k * 11 * 4 * 2, k * m * 8 + k * 200 * SF_ITER_FLOPS,
           host_ms, plain_host_ms, False, pval_rel=rel_p)
    for case in saved._ROUND_CASES:
        scalar = saved._digest(saved._run_rounds(
            case, dev, lambda *a: ops.t_test_round(*a, mode="always")))

        def per_chain(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds, *rest):
            ops.t_test_round(l, valid, count, mean, m2, mu0, eps, torch.full_like(mu0, n_total),
                             max_rounds, *rest, mode="always")

        chains = saved._digest(saved._run_rounds(case, dev, per_chain))
        check(scalar == chains == saved._ROUND_DIGESTS[case],
              f"t_test_round {case}: null n_total and a per-chain n_total equal to it give the "
              f"saved bits ({saved._ROUND_DIGESTS[case]})")

    # the logit delta on x_aug = [x, 1]: phase N's gathered round, phase M's one replica
    x_aug, y = data.x_aug, data.y
    for kk in (JDPM_K, 1):
        w = torch.randn((kk, d + 1), generator=gen, device=dev)
        wq = w + 0.3 * torch.randn((kk, d + 1), generator=gen, device=dev)
        idx = torch.randint(0, n, (kk, 100), generator=gen, device=dev, dtype=torch.int32)
        if kk == 1:
            name, label = "logit_delta", f"rounds: m=100 of N={n} D=3 [x, 1] (M)"
            run = lambda: ops.logit_delta(x_aug, y, w[0], wq[0], idx=idx[0])
            plain = lambda: ops.logit_delta(x_aug, y, w[0], wq[0], idx=idx[0], mode="never")
        else:
            name, label = "batched_logit_delta", f"gather K={kk} m=100 of N={n} D=3 [x, 1] (N)"
            run = lambda: ops.gather_and_delta(x_aug, y, idx, w, wq)
            plain = lambda: ops.gather_and_delta(x_aug, y, idx, w, wq, mode="never")
        lib = lambda: logit_library(x_aug, y, w, wq, idx=idx)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"{name} {label} within 1e-5 of its plain version")
        (ms, host_ms), (plain_ms, plain_host_ms) = time_ms(run, 60), time_ms(plain, 10)
        lib_ms, _ = time_ms(lib, 30)
        record(report, name, label, err, ms, plain_ms, kk * 100 * (3 * 4 + 4 + 4 + 4) + 2 * kk * 12,
               kk * 100 * (4 * 3 + 30), host_ms, plain_host_ms, False, library_ms=lib_ms)


def jdpm_w_summary(info) -> dict:
    """Acceptance, mean n_evaluated / N_k and rounds of w moves (any leading
    axes), and n_evaluated <= N_k on all of them."""
    n_k = info.n_k.double().clamp_min(1.0)
    return {"accept": float(info.accepted.double().mean()),
            "frac_evaluated": float((info.n_evaluated.double() / n_k).mean()),
            "rounds": float(info.rounds.double().mean()),
            "within_pool": bool((info.n_evaluated <= info.n_k).all())}


def phase_m(report, data):
    """One replica of the paper's Fig. 7 program at the reference's full
    setting; then exact against subsampled w moves from the final state."""
    import numpy as np
    import torch

    from repro_torch.experiments import jointdpm as jd

    cfg = jd.JDPMConfig()
    print(f"phase M: joint DP mixture, one replica, N={JDPM_N} (test {JDPM_N_TEST}) D=2 "
          f"K_max={cfg.k_max}, {JDPM_CYCLES} cycles: alpha MH, Gibbs over N/2 points, 10 "
          "subsampled w moves (batch 100, epsilon 0.1, sigma 0.3)")
    state0 = jd.init_state(80, data, cfg)

    def run():
        jd.run_posterior_sequential(81, data, cfg, 1, state0=state0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jd.run_posterior_sequential(82, data, cfg, JDPM_CYCLES, state0=state0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, samples, infos), wall = counted(report, "M", run)
    acc0 = jd.accuracy(jd.predict_proba(state0, data.x_test, cfg), data.y_test)
    acc1 = jd.accuracy(jd.predict_proba(state, data.x_test, cfg), data.y_test)
    cyc = jd.make_inference_cycle(data, cfg)
    gen = torch.Generator(device="cuda").manual_seed(83)
    op_us = {}
    for name, op in zip(cyc.names, cyc.ops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            op.fn(gen, state)
        torch.cuda.synchronize()
        op_us[name] = (time.perf_counter() - t0) / 3 * 1e6
    moves = {}
    for exact in (False, True):
        st, got = state, []
        g = torch.Generator(device="cuda").manual_seed(84)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(JDPM_W_TIMED):
            st, info = jd.subsampled_mh_w(g, st, data, cfg, batch_size=100, epsilon=0.1,
                                          sigma_prop=0.3, exact=exact)
            got.append(info)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / JDPM_W_TIMED * 1e6
        summ = jdpm_w_summary(jd.WMoveInfo(*(torch.stack(f) for f in zip(*got))))
        moves["exact" if exact else "subsampled"] = {"us_per_move": us, **summ}
    r = {"cycles_per_s": JDPM_CYCLES / wall, "op_us": op_us, "w": jdpm_w_summary(infos["w"]),
         "k_active_final": int(samples["k_active"][-1]), "alpha_final": float(state.alpha),
         "accuracy_initial": acc0, "accuracy_final": acc1, "w_moves_from_final": moves}
    report["phases"]["M"].update(r)
    print(f"  cycles/s={r['cycles_per_s']:.2f}  within a cycle: Gibbs sweep {op_us['z']:.0f}us, "
          f"alpha {op_us['alpha']:.0f}us, 10 w moves {op_us['w']:.0f}us")
    print(f"  w moves: {r['w']}; final k_active={r['k_active_final']} alpha={r['alpha_final']:.4f}")
    print(f"  test accuracy: initial {acc0:.4f}, final {acc1:.4f}")
    for kind, v in moves.items():
        print(f"  {JDPM_W_TIMED} {kind} w moves from the final state: {v['us_per_move']:.0f}us a "
              f"move, n_evaluated / N_k {v['frac_evaluated']:.4f}, rounds {v['rounds']:.2f}")
    finite = all(np.isfinite(samples[v].cpu().numpy()).all() for v in ("w", "alpha"))
    check(finite and r["w"]["within_pool"] and 0.0 < r["w"]["accept"] < 1.0,
          "phase M: samples finite, n_evaluated <= N_k, w moves accept and reject")
    check(acc1 >= acc0 + 0.05 and acc1 > 0.58,
          f"phase M: test accuracy rises by >= 0.05 and ends above 0.58 ({acc0:.4f} -> {acc1:.4f})")
    check(moves["exact"]["frac_evaluated"] == 1.0 and moves["subsampled"]["within_pool"],
          "phase M: exact w moves evaluate all N_k members")
    return state0


def phase_n(report, data, state0):
    """K = 8 replicas of phase M's program in lock-step; then an ensemble of
    one replica against the sequential run, bit for bit."""
    import numpy as np
    import torch

    from repro_torch._device import tree_leaves, tree_map
    from repro_torch.experiments import jointdpm as jd

    cfg = jd.JDPMConfig()
    print(f"phase N: joint DP mixture, K={JDPM_K} replicas in lock-step, {JDPM_CYCLES} cycles, "
          "phase M's setting and initial state")

    def run():
        jd.run_posterior_ensemble(91, data, cfg, JDPM_K, 1, state0=state0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jd.run_posterior_ensemble(92, data, cfg, JDPM_K, JDPM_CYCLES, state0=state0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, samples, infos, diag), wall = counted(report, "N", run)
    theta = state.theta
    per = []
    for k in range(JDPM_K):
        one = tree_map(lambda l: l[k], theta)
        acc = jd.accuracy(jd.predict_proba(one, data.x_test, cfg), data.y_test)
        per.append({"accuracy_final": acc, "k_active_final": int(samples["k_active"][k, -1]),
                    "alpha_final": float(theta.alpha[k]),
                    **jdpm_w_summary(tree_map(lambda l: l[k], infos["w"]))})
    r = {"cycles_per_s_summed": JDPM_K * JDPM_CYCLES / wall, "replicas": per,
         "w": jdpm_w_summary(infos["w"])}
    report["phases"]["N"].update(r)
    print(f"  cycles/s summed over replicas={r['cycles_per_s_summed']:.2f}; w moves: {r['w']}")
    for k, v in enumerate(per):
        print(f"  replica {k}: {v}")
    check(np.isfinite(samples["w"].cpu().numpy()).all() and r["w"]["within_pool"]
          and 0.0 < r["w"]["accept"] < 1.0,
          "phase N: samples finite, n_evaluated <= N_k, w moves accept and reject")

    kw = dict(batch_size=100, w_moves=4)
    _, s1, i1, _ = jd.run_posterior_ensemble(93, data, cfg, 1, 3, state0=state0, **kw)
    _, s2, i2 = jd.run_posterior_sequential(93, data, cfg, 3, state0=state0, **kw)
    same = all(torch.equal(a[0], b) for a, b in
               zip(tree_leaves(s1) + tree_leaves(i1), tree_leaves(s2) + tree_leaves(i2)))
    check(same, "phase N: an ensemble of one replica equals run_posterior_sequential, samples "
          "and infos bit for bit, on the card (3 cycles)")


# ---------------------------------------------------------------------------
# Phases H-J: the LM slice (chatglm3-6b at full width)
# ---------------------------------------------------------------------------

LM_ARCH = "chatglm3-6b"
LM_STEPS, LM_EXACT_STEPS = 20, 3
CE_SIGMA = 1.2e-4  # RW std on the unembedding table (acceptance ~0.1-0.6 on the card)
CE_PRIOR_VAR = 1.0
CE_SEQS, CE_SEQ_LEN = 64, 128  # N = 64 x 127 = 8128 next-token sections


def gaussian_log_global(prior_var):
    """log N(theta' | 0, v I) - log N(theta | 0, v I) for a (V, D) table, or
    (K,) for (K, V, D) tables: sum((theta' - theta)(theta' + theta)) in
    blocks of rows, which keeps the temporaries small and avoids differencing
    two float32 totals of ~1e5."""
    def log_global(theta, theta_p):
        total = 0.0
        for a, b in zip(theta.split(8192, dim=-2), theta_p.split(8192, dim=-2)):
            total = total + ((b - a) * (b + a)).sum((-2, -1))
        return (-0.5 / prior_var) * total
    return log_global


def lm_ce_setup(params, cfg):
    """The ce family's data from the LM: final hidden states of 64
    MarkovStream sequences of 128 tokens and their next tokens
    (``forward_hidden`` over tokens[:, :-1]), and the target over the
    unembedding table with a Gaussian prior."""
    from repro_torch import convert
    from repro_torch.core import build_target
    from repro_torch.data import DataConfig, MarkovStream
    from repro_torch.models import forward_hidden

    tokens = MarkovStream(DataConfig(cfg.vocab, CE_SEQ_LEN, CE_SEQS, seed=1)).batch(0)["tokens"]
    h = forward_hidden(params, tokens[:, :-1], cfg)
    data = convert.ce_data(h.reshape(-1, cfg.d_model), tokens[:, 1:])
    n = data[0].shape[0]
    target = build_target("ce", data, n, log_global=gaussian_log_global(CE_PRIOR_VAR))
    return data, target


RESUME_LAYERS = 2  # depth of the crash-and-resume check (width stays full)


def phase_h(report):
    """The reference launcher's path on the port: ``repro_torch.launch.train``
    for chatglm3-6b at full width and depth with the launcher's defaults,
    then a run stopped by an injected failure and resumed from its
    checkpoint, against an uninterrupted run.

    Disk: a full-size checkpoint is 12 GB and the script keeps its writes to
    about 30 GB, so each launcher run writes one (``--ckpt-every`` at the
    run's length) and the resume check, which needs four, runs at full width
    with the depth cut to ``RESUME_LAYERS`` layers (1.35 GB each)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.bayes import TrainConfig, make_train_step
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, MarkovStream
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.runtime import InjectedFailure, LoopConfig, run_loop

    cfg = ARCHS[LM_ARCH]
    print(f"phase H: the LM launcher, {cfg.name} at full width and depth ({cfg.n_layers} layers, "
          f"d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, d_ff={cfg.d_ff}, V={cfg.vocab}; "
          f"{cfg.param_count():,} parameters in bf16), launcher defaults (batch 16, seq 64, "
          f"round batch 4, eps 0.05, sigma 1e-4): {LM_EXACT_STEPS} exact + {LM_STEPS} subsampled "
          "steps, one checkpoint each")
    r = report["phases"]["H"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        def run():
            exact = train.main(["--steps", str(LM_EXACT_STEPS), "--kernel", "exact",
                                "--ckpt-every", str(LM_EXACT_STEPS), "--ckpt-dir", f"{tmp}/exact"])
            exact.pop("params")
            sub = train.main(["--steps", str(LM_STEPS), "--ckpt-every", str(LM_STEPS),
                              "--ckpt-dir", f"{tmp}/sub"])
            return sub, exact

        sub, exact = counted(report, "H", run)
        for name, out in (("subsampled", sub), ("exact", exact)):
            infos = out["infos"]
            r[name] = {"steps": len(infos), "steps_per_s": out["steps_per_s"],
                       "step_ms_median": 1e3 * statistics.median(out["step_s"][1:]),
                       "wall_s": out["wall_s"], "peak_gib": (out["peak_bytes"] or 0) / 2 ** 30,
                       "accept": float(np.mean([i["accepted"] for i in infos])),
                       "mean_sections": float(np.mean([i["n_evaluated"] for i in infos])),
                       "mean_rounds": float(np.mean([i["rounds"] for i in infos]))}
            print(f"  {name}: {r[name]}")
        check(all(np.isfinite(i["mu_hat"]) for i in sub["infos"] + exact["infos"])
              and all(int(i["n_evaluated"]) == 16 for i in exact["infos"]),
              "phase H: finite mu_hat on every step; exact steps evaluate all 16 sequences")
        check(all(bool(torch.isfinite(l.float()).all()) for l in
                  [sub["params"]["embed"]["table"], sub["params"]["layers"]["mlp"]["wo"]]),
              "phase H: the chain's parameters stay finite")

        # the launcher's chain stopped by an injected failure at step 15 and
        # resumed from its step-9 checkpoint must end where the same chain
        # run without a stop ends (full width, depth cut for the disk)
        small = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
        print(f"  resume check: {small.name} at full width, depth cut {cfg.n_layers} -> "
              f"{RESUME_LAYERS} layers ({small.param_count():,} parameters, "
              f"{2 * small.param_count() / 1e9:.2f} GB a checkpoint), {LM_STEPS} steps, "
              "checkpoints every 10")
        step = make_train_step(small, TrainConfig(round_batch=4, epsilon=0.05, sigma=1e-4))
        stream = MarkovStream(DataConfig(small.vocab, 64, 16, seed=0))
        params0 = init_params(0, small)
        loop = lambda d, **kw: LoopConfig(num_steps=LM_STEPS, ckpt_dir=f"{tmp}/{d}", ckpt_every=10,
                                          **kw)
        t0 = time.perf_counter()
        clean = run_loop(step, params0, stream.batch, loop("clean"))
        try:
            run_loop(step, params0, stream.batch, loop("crash", fail_at_step=15))
            raise CheckFailed("phase H: the injected failure did not fire")
        except InjectedFailure:
            pass
        resumed = run_loop(step, params0, stream.batch, loop("crash"))
        torch.cuda.synchronize()
        r["resume_wall_s"] = time.perf_counter() - t0
        r["resume_layers"] = RESUME_LAYERS
        same = all(torch.equal(a, b) for a, b in zip(_leaves(clean["params"]),
                                                     _leaves(resumed["params"])))
        same_infos = all(np.array_equal(a[k], b[k])
                         for a, b in zip(clean["infos"][10:], resumed["infos"]) for k in a)
        moved = sum(bool(i["accepted"]) for i in clean["infos"])
        print(f"  resume: {len(resumed['infos'])} steps after the restore, {moved} of {LM_STEPS} "
              f"steps accepted, {r['resume_wall_s']:.1f}s for the three runs")
        check(same and same_infos and len(resumed["infos"]) == LM_STEPS - 10 and moved > 0,
              "phase H: the run stopped at step 15 and resumed from step 9 equals the "
              "uninterrupted run (every parameter bit and every step's info)")
        del params0, clean, resumed
    params = sub.pop("params")
    return params, cfg


def _leaves(tree):
    from repro_torch._device import tree_leaves

    return tree_leaves(tree)


def phase_i(report, params, cfg):
    """The ce family on one chain: the unembedding table of phase H's model
    under subsampled MH over its N = 8128 next-token sections (kernel
    ``fused_ce``)."""
    import numpy as np
    import torch

    from repro_torch.core import RandomWalk, SubsampledMHConfig, finish_transition, fy_init, run_chain
    from repro_torch.core.samplers import fy_draw, fy_reset

    data, target = lm_ce_setup(params, cfg)
    n = target.num_sections
    h_desc = f"h {tuple(data[0].shape)} {data[0].dtype}"
    del data
    table = params["embed"]["table"].float()
    print(f"phase I: ce family, one chain: fp32 table {tuple(table.shape)}, N={n} sections "
          f"({h_desc}), m=100, eps 0.05, Fisher-Yates, "
          f"RW sigma {CE_SIGMA:g}, prior N(0, {CE_PRIOR_VAR:g}), 50 transitions")
    mh = SubsampledMHConfig(batch_size=CE_M, epsilon=0.05, sampler="fy")
    rw = RandomWalk(CE_SIGMA)
    small = lambda t: t[:2, :4].clone()

    def run():
        run_chain(30, table, target, rw, 2, config=mh, collect=small)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_chain(31, table, target, rw, 50, config=mh, collect=small)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (theta, samples, infos), wall = counted(report, "I", run)
    r = {"transitions_per_s": 50 / wall, "accept": float(infos.accepted.float().mean()),
         "mean_rounds": float(infos.rounds.float().mean()),
         "frac_evaluated": float(infos.n_evaluated.float().mean()) / n, "sigma": CE_SIGMA,
         "n_sections": n}
    report["phases"]["I"].update(r)
    print(f"  transitions/s={r['transitions_per_s']:.2f} rounds/transition={r['mean_rounds']:.2f} "
          f"frac_evaluated={r['frac_evaluated']:.4f} acceptance={r['accept']:.3f}")
    check(bool(torch.isfinite(samples).all()) and bool(torch.isfinite(infos.mu_hat).all()),
          "phase I: samples and mu_hat finite")
    check(0.0 < r["accept"] < 1.0, "phase I: the chain accepts and rejects")

    # the fused route against fused_kernels="never" on 20 fixed proposals
    err = 2 * report["kernels"]["fused_ce"]["max_abs_err"]  # a delta is two per-token values
    g = torch.Generator(device="cuda").manual_seed(33)
    rows = []
    for i in range(20):
        theta_p = theta + CE_SIGMA * torch.randn(theta.shape, generator=g, device="cuda")
        log_u = torch.log(torch.rand((), generator=g, device="cuda").clamp_min(1e-20))
        mu0 = (log_u - target.log_global(theta, theta_p)) / n
        out = {}
        for route in ("auto", "never"):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            sampler = fy_init(n, device=theta.device)
            _, _, out[route] = finish_transition(gen, theta, theta_p, mu0, log_u, sampler, target,
                                                 mh, fy_reset, fy_draw, mode=route)
        a, b = out["auto"], out["never"]
        rows.append((bool(a.accepted) != bool(b.accepted) or int(a.n_evaluated) != int(b.n_evaluated),
                     abs(float(b.mu_hat) - float(mu0)), abs(float(b.pvalue) - 0.05),
                     abs(float(a.mu_hat) - float(b.mu_hat)), float(a.accepted)))
        del theta_p
    differ = [x for x in rows if x[0]]
    unexplained = [x for x in differ if x[1] > err and x[2] > 1e-3 * 0.05]
    report["phases"]["I"]["fused_vs_plain_differ"] = len(differ)
    print(f"  fused vs never on 20 proposals: {len(differ)} differ in decision or n_evaluated; "
          f"max |mu_hat diff| {max(x[3] for x in rows):.3e} (kernel error bound on a delta "
          f"{err:.3e}); acceptance {np.mean([x[4] for x in rows]):.2f}")
    check(not unexplained, "phase I: fused and plain routes agree on every proposal whose "
          "|mu_hat - mu0| exceeds the kernel's error and whose p-value is not within 0.1% of eps")
    return target, theta


def phase_j(report, target, theta):
    """The same target on K=8 lock-step chains with per-chain (8, V, D) fp32
    tables (kernel ``batched_fused_ce``, gathering each chain's rows)."""
    import torch

    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig

    k, steps = CE_K, 20
    n = target.num_sections
    print(f"phase J: ce family, K={k} lock-step chains, per-chain fp32 tables "
          f"({k}, {theta.shape[0]}, {theta.shape[1]}), {steps} steps")
    ens = ChainEnsemble(target, RandomWalk(CE_SIGMA), k,
                        config=SubsampledMHConfig(batch_size=CE_M, epsilon=0.05, sampler="fy"),
                        collect=lambda t: t[:, :2, :4].clone())
    state = ens.init(theta)
    del theta
    torch.cuda.reset_peak_memory_stats()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ens.run(41, state, steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, samples, infos), wall = counted(report, "J", run)
    r = {"transitions_per_s": k * steps / wall, "accept": float(infos.accepted.float().mean()),
         "mean_rounds": float(infos.rounds.float().mean()),
         "lockstep_rounds_per_step": float(infos.rounds.max(0).values.float().mean()),
         "frac_evaluated": float(infos.n_evaluated.float().mean()) / n,
         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report["phases"]["J"].update(r)
    print(f"  transitions/s (summed over chains)={r['transitions_per_s']:.2f} lock-step rounds/step="
          f"{r['lockstep_rounds_per_step']:.2f} rounds/chain={r['mean_rounds']:.2f} "
          f"frac_evaluated={r['frac_evaluated']:.4f} acceptance={r['accept']:.3f} "
          f"peak {r['peak_gib']:.1f} GiB")
    check(bool(torch.isfinite(samples).all()) and samples.shape == (k, steps, 2, 4),
          f"phase J samples finite, shape {tuple(samples.shape)}")
    check(0.0 < r["accept"] < 1.0, "phase J: the chains accept and reject")


# ---------------------------------------------------------------------------
# Phases P and S: compiled programs (repro_torch.ppl) and the Sec. 3.3 safeguard
# ---------------------------------------------------------------------------

P_STEPS = 200  # P's K=32 lock-step steps, and its one chain's transitions
# phase G's largest N; K=32 lock-step steps, each close to the pool's 1 000
# rounds (the slowest of 32 chains' tests nearly always exhausts it)
P_AR1_N, P_AR1_STEPS = 100_000, 30
P_AR1_PHI, P_AR1_SIGMA, P_AR1_RW = 0.9, 0.3, 0.002  # posterior sd of phi ~0.0014


def bayeslr_program(x, y):
    """The paper's BayesLR as a probabilistic program (the program of the
    reference's ``make_ppl_workload``, at Sec. 4.1's width): w ~ N(0,
    PRIOR_VAR I), y_i ~ Logit(x_i . w), compiled onto the ``logit`` family."""
    import torch

    from repro_torch.experiments import bayeslr
    from repro_torch.ppl import Trace, compile_partitioned_target, dists

    n, d = x.shape
    tr = Trace()
    w = tr.sample("w", dists.mvnormal_diag, tr.constant("mu_w", torch.zeros(d)),
                  tr.constant("sig_w", math.sqrt(bayeslr.PRIOR_VAR) * torch.ones(d)),
                  value=torch.zeros(d))
    with tr.plate("data", n):
        xn = tr.constant("x", x)
        z = tr.det("z", lambda xx, ww: xx @ ww, xn, w)
        yn = tr.sample("y", dists.bernoulli_logits, z, value=y)
        tr.observe(yn, y)
    return compile_partitioned_target(tr, w)


def ar1_program(series, sigma: float):
    """An AR(1) state-space program, x_t ~ Normal(phi x_{t-1}, sigma) over
    the transition factors of one observed series, phi ~ Normal(0, 1): the
    target is phi, compiled onto the ``gaussian_ar1`` family."""
    import torch

    from repro_torch.ppl import Trace, compile_partitioned_target, dists

    tr = Trace()
    phi = tr.sample("phi", dists.normal, tr.constant("m0", 0.0), tr.constant("s0", 1.0),
                    value=torch.tensor(0.5))
    sig = tr.constant("sigma", sigma)
    with tr.plate("steps", len(series) - 1):
        mu = tr.det("mu", lambda xp, ph: ph * xp, tr.constant("x_prev", series[:-1]), phi)
        xt = tr.sample("x", dists.normal, mu, sig, value=series[1:])
        tr.observe(xt, series[1:])
    return compile_partitioned_target(tr, phi)


def ar1_series(seed: int, n: int):
    """x_0 = 0, x_t = P_AR1_PHI x_{t-1} + P_AR1_SIGMA eps_t: n transition
    factors, on the card."""
    import numpy as np
    import torch

    eps = P_AR1_SIGMA * np.random.default_rng(seed).standard_normal(n + 1)
    x = np.zeros(n + 1, np.float32)
    for t in range(1, n + 1):
        x[t] = P_AR1_PHI * x[t - 1] + eps[t]
    return torch.tensor(x, device="cuda")


def fused_vs_never(target, theta, theta_p, log_u, cfg, label, gen_seed=None):
    """The fused route ("always") against the batched plain route ("never")
    on a batch of fixed proposals (a leading batch axis on theta, theta' and
    log u), each a whole sequential test under ``cfg``; with the
    Fisher–Yates sampler both routes draw from a generator seeded
    ``gen_seed``. A difference in decision or n_evaluated is allowed only
    where a p-value lies within 0.1% of epsilon. Returns the count of
    proposals that differ."""
    import torch

    from repro_torch.core import finish_transition
    from repro_torch.core.samplers import batch_sampler_state, fy_init, sampler_fns, stream_init

    n, b = target.num_sections, log_u.shape[0]
    mu0 = (log_u - target.log_global(theta, theta_p)) / n
    reset_fn, draw_fn = sampler_fns(cfg.sampler)
    out = {}
    for route in ("always", "never"):
        state = batch_sampler_state(fy_init(n) if cfg.sampler == "fy" else stream_init(n), b)
        gen = None if gen_seed is None else torch.Generator(device="cuda").manual_seed(gen_seed)
        _, _, info = finish_transition(gen, theta, theta_p, mu0, log_u, state, target, cfg,
                                       reset_fn, draw_fn, max_rounds=-(-n // cfg.batch_size),
                                       mode=route,
                                       eval_fn=target.local_round(theta, theta_p, ensemble=True,
                                                                  mode=route))
        out[route] = info
    a, c = out["always"], out["never"]
    differ = (a.accepted != c.accepted) | (a.n_evaluated != c.n_evaluated)
    eps = cfg.epsilon
    borderline = ((c.pvalue - eps).abs() <= 1e-3 * eps) | ((a.pvalue - eps).abs() <= 1e-3 * eps)
    n_diff = int(differ.sum())
    print(f"  {label}: fused vs never on {b} proposals: {n_diff} differ in decision or "
          f"n_evaluated; max |mu_hat diff| {float((a.mu_hat - c.mu_hat).abs().max()):.3e}; "
          f"acceptance {float(a.accepted.float().mean()):.3f}")
    check(not bool((differ & ~borderline).any()),
          f"{label}: fused and plain routes agree on every proposal whose p-value is not within "
          "0.1% of epsilon")
    return n_diff


def phase_p(report, data, c_samples, c_infos):
    """Compiled programs at full width: the BayesLR program on B/C's data
    (its K=32 rounds through the logit kernel, one chain through the graph)
    and an AR(1) program over N = 1e5 transition factors (K=32 rounds
    through the AR(1) kernel). The K=32 run starts as C does (seed, start
    and settings), so its steps are compared with C's first ones; host time
    is compared a lock-step round, since early steps run fewer rounds."""
    import numpy as np
    import torch

    from repro_torch._device import make_generator
    from repro_torch.core import (ChainEnsemble, RandomWalk, SubsampledMHConfig, acceptance_rate,
                                  ensemble_summary, finish_transition, run_chain)
    from repro_torch.core.samplers import batch_sampler_state, sampler_fns, stream_init
    from repro_torch.experiments import bayeslr

    dev = torch.device("cuda")
    n, d = data.x_train.shape
    k = 32
    print(f"phase P: compiled programs (repro_torch.ppl): BayesLR N={n} D={d}, K={k} x "
          f"{P_STEPS} steps and one chain x {P_STEPS}; AR(1) N={P_AR1_N}, K={k} x {P_AR1_STEPS}")
    laps = [("start", time.perf_counter())]  # where the phase's seconds go
    t0 = time.perf_counter()
    target = bayeslr_program(data.x_train, data.y_train)
    compile_s = time.perf_counter() - t0
    check(target.family == "logit", f"the BayesLR program compiles onto the logit family "
          f"({compile_s:.3f}s)")
    hand = bayeslr.make_target(data.x_train, data.y_train)

    # C's 200 fixed proposals: the compiled (K, m) rounds are the hand-built
    # target's bit for bit, and so is a whole sequential test from one mu0
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")
    rng = np.random.default_rng(7)
    flat = c_samples.reshape(-1, d)
    theta = torch.tensor(flat[rng.integers(0, len(flat), 200)], device=dev)
    theta_p = theta + 0.05 * torch.tensor(rng.standard_normal((200, d)), dtype=torch.float32,
                                          device=dev)
    log_u = torch.tensor(np.log(rng.uniform(1e-20, 1.0, 200)), dtype=torch.float32, device=dev)
    idx = torch.tensor(rng.integers(0, n, (200, 100)), dtype=torch.int32, device=dev)
    check(torch.equal(target.log_local_ensemble(theta, theta_p, idx),
                      hand.log_local_ensemble(theta, theta_p, idx)),
          "compiled log_local_ensemble equals bayeslr.make_target's bit for bit on 200 proposals")
    g_err = float((target.log_global(theta, theta_p) - hand.log_global(theta, theta_p)).abs().max())
    check(g_err <= 1e-4, f"compiled log_global within 1e-4 of the hand prior's difference "
          f"(max {g_err:.2e})")
    mu0 = (log_u - hand.log_global(theta, theta_p)) / n
    reset_fn, draw_fn = sampler_fns("stream")
    infos = [finish_transition(None, theta, theta_p, mu0, log_u,
                               batch_sampler_state(stream_init(n), 200), t, cfg, reset_fn, draw_fn,
                               max_rounds=-(-n // 100),
                               eval_fn=t.local_round(theta, theta_p, ensemble=True))[2]
             for t in (target, hand)]
    check(all(torch.equal(a, b) for a, b in zip(*infos)),
          "a sequential test of the compiled target from the hand-built target's mu0 gives its "
          "infos bit for bit")
    laps.append(("BayesLR compiled and held to the hand-built target", time.perf_counter()))

    def run():
        gen = make_generator(3, dev)
        ens = ChainEnsemble(target, RandomWalk(0.05), k, config=cfg)
        theta0 = 0.5 * torch.randn(k, d, generator=gen, device=dev)  # as phase C starts
        t0 = time.perf_counter()
        _, samples, infos = ens.run(gen, ens.init(theta0, batched=True), P_STEPS)
        torch.cuda.synchronize()
        return samples.cpu().numpy(), infos, time.perf_counter() - t0

    samples, infos, wall = counted(report, "P", run)
    summ = ensemble_summary(infos)
    c = report["phases"]["C"]
    c_round_ms = 32 * 1000 / c["transitions_per_s"] / c["lockstep_rounds"] * 1e3
    same = [f for f in ("accepted", "n_evaluated", "rounds")
            if torch.equal(getattr(infos, f), getattr(c_infos, f)[:, :P_STEPS])]
    r = {"family": target.family, "compile_s": compile_s, "log_global_max_err": g_err,
         "transitions_per_s": k * P_STEPS / wall, "accept": summ["accept_rate_overall"],
         "mean_rounds": summ["mean_rounds_overall"],
         "mean_n_evaluated_frac": summ["mean_n_evaluated_overall"] / n,
         "lockstep_rounds": int(infos.rounds.long().max(0).values.sum()),
         "equals_c_first_steps": bool(np.array_equal(samples, c_samples[:, :P_STEPS])),
         "infos_equal_c_first_steps": same}
    r["ms_per_lockstep_round"] = wall / r["lockstep_rounds"] * 1e3
    report["phases"]["P"].update(r)
    print(f"  compiled K={k}: transitions/s={r['transitions_per_s']:.1f} (C over its 1000 steps, "
          f"hand-built, {c['transitions_per_s']:.1f}); {r['lockstep_rounds']} lock-step rounds, "
          f"{r['ms_per_lockstep_round']:.4f} ms a round (C {c_round_ms:.4f}); rounds a transition "
          f"{r['mean_rounds']:.2f}; n_evaluated/N={r['mean_n_evaluated_frac']:.4f}; acceptance "
          f"{r['accept']:.3f}; samples equal C's first {P_STEPS} steps: "
          f"{r['equals_c_first_steps']}, info fields equal: {same}")
    check(bool(np.isfinite(samples).all()) and samples.shape == (k, P_STEPS, d),
          f"phase P samples finite, shape {samples.shape}")
    check(0.05 < r["accept"] < 0.95, "phase P acceptance in (0.05, 0.95)")
    laps.append((f"BayesLR K={k}", time.perf_counter()))

    def run_one():
        t0 = time.perf_counter()
        _, samples, infos = run_chain(1, torch.zeros(d), target, RandomWalk(0.05), P_STEPS,
                                      config=cfg)
        torch.cuda.synchronize()
        return samples, infos, time.perf_counter() - t0

    samples, infos, wall = counted(report, "P1", run_one)
    b = report["phases"]["B"]
    b_round_ms = 1000 / b["transitions_per_s"] / (1000 * b["mean_rounds"]) * 1e3
    r1 = {"transitions_per_s": P_STEPS / wall, "accept": acceptance_rate(infos),
          "mean_rounds": float(infos.rounds.float().mean()),
          "mean_n_evaluated_frac": float(infos.n_evaluated.float().mean()) / n}
    r1["ms_per_round"] = wall / (P_STEPS * r1["mean_rounds"]) * 1e3
    report["phases"]["P1"].update(r1)
    print(f"  compiled, one chain (the graph route): transitions/s={r1['transitions_per_s']:.1f} "
          f"(B over its 1000, hand-built, {b['transitions_per_s']:.1f}); "
          f"{r1['ms_per_round']:.4f} ms a round (B {b_round_ms:.4f}); rounds a transition "
          f"{r1['mean_rounds']:.2f}; acceptance {r1['accept']:.3f}")
    check(bool(torch.isfinite(samples).all()) and samples.shape == (P_STEPS, d),
          f"phase P one-chain samples finite, shape {tuple(samples.shape)}")
    laps.append(("BayesLR one chain", time.perf_counter()))

    # the AR(1) program
    series = ar1_series(17, P_AR1_N)
    t0 = time.perf_counter()
    ar1 = ar1_program(series, P_AR1_SIGMA)
    compile_s = time.perf_counter() - t0
    check(ar1.family == "gaussian_ar1", f"the AR(1) program compiles onto the gaussian_ar1 "
          f"family ({compile_s:.3f}s)")
    ar1_cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="fy")
    laps.append(("AR(1) series made and compiled", time.perf_counter()))

    def run_ar1():
        gen = make_generator(19, dev)
        ens = ChainEnsemble(ar1, RandomWalk(P_AR1_RW), k, config=ar1_cfg)
        theta0 = P_AR1_PHI + 0.01 * torch.randn(k, generator=gen, device=dev)
        t0 = time.perf_counter()
        _, samples, infos = ens.run(gen, ens.init(theta0, batched=True), P_AR1_STEPS)
        torch.cuda.synchronize()
        return samples, infos, time.perf_counter() - t0

    samples, infos, wall = counted(report, "P-AR1", run_ar1)
    summ = ensemble_summary(infos)
    phi = samples.cpu().numpy()
    ra = {"family": ar1.family, "compile_s": compile_s, "N": P_AR1_N,
          "transitions_per_s": k * P_AR1_STEPS / wall, "accept": summ["accept_rate_overall"],
          "mean_rounds": summ["mean_rounds_overall"],
          "mean_n_evaluated_frac": summ["mean_n_evaluated_overall"] / P_AR1_N,
          "phi_mean_2nd_half": float(phi[:, P_AR1_STEPS // 2:].mean())}
    print(f"  compiled AR(1) K={k}: transitions/s={ra['transitions_per_s']:.1f}; rounds a "
          f"transition {ra['mean_rounds']:.2f}; n_evaluated/N={ra['mean_n_evaluated_frac']:.4f}; "
          f"acceptance {ra['accept']:.3f}; phi over the second half {ra['phi_mean_2nd_half']:.4f} "
          f"(generating {P_AR1_PHI})")
    check(np.isfinite(phi).all() and phi.shape == (k, P_AR1_STEPS),
          f"phase P AR(1) samples finite, shape {phi.shape}")
    check(0.0 < ra["accept"] < 1.0, "phase P AR(1): the chains accept and reject")
    laps.append((f"AR(1) K={k}", time.perf_counter()))
    rng = np.random.default_rng(18)
    theta = torch.tensor(phi.reshape(-1)[rng.integers(0, phi.size, 200)], device=dev)
    theta_p = theta + P_AR1_RW * torch.tensor(rng.standard_normal(200), dtype=torch.float32,
                                              device=dev)
    log_u = torch.tensor(np.log(rng.uniform(1e-20, 1.0, 200)), dtype=torch.float32, device=dev)
    ra["fused_vs_plain_differ"] = fused_vs_never(ar1, theta, theta_p, log_u, ar1_cfg,
                                                 "phase P AR(1)", gen_seed=20)
    report["phases"]["P-AR1"].update(ra)
    laps.append(("AR(1) fused vs never", time.perf_counter()))
    secs = {name: t - laps[i][1] for i, (name, t) in enumerate(laps[1:])}
    report["phases"]["P"]["seconds"] = secs
    print("  phase P's seconds: " + "; ".join(f"{name} {v:.2f}" for name, v in secs.items()))
    return target


def phase_s(report, data, theta_b, compiled):
    """The Sec. 3.3 safeguard at full width: ``trial_run_report`` from B's
    last sample on B's hand-built target (the exact pass the pair delta's
    range form, the rounds the one-chain pair delta), then on phase P's
    compiled program (the graph route, its exact pass included)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import RandomWalk, trial_run_report
    from repro_torch.experiments import bayeslr

    eps, trials = 0.05, 20
    print(f"phase S: the Sec. 3.3 safeguard, N={data.x_train.shape[0]} D={data.x_train.shape[1]}, "
          f"from B's last sample, RW 0.05, batch 100, epsilon {eps}, {trials} trials")
    hand = bayeslr.make_target(data.x_train, data.y_train)
    reports = {}
    for phase, target in (("S", hand), ("S-compiled", compiled)):
        def run(target=target):
            t0 = time.perf_counter()
            rep = trial_run_report(23, theta_b, target, RandomWalk(0.05), batch_size=100,
                                   epsilon=eps, num_trials=trials)
            torch.cuda.synchronize()
            return rep, time.perf_counter() - t0

        rep, secs = counted(report, phase, run)
        fields = dataclasses.asdict(rep)
        report["phases"][phase].update(fields, seconds=secs)
        reports[phase] = fields
        print(f"  {phase}: {secs:.3f}s; " + "; ".join(f"{k}={v}" for k, v in fields.items()))
        check(rep.decision_error_rate <= max(2 * eps, 0.1),
              f"phase {phase}: decision-error rate {rep.decision_error_rate} <= max(2 epsilon, 0.1)")
        check(0.0 < rep.mean_fraction_evaluated <= 1.0,
              f"phase {phase}: 0 < mean fraction evaluated <= 1")
        check(bool(np.isfinite(rep.jb_stat_mean) and np.isfinite(rep.jb_pvalue_min)),
              f"phase {phase}: the Jarque-Bera fields are finite")
    same = [k for k in reports["S"] if reports["S"][k] == reports["S-compiled"][k]]
    print(f"  hand-built beside compiled: equal fields {same}")


# ---------------------------------------------------------------------------
# Phase Q: posterior serving (repro_torch.serving, repro_torch.launch.serve)
# ---------------------------------------------------------------------------

Q_QUERIES = 400  # the front end's non-smoke default, for every workload
Q_BG_COMMITS, Q_BG_MAX_S = 3, 15.0  # background commits timed beside queries, cap
Q_BG_TICK_S = 0.005  # beside them, 8 requests are submitted every tick (1 600/s offered)
Q_SLOW_TICK_S = 0.02  # profile_q_bg's lighter load (400/s offered)
Q_RESUME_STEPS = (64, 32, 16)  # refresh blocks held against one offline run of their sum
# the calls of each kernel wrapper replayed against plain; the Gibbs sweep's
# plain version takes ~7 s a call at N=5 000, so its first call only
Q_HELD_CALLS = {"gibbs_z_sweep": (1,)}
Q_HELD_DEFAULT = (1, 10)
# the kernels each Q phase must launch
Q_NEEDS = {"Q": ("batched_logit_delta", "t_test_round"),
           "Q-bg": ("batched_logit_delta", "t_test_round"),
           "Q-resume": ("batched_logit_delta", "t_test_round"),
           "Q-sv": ("gaussian_ar1_delta", "pgibbs_sweep", "fy_draw", "t_test_round"),
           "Q-jdpm": ("gibbs_z_sweep", "batched_logit_delta", "fy_draw", "t_test_round"),
           "Q-ppl": ("batched_logit_delta", "fy_draw", "t_test_round")}
# each kernel wrapper of kernels/ops.py that serving reaches -> the kernel it launches
SERVED_WRAPPERS = {"logit_delta": "logit_delta", "gather_and_delta": "batched_logit_delta",
                   "batched_logit_delta": "batched_logit_delta",
                   "gather_ar1_delta": "gaussian_ar1_delta",
                   "batched_gaussian_ar1_delta": "gaussian_ar1_delta", "fy_draw": "fy_draw",
                   "pgibbs_sweep": "pgibbs_sweep", "gibbs_z_sweep": "gibbs_z_sweep",
                   "t_test_round": "t_test_round"}


def _copy_tree(a):
    """``a`` with every tensor in it cloned (tuples, named tuples, lists and
    dicts rebuilt; anything else shared)."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_copy_tree(v) for v in a))
    if isinstance(a, (tuple, list)):
        return type(a)(_copy_tree(v) for v in a)
    if isinstance(a, dict):
        return {k: _copy_tree(v) for k, v in a.items()}
    return a


def _call_shape(a):
    """A call's shape: each tensor's shape and dtype, a range's length, a
    number's value."""
    import torch

    if isinstance(a, torch.Tensor):
        return "x".join(map(str, a.shape)) + ":" + str(a.dtype).removeprefix("torch.")
    if isinstance(a, range):
        return f"range({a.start}, {a.stop})"
    if isinstance(a, dict):
        return ",".join(f"{k}={_call_shape(v)}" for k, v in sorted(a.items()))
    if isinstance(a, (tuple, list)):
        return "(" + ",".join(_call_shape(v) for v in a) + ")"
    return repr(a) if isinstance(a, (int, float, bool, str)) or a is None else type(a).__name__


@contextlib.contextmanager
def capture_served_calls(every_shape: bool = False):
    """While open, each call of a wrapper in ``SERVED_WRAPPERS`` whose rank
    among that wrapper's calls is in ``Q_HELD_CALLS`` (default
    ``Q_HELD_DEFAULT``) keeps a copy of its
    arguments, taken before it runs (several update their inputs in
    place); a serving workload calls each wrapper at one shape, apart from
    the mixture's pools of cluster members and a pool grown by an append.
    With ``every_shape``, the first call at each shape a wrapper is given is
    kept too (a grown pool's). Yields the list of ``(wrapper, args,
    kwargs)``; the calls themselves run as they would, each paying a
    counter's increment."""
    from repro_torch.kernels import ops

    seen, calls, lock = dict.fromkeys(SERVED_WRAPPERS, 0), [], threading.Lock()
    shapes = {name: set() for name in SERVED_WRAPPERS}
    originals = {name: getattr(ops, name) for name in SERVED_WRAPPERS}

    def wrap(name, fn):
        def call(*args, **kwargs):
            with lock:
                seen[name] = rank = seen[name] + 1
                shape = _call_shape(args) if every_shape else None
                new_shape = every_shape and shape not in shapes[name]
                shapes[name].add(shape)
            if rank in Q_HELD_CALLS.get(name, Q_HELD_DEFAULT) or new_shape:
                calls.append((name, _copy_tree(args), _copy_tree(kwargs)))
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


def hold_served_calls(report, phase, calls) -> set:
    """Each captured call again on two copies of its inputs, through the
    kernel and through its plain version, held at phase A's tolerances: the
    logit deltas 1e-5, the AR(1) delta 1e-4 of max |l|, the draw exactly
    (outputs and its buffer), the particle sweep with at most 1% of paths
    apart, the Gibbs sweep's picks equal or parting where a uniform lies
    within 1e-5 of a CDF boundary (counts exact, sums 1e-5), the round op as
    ``compare_round``. Returns the kernels held."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.gibbs_z import first_divergence, gibbs_z_sweep_ref, sums_drift
    from repro_torch.inference.niw import ClusterStats

    held = set()
    for name, args, kwargs in calls:
        kern = SERVED_WRAPPERS[name]
        ka, kk, pa, pk = (_copy_tree(a) for a in (args, kwargs, args, kwargs))
        kk["mode"], pk["mode"] = "always", "never"
        if name == "gibbs_z_sweep":
            ops.gibbs_z_sweep(*ka, **kk)
            pk.pop("mode")
            cdf, mass = gibbs_z_sweep_ref(*pa, **pk, record=True)
        else:
            got, want = getattr(ops, name)(*ka, **kk), getattr(ops, name)(*pa, **pk)
        torch.cuda.synchronize()
        label = f"{phase} served {name}{_call_shape(args)}"
        if kern in ("logit_delta", "batched_logit_delta"):
            err = float((got - want).abs().max())
            check(err <= 1e-5, f"{label}: within 1e-5 of its plain version ({err:.2e})")
        elif kern == "gaussian_ar1_delta":
            err = float((got - want).abs().max())
            check(err <= 1e-4 * max(1.0, float(want.abs().max())),
                  f"{label}: within 1e-4 (relative to max |l|) of its plain version ({err:.2e})")
        elif kern == "fy_draw":
            pairs = list(zip(got, want)) + [(a, b) for a, b in zip(ka, pa)
                                             if isinstance(a, torch.Tensor)]
            err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                      for a, b in pairs)
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"{label}: indices, valid flags, positions and buffer identical")
        elif kern == "pgibbs_sweep":
            frac = 1.0 - float((got == want).all(-1).float().mean())
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and frac <= 0.01,
                  f"{label}: finite, {frac:.3e} of the paths apart (at most 1%)")
        elif kern == "gibbs_z_sweep":
            x, z_k, w_k, s_k, points, u = ka[0], ka[2], ka[3], ka[5], ka[6], ka[8]
            z_p, w_p, s_p = pa[2], pa[3], pa[5]
            apart = first_divergence(points, u, z_k, z_p, cdf, mass)
            check(all(b for _, _, b in apart), f"{label}: picks equal the plain version's, or "
                  "part first where the uniform lies within 1e-5 of a CDF boundary "
                  f"({[(r, t) for r, t, _ in apart]})")
            k_max = w_k.shape[1]
            counts = torch.stack([torch.bincount(r.long(), minlength=k_max) for r in z_k]).float()
            drift = sums_drift(s_k, ClusterStats.from_assignments(x, z_k, k_max))
            check(torch.equal(s_k.n, counts) and drift <= 1e-5,
                  f"{label}: counts equal z's histogram; sums within 1e-5 ({drift:.2e})")
            same = [r for r in range(z_k.shape[0]) if r not in {a for a, _, _ in apart}]
            err = max([0.0] + [float((a[same] - b[same]).abs().max())
                               for a, b in zip((*s_k, w_k), (*s_p, w_p))])
        else:  # t_test_round: count, mean, m2, mu0, eps, rounds, done, decision, pval
            pick = lambda a: [a[i] for i in (2, 3, 4, 5, 6, 9, 10, 11, 12)]
            errs, _ = compare_round(pick(ka), pick(pa), label)
            err = max(errs.values())
        e = report["kernels"][kern]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["cases"].append({"case": label, "max_abs_err": err, "served": True})
        held.add(kern)
    print(f"  phase {phase}: {len(calls)} served calls held against their plain versions "
          f"({sorted(held)})")
    check(set({**Q_NEEDS, **R_NEEDS, **O_NEEDS}[phase]) <= held,
          f"phase {phase}: every kernel it launches was held at its served shapes")
    return held


def serve_args(workload: str, *extra: str):
    """The front end's arguments at its non-smoke defaults: K=8, refresh 64,
    window 128, min_draws 512, 8 rows a request, max_batch 16, 250 ms."""
    from repro_torch.launch import serve

    return serve.build_parser().parse_args(["--workload", workload, "--seed", "0", *extra])


def serve_phase(report, phase, workload, *extra, hold=True):
    """``serve_posterior`` in-process as one counted phase; its parity check
    (float64 offline from the same draws) fails the phase. With ``hold``,
    kernel calls of the phase are captured and held against their plain
    versions after it (``hold_served_calls``)."""
    from repro_torch.launch import serve

    out = {}
    with capture_served_calls() if hold else contextlib.nullcontext([]) as calls:
        rc = counted(report, phase,
                     lambda: serve.serve_posterior(serve_args(workload, *extra), out))
    check(rc == 0 and "report" in out, f"phase {phase}: serve_posterior returned 0 ({rc})")
    classes = {cls: {k: e[k] for k in ("count", "p50_ms", "p95_ms", "p99_ms", "deadline_hit_rate",
                                       "mean_batch_size", "staleness_mean_s")}
               for cls, e in out["report"]["classes"].items()}
    r = {k: out[k] for k in ("warm_s", "served", "wall_s", "req_per_s", "parity_max_abs",
                             "steps_during_serve")}
    r.update(classes=classes, errors=out["report"]["errors"],
             snapshot_staleness_s=out["snapshot"]["staleness_s"])
    report["phases"][phase].update(r)
    print(f"  phase {phase}: warm {r['warm_s']:.3f}s, {r['served']} requests at "
          f"{r['req_per_s']:.1f}/s, parity max|delta| {r['parity_max_abs']}; per class "
          + "; ".join(f"{c} p50/p95/p99 {e['p50_ms']:.3f}/{e['p95_ms']:.3f}/{e['p99_ms']:.3f} ms "
                      f"deadline_hit {e['deadline_hit_rate']} staleness {e['staleness_mean_s']}"
                      for c, e in classes.items()))
    check(r["errors"] == 0 and r["parity_max_abs"] is not None,
          f"phase {phase}: {workload} served {r['served']} requests, none failed, parity held")
    if hold:
        hold_served_calls(report, phase, calls)
    return out


def paced_queries(pool, done, ticks=None, tick_s=Q_BG_TICK_S) -> dict:
    """Beside the pool's background refresh (started here, stopped at the
    end), submit 8 BayesLR requests every ``tick_s`` and serve them at
    once, until ``done(commits, elapsed_s)``: the queue, the commits seen
    ((time, steps_done) at each), the requests submitted, the wall seconds
    and their span on the wall clock, and the CPU seconds of the query
    (calling) and refresh threads. A list ``ticks`` receives each tick's
    (start, end) before its sleep."""
    import torch

    from repro_torch.serving import RequestQueue

    resident, wl = pool.resident("bayeslr"), pool.workload("bayeslr")
    queue = RequestQueue(pool)
    gen = torch.Generator().manual_seed(7)
    classes = sorted(wl.query_specs)
    commits = []
    pool.start()
    refresh_clock = time.pthread_getcpuclockid(resident._thread.ident)
    cpu0 = (time.thread_time(), time.clock_gettime(refresh_clock))
    steps0, t0, i = resident.steps_done, time.perf_counter(), 0
    while not done(commits, time.perf_counter() - t0):
        tick = time.perf_counter()
        for _ in range(8):
            cls = classes[i % len(classes)]
            queue.submit("bayeslr", cls, wl.query_specs[cls].make_queries(gen, 8))
            i += 1
        queue.drain()
        if ticks is not None:
            ticks.append((tick, time.perf_counter()))
        steps = resident.steps_done
        if steps != (commits[-1][1] if commits else steps0):
            commits.append((time.perf_counter(), steps))
        time.sleep(max(0.0, t0 + (i // 8) * tick_s - time.perf_counter()))
    wall = time.perf_counter() - t0
    cpu = (time.thread_time() - cpu0[0], time.clock_gettime(refresh_clock) - cpu0[1])
    pool.stop()
    return {"queue": queue, "commits": commits, "steps0": steps0, "submitted": i, "wall": wall,
            "window": (t0, t0 + wall), "query_cpu_s": cpu[0], "refresh_cpu_s": cpu[1]}


def refresh_rate(pool, run) -> float:
    """Transitions/s summed over the chains of a ``paced_queries`` run:
    from the first commit seen to the last, or, with one commit, its steps
    over the whole window."""
    k, commits = pool.config.num_chains, run["commits"]
    if len(commits) >= 2:
        (ta, sa), (tb, sb) = commits[0], commits[-1]
        return k * (sb - sa) / (tb - ta)
    return k * ((commits[0][1] if commits else run["steps0"]) - run["steps0"]) / run["wall"]


def refresh_alone(pool, times: int = 3) -> float:
    """Transitions/s summed over the chains of ``times`` refreshes in a row."""
    import torch

    resident = pool.resident("bayeslr")
    t0 = time.perf_counter()
    for _ in range(times):
        resident.refresh()
    torch.cuda.synchronize()
    return times * pool.config.num_chains * pool.config.refresh_steps / (
        time.perf_counter() - t0)


def phase_q_bg(pool):
    """The Q pool's refresh alone, then a background refresh beside a paced
    query load (8 requests every ``Q_BG_TICK_S``, served at once) until
    ``Q_BG_COMMITS`` refreshes commit: transitions/s of each (the second
    timed from the first commit seen to the last), and the latency of the
    queries served meanwhile. The load offered (1 600 requests/s) is more
    than one host thread serves beside the refresh: the query thread's CPU
    share says how busy it was."""
    k = pool.config.num_chains
    alone = refresh_alone(pool)
    run = paced_queries(pool, lambda commits, elapsed: len(commits) >= Q_BG_COMMITS
                        or elapsed >= Q_BG_MAX_S)
    rep, commits, i, wall = run["queue"].slo_report(), run["commits"], run["submitted"], run["wall"]
    check(len(commits) >= 1 and rep["errors"] == 0,
          f"phase Q-bg: the background refresh committed {len(commits)} times while {i} queries "
          "were served, none failed")
    beside = {"transitions_per_s_refresh_alone": alone,
              "transitions_per_s_beside_queries": refresh_rate(pool, run),
              "refreshes_beside_queries": len(commits), "queries_beside_refresh": i,
              "req_per_s_beside_refresh": i / wall,
              "query_thread_cpu_share": run["query_cpu_s"] / wall,
              "refresh_thread_cpu_share": run["refresh_cpu_s"] / wall,
              "classes_beside_refresh": {c: {q: e[q] for q in ("p50_ms", "p95_ms", "p99_ms",
                                                               "deadline_hit_rate")}
                                         for c, e in rep["classes"].items()}}
    print(f"  phase Q-bg: refresh alone {alone:.1f} transitions/s summed over {k} chains; beside "
          f"{i} queries in {wall:.2f}s ({i / wall:.1f} req/s): "
          f"{beside['transitions_per_s_beside_queries']:.1f} transitions/s over "
          f"{len(commits)} commits; CPU share of the query thread "
          f"{beside['query_thread_cpu_share']:.3f}, of the refresh thread "
          f"{beside['refresh_thread_cpu_share']:.3f}; query latency "
          f"{beside['classes_beside_refresh']}")
    return beside


def phase_q_resume(report):
    """Resumption on the card, bit for bit: refreshes of 64, 32 and 16 steps
    equal one offline run of 112 (window and theta) on a CUDA generator
    seeded alike; then ``pool.save`` -> a fresh pool's ``restore`` -> 16
    more steps on each equal each other."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.serving import EnsemblePool, FreshnessPolicy, ServingConfig

    def make_pool():
        cfg = ServingConfig(num_chains=8, refresh_steps=64, window=128, seed=3,
                            freshness=FreshnessPolicy(min_draws=512))
        pool = EnsemblePool(cfg)
        pool.add_workload("bayeslr")
        return pool

    def run():
        pool = make_pool()
        res, wl = pool.resident("bayeslr"), pool.workload("bayeslr")
        for n in Q_RESUME_STEPS:
            res.refresh(n)
        gen = torch.Generator(device="cuda").manual_seed(3)
        state, samples, _ = wl.ensemble.run(gen, wl.ensemble.init(wl.theta0),
                                            sum(Q_RESUME_STEPS))
        chunked = (np.array_equal(res.snapshot().draws, samples.cpu().numpy())
                   and torch.equal(res.state.theta, state.theta)
                   and torch.equal(res._gen_state, gen.get_state()))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
            pool.save(tmp)
            other = make_pool()
            other.restore(tmp)
        a, b = res, other.resident("bayeslr")
        a.refresh(16)
        b.refresh(16)
        restored = (a._gen_state.numel() == 16 and torch.equal(a.state.theta, b.state.theta)
                    and np.array_equal(a.snapshot().draws, b.snapshot().draws))
        return chunked, restored

    chunked, restored = counted(report, "Q-resume", run)
    report["phases"]["Q-resume"].update(chunked_equals_one_shot=chunked,
                                        restored_equals_original=restored)
    check(chunked, f"phase Q-resume: refreshes of {Q_RESUME_STEPS} equal one offline run of "
          f"{sum(Q_RESUME_STEPS)} steps bit for bit (window, theta, generator state)")
    check(restored, "phase Q-resume: save -> restore -> 16 steps equals 16 more steps of the "
          "saved pool bit for bit (16-byte CUDA generator state)")


def phase_q(report):
    """Posterior serving through the front end: BayesLR at the reference
    front end's non-smoke defaults (Q), the same with a background refresh
    (Q-bg), resumption (Q-resume), then stochvol, the joint DP mixture and
    a compiled program at their non-smoke sizes, 400 requests each; the
    kernel calls of Q, Q-sv, Q-jdpm and Q-ppl held against plain."""
    print(f"phase Q: posterior serving (repro_torch.launch.serve), bayeslr at N=12000 D=20 "
          f"batch 500, K=8 refresh 64 window 128 min_draws 512, {Q_QUERIES} requests of 8 rows, "
          "max_batch 16, deadline 250 ms")
    secs = {}
    t0 = time.perf_counter()
    serve_phase(report, "Q", "bayeslr", "--queries", str(Q_QUERIES))
    secs["Q"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = serve_phase(report, "Q-bg", "bayeslr", "--queries", str(Q_QUERIES), "--background",
                      hold=False)
    report["phases"]["Q-bg"].update(phase_q_bg(out["pool"]))
    del out
    secs["Q-bg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_q_resume(report)
    secs["Q-resume"] = time.perf_counter() - t0
    for phase, workload in (("Q-sv", "stochvol"), ("Q-jdpm", "jointdpm"), ("Q-ppl", "ppl")):
        t0 = time.perf_counter()
        serve_phase(report, phase, workload, "--queries", str(Q_QUERIES))
        secs[phase] = time.perf_counter() - t0
    report["q_seconds"] = secs
    print("  seconds taken by phase Q: " + "; ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; total {sum(secs.values()):.1f}")


# ---------------------------------------------------------------------------
# Phase R: the serving fleet (repro_torch.fleet, repro_torch.partition)
# ---------------------------------------------------------------------------

R_QUERIES = 400  # as Q: the front end's non-smoke default
# the paced window of R-bg and R-proc ends at 10 commits of the writer (9
# refresh intervals), or at 20 s; the refresh alone is timed over 5
# refreshes before the window, after it, and after the replicas closed
R_BG_COMMITS, R_BG_MAX_S, R_ALONE_REFRESHES = 10, 20.0, 5
# the conjugate harness of the reference's tests (tests/conftest.py:79):
# n, D, K, burn, kept, and the partition counts
R_TRUTH_N, R_TRUTH_D, R_TRUTH_K, R_TRUTH_BURN, R_TRUTH_KEEP = 768, 2, 4, 250, 350
R_TRUTH_P = (1, 2, 4)
# the kernels each R cell must launch
R_NEEDS = {"R": ("batched_logit_delta", "t_test_round"),
           "R-sub": ("batched_logit_delta", "t_test_round"),
           "R-truth": ("t_test_round",),
           "R-bg": ("batched_logit_delta", "t_test_round"),
           "R-proc": ("batched_logit_delta", "t_test_round")}


def fleet_phase(report, phase, *extra, every_shape=False):
    """``serve_fleet`` in-process as one counted phase (BayesLR at the front
    end's non-smoke defaults, 400 requests); its parity check (a replica's
    answer against its writer's, bit for bit) fails the phase. Its kernel
    calls are captured (``every_shape``: also the first at each shape) and
    held against plain after it."""
    from repro_torch.launch import serve

    out = {}
    with capture_served_calls(every_shape) as calls:
        rc = counted(report, phase, lambda: serve.serve_fleet(
            serve_args("bayeslr", "--queries", str(R_QUERIES), *extra), out))
    check(rc == 0 and "report" in out,
          f"phase {phase}: serve_fleet returned 0 ({rc}): replica == writer bit for bit")
    rep = out["report"]
    classes = {cls: {k: e.get(k) for k in ("count", "p50_ms", "p95_ms", "p99_ms",
                                           "deadline_hit_rate", "admitted", "shed",
                                           "staleness_mean_s")}
               for cls, e in rep["classes"].items()}
    r = {k: out[k] for k in ("warm_s", "served", "wall_s", "req_per_s", "parity_max_abs",
                             "delta_ratio", "steps_during_serve")}
    r.update(classes=classes, errors=rep["errors"], shed=rep["shed"], sync=out["sync"])
    report["phases"][phase].update(r)
    print(f"  phase {phase}: warm {r['warm_s']:.3f}s, {r['served']} requests at "
          f"{r['req_per_s']:.1f}/s, shed {r['shed']}, {out['sync']['syncs']} syncs at "
          f"delta/full {r['delta_ratio']:.4f}; per class "
          + "; ".join(f"{c} p50/p95/p99 {e['p50_ms']:.3f}/{e['p95_ms']:.3f}/{e['p99_ms']:.3f} ms "
                      f"deadline_hit {e['deadline_hit_rate']}" for c, e in classes.items()))
    check(r["errors"] == 0 and r["shed"] == 0 and r["served"] == R_QUERIES,
          f"phase {phase}: all {R_QUERIES} requests answered, none failed or shed")
    out["held"] = [_call_shape(args) for _, args, _ in calls]
    hold_served_calls(report, phase, calls)
    return out


def phase_r_sub(report):
    """R-sub: ``--subposterior 4 --combine consensus --stream``. Every
    request is answered from the router's combined window, the stream's
    rows reach every writer, and the combined window equals
    ``combine_snapshots`` of the four writers' snapshots; one served
    combined batch is held to float64 numpy on the same combined draws."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.partition import combine_snapshots

    out = fleet_phase(report, "R-sub", "--subposterior", "4", "--combine", "consensus",
                      "--stream", every_shape=True)
    fleet, router, st = out["fleet"], out["router"], out["stream"]
    shards = fleet.shards("bayeslr")
    combined = router.combined_served("bayeslr")
    check(combined["rows"] == R_QUERIES * 8,
          f"phase R-sub: every request answered from the combined window ({combined['rows']} "
          f"rows in {combined['batches']} combined batches, {R_QUERIES * 8} expected)")
    grown = [h for h in out["held"] if any(f"{n}x20" in h or f",{n}," in h
                                           for n in st["sections_after"])]
    check(len(grown) >= 2,
          f"phase R-sub: kernel calls on the grown pools were held against plain ({grown})")
    check(st["appended"] == 750 and st["stale_after_append"] == st["writers"] == 4
          and all(b < a for b, a in zip(st["steps_before_pump"], st["steps_after_pump"]))
          and sum(st["sections_after"]) - sum(st["sections_before"]) == 750,
          f"phase R-sub: STREAM_OK, 750 rows into {st['writers']} writers "
          f"({st['sections_before']} -> {st['sections_after']} sections), each marked stale "
          "by the append and refreshed")
    snaps = [s.writer.snapshot() for s in shards]
    served = router.combined_snapshot("bayeslr")
    t0 = time.perf_counter()
    again = combine_snapshots(snaps, "consensus")
    combine_ms = 1e3 * (time.perf_counter() - t0)
    check(served.steps_done == again.steps_done
          and np.array_equal(served.draws, again.draws) and served.draws.dtype == np.float32,
          "phase R-sub: the router's combined window equals combine_snapshots of the four "
          f"writers' snapshots (version {served.steps_done}, float32 draws; recomputed in "
          f"{combine_ms:.2f} ms on the host)")
    wl = fleet.workload("bayeslr")
    spec = wl.query_specs["predictive"]
    xs = spec.make_queries(torch.Generator().manual_seed(11), 16)
    req = router.submit("bayeslr", "predictive", xs)
    router.drain()
    ref = serve._offline_reference(wl, spec, served, xs)
    err = float(np.max(np.abs(req.values - ref)))
    report["phases"]["R-sub"].update(
        stream=st, combined_rows=combined["rows"], combined_batches=combined["batches"],
        combined_version=served.steps_done, combined_parity_max_abs=err, combine_ms=combine_ms,
        partition_sections=[s.writer.ensemble.target.num_sections for s in shards])
    check(req.error is None and np.allclose(req.values, ref, **serve.PARITY_TOL),
          f"phase R-sub: a served combined batch equals float64 numpy on the same combined "
          f"draws (max|delta| {err:.2e}; rtol 1e-4, atol 1e-5)")


def phase_r_truth(report):
    """R-truth: the reference's conjugate ground-truth harness on the card
    (prior N(0, I), x_i ~ N(theta, I), n = 768, D = 2, K = 4, 250 burn and
    350 kept a partition), P = 1, 2, 4, both rules, at the reference's bars:
    the combined mean within 0.5 posterior std of ``n xbar / (n+1)``, the
    variance ratio in [0.45, 2.2]."""
    import numpy as np
    import torch

    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig, build_target
    from repro_torch.partition import combine_draws, partition_target

    n, d = R_TRUTH_N, R_TRUTH_D
    rng = np.random.default_rng(3)
    x = (np.array([0.6, -0.3]) + rng.normal(size=(n, d))).astype(np.float32)
    target = build_target("gaussian_mean", torch.from_numpy(x).cuda(), n,
                          prior_logpdf=lambda th: -0.5 * (th ** 2).sum(-1))
    post_mean = n * x.astype(np.float64).mean(0) / (n + 1.0)
    post_var = 1.0 / (n + 1.0)

    def run():
        out = {}
        for num_p in R_TRUTH_P:
            t0, draws = time.perf_counter(), []
            for p, t in enumerate(partition_target(target, num_p)):
                cfg = SubsampledMHConfig(batch_size=min(128, t.num_sections), epsilon=0.005,
                                         sampler="stream")
                ens = ChainEnsemble(t, RandomWalk(1.7 * math.sqrt(num_p / (n + 1.0))),
                                    R_TRUTH_K, config=cfg)
                gen = torch.Generator(device="cuda").manual_seed(4 + 97 * num_p + p)
                state, _, _ = ens.run(gen, ens.init(torch.zeros(d)), R_TRUTH_BURN)
                _, samples, _ = ens.run(gen, state, R_TRUTH_KEEP)
                draws.append(samples.cpu().numpy())
            out[num_p] = (draws, time.perf_counter() - t0)
        return out

    runs = counted(report, "R-truth", run)
    cells = {}
    for num_p, (draws, secs) in runs.items():
        for method in ("consensus", "product"):
            comb = np.asarray(combine_draws(draws, method, seed=17), np.float64).reshape(-1, d)
            err = float(np.max(np.abs(comb.mean(0) - post_mean)) / math.sqrt(post_var))
            ratio = comb.var(axis=0, ddof=1) / post_var
            cells[f"P={num_p} {method}"] = {"mean_err_post_std": err,
                                            "var_ratio": ratio.tolist(), "chains_s": secs}
            check(err < 0.5 and bool(np.all((ratio > 0.45) & (ratio < 2.2))),
                  f"phase R-truth: P={num_p} {method}: combined mean {err:.3f} posterior std "
                  f"off (< 0.5), variance ratio {np.round(ratio, 3).tolist()} in [0.45, 2.2]")
    report["phases"]["R-truth"]["cells"] = cells


def fleet_paced(fleet, router, done, tick_s=Q_BG_TICK_S) -> dict:
    """Beside the fleet's background refresh and the router's lane workers
    (both started here, stopped at the end), submit 8 BayesLR requests every
    ``tick_s`` and wait for them, until ``done(commits, elapsed_s)``: the
    commits of the first writer seen ((time, steps_done, round-op launches
    so far) at each), the
    requests, the wall seconds, and the CPU share of the window taken by the
    refresh thread, the lane threads (summed) and the submitting thread
    (thread CPU clocks, read over the whole window)."""
    import torch

    from repro_torch.kernels import ops

    wl = fleet.workload("bayeslr")
    writer = fleet.shards("bayeslr")[0].writer
    gen = torch.Generator().manual_seed(7)
    classes = sorted(wl.query_specs)
    commits, reqs = [], []
    fleet.start()
    router.start_workers()
    # the fleet names its refresh threads fleet-<shard>, the router its lane
    # workers route-<replica>
    clocks = {k: [time.pthread_getcpuclockid(t.ident) for t in threading.enumerate()
                  if t.name.startswith(prefix)]
              for k, prefix in (("refresh", "fleet-"), ("lanes", "route-"))}
    cpu0 = {k: [time.clock_gettime(c) for c in v] for k, v in clocks.items()}
    main0 = time.thread_time()
    steps0, t0, i = writer.steps_done, time.perf_counter(), 0
    while not done(commits, time.perf_counter() - t0):
        tick = []
        for _ in range(8):
            cls = classes[i % len(classes)]
            tick.append(router.submit("bayeslr", cls, wl.query_specs[cls].make_queries(gen, 8)))
            i += 1
        for req in tick:
            req.done.wait(timeout=30.0)
        reqs.extend(tick)
        steps = writer.steps_done
        if steps != (commits[-1][1] if commits else steps0):
            commits.append((time.perf_counter(), steps, ops.launches["t_test_round"]))
        time.sleep(max(0.0, t0 + (i // 8) * tick_s - time.perf_counter()))
    wall = time.perf_counter() - t0
    cpu = {k: sum(time.clock_gettime(c) - c0 for c, c0 in zip(v, cpu0[k]))
           for k, v in clocks.items()}
    cpu["submitting"] = time.thread_time() - main0
    router.stop_workers()
    fleet.stop()
    return {"commits": commits, "steps0": steps0, "requests": reqs, "wall": wall,
            "cpu_share": {k: v / wall for k, v in cpu.items()}}


def writer_alone(writer, k, n) -> tuple[list[float], list[float]]:
    """Transitions/s summed over ``k`` chains, and sequential-test rounds/s
    (round-op launches), of each of ``R_ALONE_REFRESHES`` refreshes of
    ``n`` steps in a row."""
    import torch

    from repro_torch.kernels import ops

    rates, rounds = [], []
    for _ in range(R_ALONE_REFRESHES):
        r0, t0 = ops.launches["t_test_round"], time.perf_counter()
        writer.refresh()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rates.append(k * n / secs)
        rounds.append((ops.launches["t_test_round"] - r0) / secs)
    return rates, rounds


def spread(rates) -> dict:
    return {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
            "n": len(rates)}


def phase_r_bg(report, phase, transport):
    """R-bg / R-proc: the front end's fleet (``--background
    --replica-transport inproc|proc``, built by its own ``_build_fleet``,
    ``_build_router`` and ``_compile_lanes``). The first writer's refresh
    alone (replicas up and idle), then the fleet's background refresh
    beside the router's lane workers under 8 requests every
    ``Q_BG_TICK_S``, until ``R_BG_COMMITS`` commits (or ``R_BG_MAX_S``),
    then the refresh alone again with the replicas up and once more after
    every replica closed (for ``proc``, its process exited and its CUDA
    context went). Requests/s, p99 a class,
    the writer's transitions/s beside queries over the window and over each
    interval between two commits, against its rate alone; for ``proc``,
    each replica process's start seconds and device memory."""
    import torch

    from repro_torch.launch import serve

    args = serve_args("bayeslr", "--queries", str(R_QUERIES), "--background",
                      "--replica-transport", transport)

    def run():
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        fleet, wl, _ = serve._build_fleet(args)
        build_s = time.perf_counter() - t0
        free1 = torch.cuda.mem_get_info()[0]
        try:
            fleet.warm()
            router = serve._build_router(args, fleet, wl)
            serve._compile_lanes(args, fleet, wl, router)
            shard = fleet.shards("bayeslr")[0]
            k, n = fleet.config.serving.num_chains, fleet.config.serving.refresh_steps
            alone_up, rounds_up = writer_alone(shard.writer, k, n)
            paced = fleet_paced(fleet, router,
                                lambda c, e: len(c) >= R_BG_COMMITS or e >= R_BG_MAX_S)
            fleet.sync_all()
            alone_after, rounds_after = writer_alone(shard.writer, k, n)
            replicas = [r.stats() for r in shard.replicas]
            for r in shard.replicas:
                r.close()
            free2 = torch.cuda.mem_get_info()[0]
            alone_closed, rounds_closed = writer_alone(shard.writer, k, n)
            return (alone_up, rounds_up, alone_after, rounds_after, alone_closed, rounds_closed,
                    paced, router.slo_report(), replicas, build_s, free0 - free1,
                    free2 - free1, k)
        finally:
            fleet.close()

    (alone_up, rounds_up, alone_after, rounds_after, alone_closed, rounds_closed, paced, rep,
     replicas, build_s, mem_drop, mem_back, k) = counted(report, phase, run)
    commits, wall = paced["commits"], paced["wall"]
    (ta, sa, ra), (tb, sb, rb) = commits[0], commits[-1]
    beside, rounds_beside = k * (sb - sa) / (tb - ta), (rb - ra) / (tb - ta)
    intervals = [k * (s1 - s0) / (t1 - t0)
                 for (t0, s0, _), (t1, s1, _) in zip(commits, commits[1:])]
    alone, alone_rounds = statistics.median(alone_up), statistics.median(rounds_up)
    reqs = paced["requests"]
    bad = [r for r in reqs if r.error is not None or not r.done.is_set()]
    r = {"transitions_per_s_refresh_alone": alone,
         "alone_replicas_up": spread(alone_up), "alone_after_window": spread(alone_after),
         "alone_replicas_closed": spread(alone_closed),
         "transitions_per_s_beside_queries": beside, "beside_intervals": spread(intervals),
         "beside_over_alone": beside / alone,
         "beside_over_alone_closed": beside / statistics.median(alone_closed),
         "rounds_per_s_alone_replicas_up": spread(rounds_up),
         "rounds_per_s_alone_after_window": spread(rounds_after),
         "rounds_per_s_alone_replicas_closed": spread(rounds_closed),
         "rounds_per_s_beside_queries": rounds_beside,
         "rounds_beside_over_alone": rounds_beside / alone_rounds,
         "commits_beside_queries": len(commits),
         "requests": len(reqs), "req_per_s": len(reqs) / wall, "wall_s": wall,
         "fleet_build_s": build_s, "device_bytes_taken_by_build": mem_drop,
         "device_bytes_freed_by_closing_replicas": mem_back,
         "cpu_share": paced["cpu_share"],
         "classes": {c: {q: e.get(q) for q in ("p50_ms", "p95_ms", "p99_ms",
                                              "deadline_hit_rate")}
                     for c, e in rep["classes"].items()},
         "replicas": [{q: st.get(q) for q in ("name", "start_s", "device_bytes_allocated",
                                              "device_bytes_reserved", "deltas_applied",
                                              "bytes_received")} for st in replicas]}
    report["phases"][phase].update(r)
    sp = lambda d: f"{d['median']:.1f} [{d['min']:.1f}, {d['max']:.1f}]"  # noqa: E731
    print(f"  phase {phase}: refresh alone, median [min, max] of {R_ALONE_REFRESHES} refreshes: "
          f"{sp(r['alone_replicas_up'])} transitions/s with the replicas up, "
          f"{sp(r['alone_after_window'])} after the window, "
          f"{sp(r['alone_replicas_closed'])} after they closed; beside {len(reqs)} requests in "
          f"{wall:.2f}s ({r['req_per_s']:.1f}/s) {beside:.1f} over {len(commits)} commits "
          f"({beside / alone:.3f}x), each interval {sp(r['beside_intervals'])}; round ops/s alone "
          f"{sp(r['rounds_per_s_alone_replicas_up'])} up, "
          f"{sp(r['rounds_per_s_alone_after_window'])} after, "
          f"{sp(r['rounds_per_s_alone_replicas_closed'])} closed, beside {rounds_beside:.1f} "
          f"({rounds_beside / alone_rounds:.3f}x); per class "
          + "; ".join(f"{c} p50/p99 {e['p50_ms']:.3f}/{e['p99_ms']:.3f} ms"
                      for c, e in r["classes"].items())
          + "; CPU share " + ", ".join(f"{k} {v:.3f}" for k, v in r["cpu_share"].items())
          + f"; fleet built in {build_s:.2f}s, device memory taken {mem_drop / 2 ** 20:.0f} MiB, "
          f"given back by closing the replicas {mem_back / 2 ** 20:.0f} MiB; "
          f"replicas {r['replicas']}")
    check(not bad and len(commits) >= 2,
          f"phase {phase}: {len(reqs)} requests answered beside {len(commits)} commits of the "
          "background refresh, none failed")
    if transport == "proc":
        check(all((st.get("start_s") or 0) > 0 and (st.get("device_bytes_allocated") or 0) > 0
                  for st in replicas),
              f"phase {phase}: each replica process started and holds its data on the card")


def phase_r(report):
    """The serving fleet through the front end: R (``--fleet --replicas
    2``), R-sub (``--subposterior 4 --combine consensus --stream``), R-truth
    (the conjugate harness on the card), R-bg and R-proc (the background
    refresh beside queries with replicas in this process, then each in its
    own)."""
    print(f"phase R: the serving fleet (repro_torch.launch.serve.serve_fleet), bayeslr at "
          f"N=12000 D=20 batch 500, K=8 refresh 64 window 128 min_draws 512, {R_QUERIES} "
          "requests of 8 rows, max_batch 16, deadline 250 ms")
    secs = {}
    t0 = time.perf_counter()
    fleet_phase(report, "R", "--fleet", "--replicas", "2")
    secs["R"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_r_sub(report)
    secs["R-sub"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_r_truth(report)
    secs["R-truth"] = time.perf_counter() - t0
    for phase, transport in (("R-bg", "inproc"), ("R-proc", "proc")):
        t0 = time.perf_counter()
        phase_r_bg(report, phase, transport)
        secs[phase] = time.perf_counter() - t0
    bg, proc = report["phases"]["R-bg"], report["phases"]["R-proc"]
    report["phases"]["R-proc"]["proc_over_inproc_beside"] = ratio = (
        proc["transitions_per_s_beside_queries"] / bg["transitions_per_s_beside_queries"])
    over = lambda key: proc[key] / bg[key]  # noqa: E731
    print(f"  R-proc over R-bg: the refresh beside queries {ratio:.3f}x; alone with the "
          f"replicas up {over('transitions_per_s_refresh_alone'):.3f}x; round ops/s beside "
          f"{over('rounds_per_s_beside_queries'):.3f}x")
    report["r_seconds"] = secs
    print("  seconds taken by phase R: " + "; ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; total {sum(secs.values()):.1f}")


# ---------------------------------------------------------------------------
# Phase O: observability and the closed loop (repro_torch.obs, fleet/autoscale)
# ---------------------------------------------------------------------------

O_QUERIES = 400  # as Q
O_PROC_SOAK_S = 8.0  # O-kill-proc's soak, the reference's tests/test_chaos.py setting
# the refresh alone with no stats server, with one up and idle, and with one
# polled every O_POLL_S by a client thread: O_STATS_ROUNDS rounds of the three,
# O_STATS_REFRESHES refreshes a block
O_STATS_ROUNDS, O_STATS_REFRESHES, O_POLL_S = 2, 2, 0.01
# the kernels each O cell must launch (BayesLR serving runs the stream
# sampler: no Fisher-Yates draw)
O_NEEDS = {"O": ("batched_logit_delta", "t_test_round"),
           "O-soak": ("batched_logit_delta", "t_test_round"),
           "O-kill-proc": ("batched_logit_delta", "t_test_round")}
O_STREAMS = ("slo", "snapshot", "transition_cost", "adaptation", "spans")


class _Tee:
    """A stdout that also keeps every line written (the self-check lines a
    serve run prints)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def lines(self) -> list[str]:
        return "".join(self.text).splitlines()


@contextlib.contextmanager
def tee_stdout():
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee


def line_fields(lines, head) -> dict:
    """``key=value`` fields of the last printed line starting with
    ``head``; fails the phase when there is none."""
    found = [ln for ln in lines if ln.startswith(head)]
    check(bool(found), f"the run printed a {head} line")
    return dict(f.split("=", 1) for f in found[-1].split() if "=" in f)


@contextlib.contextmanager
def obs_timers():
    """While open, the obs layer's per-tick work is timed on the host
    clock, call by call, summed by part: the SLO sample (the queue's report
    over every completed request), the snapshot record (R-hat and ESS of the
    window), the transition cost record, the alert rules' evaluation (a
    rollup) and the tracer's span records. Yields the dict of
    ``{part: [calls, seconds]}``."""
    import repro_torch.obs as obs
    from repro_torch.obs import alerts, sources, trace

    parts = {}
    targets = [("slo_sample", sources.SLOSampler, "sample"),
               ("snapshot_record", obs, "record_snapshot"),
               ("transition_cost_record", obs, "record_transition_cost"),
               ("alert_evaluate", alerts.AlertEngine, "evaluate"),
               ("span_record", trace.Tracer, "emit")]
    originals = [(owner, name, getattr(owner, name)) for _, owner, name in targets]

    def timed(part, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc = parts.setdefault(part, [0, 0.0])
                acc[0] += 1
                acc[1] += time.perf_counter() - t0
        return call

    for (part, owner, name), (_, _, fn) in zip(targets, originals):
        setattr(owner, name, timed(part, fn))
    try:
        yield parts
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def stats_thread_cost(pool) -> dict:
    """The O pool's refresh alone (transitions/s and round ops/s a refresh),
    with no stats server, with one up and idle beside it, and with one
    polled every ``O_POLL_S`` by a client thread (GET /, the rollup),
    ``O_STATS_ROUNDS`` rounds of the three in turn."""
    import urllib.request

    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import Recorder, SLOSampler, StatsServer, record_snapshot
    from repro_torch.serving import RequestQueue

    resident = pool.resident("bayeslr")
    k, n = pool.config.num_chains, pool.config.refresh_steps

    def block():
        rates, rounds = [], []
        for _ in range(O_STATS_REFRESHES):
            r0, t0 = ops.launches["t_test_round"], time.perf_counter()
            resident.refresh()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rates.append(k * n / secs)
            rounds.append((ops.launches["t_test_round"] - r0) / secs)
        return rates, rounds

    out = {c: {"transitions_per_s": [], "round_ops_per_s": []}
           for c in ("no_server", "server_idle", "server_polled")}
    gets = [0]
    for _ in range(O_STATS_ROUNDS):
        for cond in out:
            rec = server = stop = poller = None
            if cond != "no_server":
                rec = Recorder()
                SLOSampler(rec, RequestQueue(pool)).sample()
                record_snapshot(rec, "bayeslr", resident.snapshot())
                server = StatsServer(rec, "127.0.0.1:0")
            if cond == "server_polled":
                stop = threading.Event()

                def poll(url=server.url):
                    while not stop.is_set():
                        with urllib.request.urlopen(url, timeout=10) as resp:
                            resp.read()
                        gets[0] += 1
                        time.sleep(O_POLL_S)

                poller = threading.Thread(target=poll, name="stats-poller", daemon=True)
                poller.start()
            rates, rounds = block()
            out[cond]["transitions_per_s"] += rates
            out[cond]["round_ops_per_s"] += rounds
            if poller is not None:
                stop.set()
                poller.join(timeout=10)
            if server is not None:
                server.close()
                rec.close()
    res = {c: {m: spread(v) for m, v in d.items()} for c, d in out.items()}
    res["gets_served"] = gets[0]
    return res


def phase_o_obs(report):
    """O: ``serve_posterior`` with ``--stats-addr --obs-dir --alerts
    --trace-dir`` at Q's settings: the four self-check lines, parity, the
    streams and summary on disk, ``frac_data_touched`` equal to the final
    snapshot's ``mean_n_evaluated_overall`` / N (below 1), and the run
    rendered by ``repro_torch.obs.dash.main``."""
    import io
    import tempfile

    from repro_torch.obs import dash

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        obs_dir, trace_dir = os.path.join(tmp, "obs"), os.path.join(tmp, "trace")
        with tee_stdout() as tee, obs_timers() as parts:
            out = serve_phase(report, "O", "bayeslr", "--queries", str(O_QUERIES),
                              "--stats-addr", "127.0.0.1:0", "--obs-dir", obs_dir, "--alerts",
                              "--trace-dir", trace_dir)
        lines = tee.lines()
        for head in ("STATS_OK ", "ALERTS_OK ", "TRACE_OK ", "SERVE_OK "):
            check(any(ln.startswith(head) for ln in lines), f"phase O printed {head.strip()}")
        serve_ok = line_fields(lines, "SERVE_OK ")
        run_dir = out["obs_dir"]
        on_disk = sorted(os.listdir(run_dir))
        missing = [f for f in ["summary.json", *(f"{s}.jsonl" for s in O_STREAMS)]
                   if f not in on_disk]
        check(not missing, f"phase O: summary.json and the {O_STREAMS} streams on disk "
              f"(missing {missing})")
        with open(os.path.join(run_dir, "transition_cost.jsonl")) as f:
            cost = [json.loads(ln) for ln in f if ln.strip()]
        frac = cost[-1]["frac_data_touched"]
        want = out["obs_summary"]["mean_n_evaluated_overall"] / out["num_sections"]
        check(abs(frac - want) <= 1e-12 * max(1.0, want) and frac < 1.0,
              f"phase O: transition_cost.frac_data_touched {frac} equals the snapshot's "
              f"mean_n_evaluated_overall / N = {want} and is below 1")
        page = io.StringIO()
        rc = dash.main([run_dir], out=page)
        print(page.getvalue(), end="")
        check(rc == 0, f"phase O: repro_torch.obs.dash.main rendered {run_dir} ({rc})")
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
    # the obs parts' host seconds (the last sample's, past the serve's wall,
    # included): per request served, beside the serve's wall per request
    per_req = {k: {"calls": n, "ms_per_request": 1e3 * t / out["served"]}
               for k, (n, t) in parts.items()}
    print(f"  phase O: obs host work, ms per request served (calls): "
          + "; ".join(f"{k} {v['ms_per_request']:.4f} ({v['calls']})" for k, v in per_req.items())
          + f"; the serve's wall {1e3 * out['wall_s'] / out['served']:.4f} ms per request")
    report["phases"]["O"].update(
        obs_parts=per_req, streams_on_disk=on_disk, frac_data_touched=frac,
        stream_counts={k: v["count"] for k, v in summary["streams"].items()},
        alerts_fired=int(serve_ok.get("alerts_fired", -1)),
        parity=serve_ok.get("parity"))
    return out


def phase_o_soak(report):
    """O-soak: ``--fleet --soak --autoscale --alerts --stats-addr --obs-dir
    --replicas 2`` at Q's settings with the default 30 s soak, in-process
    replicas: ``SOAK_OK`` with a kill, a recovery, a full resync, bit-exact
    parity, at least one scale-up, one scale-down and one alert fired. The
    seconds from each ``add_replica`` to the new lane's first answer are
    timed by wrapping ``Fleet.add_replica`` here."""
    import tempfile

    from repro_torch.fleet import topology
    from repro_torch.launch import serve

    joins = []
    original = topology.Fleet.add_replica

    def add_replica(self, *a, **kw):
        entry = {"start": time.perf_counter()}
        joins.append(entry)
        shard, replica = original(self, *a, **kw)
        entry["joined"] = time.perf_counter()
        serve_fn = replica.serve

        def first_answer(*sa, **skw):
            got = serve_fn(*sa, **skw)
            entry.setdefault("first_answer", time.perf_counter())
            return got

        replica.serve = first_answer
        return shard, replica

    out = {}
    topology.Fleet.add_replica = add_replica
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp, \
                tee_stdout() as tee, capture_served_calls() as calls:
            args = serve_args("bayeslr", "--fleet", "--soak", "--autoscale", "--alerts",
                              "--stats-addr", "127.0.0.1:0", "--obs-dir", tmp,
                              "--replicas", "2")
            rc = counted(report, "O-soak", lambda: serve.serve_soak(args, out))
    finally:
        topology.Fleet.add_replica = original
    lines = tee.lines()
    check(rc == 0, f"phase O-soak: serve_soak returned 0 ({rc}): SOAK_OK")
    f = line_fields(lines, "SOAK_OK ")
    check(f["kills"] == "1" and f["recovered"] == "1" and int(f["resyncs"]) >= 1
          and f["parity"] == "ok(bitexact)" and int(f["scale_up"]) >= 1
          and int(f["scale_down"]) >= 1 and int(f["alerts_fired"]) >= 1,
          f"phase O-soak: SOAK_OK with kills=1 recovered=1 resyncs>=1 parity=ok(bitexact) "
          f"scale_up>=1 scale_down>=1 alerts_fired>=1 ({f})")
    check(any(ln.startswith("STATS_OK ") for ln in lines)
          and any(ln.startswith("ALERTS_OK ") for ln in lines),
          "phase O-soak printed STATS_OK and ALERTS_OK")
    rep = out["report"]
    top = rep["classes"]["bayeslr.predictive"]
    join = [{"add_replica_s": e["joined"] - e["start"],
             "to_first_answer_s": e.get("first_answer", float("nan")) - e["start"]}
            for e in joins]
    r = {"served": out["served"], "submitted": out["submitted"], "wall_s": out["wall_s"],
         "req_per_s": out["req_per_s"], "top_class_p95_ms": top.get("p95_ms"),
         "top_class_p99_ms": top.get("p99_ms"), "reroutes": rep["recovery"]["rerouted"],
         "lane_deaths": rep["recovery"]["lane_deaths"], "shed": rep["shed"],
         "resyncs": out["resyncs"], "scaler_events": out["scaler_events"],
         "alerts_fired": out["alerts_fired"], "burst_submitted": out["burst_submitted"],
         "burst_shed": out["burst_shed"], "joins": join}
    report["phases"]["O-soak"].update(r)
    print(f"  phase O-soak: {r['served']} served of {r['submitted']} in {r['wall_s']:.1f}s "
          f"({r['req_per_s']:.1f}/s), top class p95 {r['top_class_p95_ms']} ms, reroutes "
          f"{r['reroutes']}, lane deaths {r['lane_deaths']}, shed {r['shed']}, resyncs "
          f"{r['resyncs']}, scaler {r['scaler_events']}, alerts fired {r['alerts_fired']}; "
          f"joins (add_replica s, to the first answer s): "
          + ", ".join(f"{j['add_replica_s']:.3f} / {j['to_first_answer_s']:.3f}" for j in join))
    check(len(join) >= 1 and all(math.isfinite(j["to_first_answer_s"]) for j in join),
          "phase O-soak: every replica the scaler added answered")
    hold_served_calls(report, "O-soak", calls)


def phase_o_kill_proc(report):
    """O-kill-proc: ``--fleet --soak --replica-transport proc --soak-seconds
    8 --stats-addr`` at Q's settings: a replica process SIGKILLed and
    respawned; ``SOAK_OK`` with bit-exact parity and ``STATS_OK``. The
    restart's seconds and the card's free memory just before the kill, just
    after it, just before the restart and after it are read by wrapping
    ``ReplicaProcess.kill`` and ``restart`` here."""
    import torch

    from repro_torch.fleet import replica as replica_mod
    from repro_torch.launch import serve

    marks = {}
    kill0, restart0 = replica_mod.ReplicaProcess.kill, replica_mod.ReplicaProcess.restart
    free = lambda: torch.cuda.mem_get_info()[0]  # noqa: E731

    def kill(self, *a, **kw):
        marks["free_before_kill"] = free()
        kill0(self, *a, **kw)
        marks["free_after_kill"] = free()

    def restart(self, *a, **kw):
        marks["free_before_restart"] = free()
        t0 = time.perf_counter()
        restart0(self, *a, **kw)
        marks["restart_s"] = time.perf_counter() - t0
        marks["child_start_s"] = self.start_s
        marks["free_after_restart"] = free()

    out = {}
    replica_mod.ReplicaProcess.kill, replica_mod.ReplicaProcess.restart = kill, restart
    try:
        with tee_stdout() as tee:
            args = serve_args("bayeslr", "--fleet", "--soak", "--replica-transport", "proc",
                              "--soak-seconds", str(O_PROC_SOAK_S), "--stats-addr",
                              "127.0.0.1:0")
            rc = counted(report, "O-kill-proc", lambda: serve.serve_soak(args, out))
    finally:
        replica_mod.ReplicaProcess.kill, replica_mod.ReplicaProcess.restart = kill0, restart0
    lines = tee.lines()
    check(rc == 0, f"phase O-kill-proc: serve_soak returned 0 ({rc}): SOAK_OK")
    f = line_fields(lines, "SOAK_OK ")
    check(f["parity"] == "ok(bitexact)" and f["kills"] == "1" and int(f["resyncs"]) >= 1,
          f"phase O-kill-proc: SOAK_OK with parity=ok(bitexact) after a SIGKILL ({f})")
    check(any(ln.startswith("STATS_OK ") for ln in lines), "phase O-kill-proc printed STATS_OK")
    check({"free_before_kill", "free_after_kill", "restart_s"} <= set(marks),
          "phase O-kill-proc: the replica process was killed and restarted")
    rep = out["report"]
    mib = lambda b: b / 2 ** 20  # noqa: E731
    r = {"served": out["served"], "wall_s": out["wall_s"], "req_per_s": out["req_per_s"],
         "top_class_p95_ms": rep["classes"]["bayeslr.predictive"].get("p95_ms"),
         "reroutes": rep["recovery"]["rerouted"], "lane_deaths": rep["recovery"]["lane_deaths"],
         "shed": rep["shed"], "resyncs": out["resyncs"], **marks,
         "freed_by_kill_mib": mib(marks["free_after_kill"] - marks["free_before_kill"]),
         "freed_by_restart_time_mib": mib(marks["free_before_restart"]
                                          - marks["free_before_kill"]),
         "taken_by_restart_mib": mib(marks["free_before_restart"]
                                     - marks["free_after_restart"])}
    report["phases"]["O-kill-proc"].update(r)
    print(f"  phase O-kill-proc: {r['served']} served in {r['wall_s']:.1f}s "
          f"({r['req_per_s']:.1f}/s), reroutes {r['reroutes']}, lane deaths "
          f"{r['lane_deaths']}, resyncs {r['resyncs']}; restart {r['restart_s']:.2f}s (the "
          f"child's start {r['child_start_s']:.2f}s); card free memory before the kill "
          f"{mib(marks['free_before_kill']):.0f} MiB, {r['freed_by_kill_mib']:+.0f} MiB just "
          f"after it, {r['freed_by_restart_time_mib']:+.0f} MiB by the restart, and the "
          f"restarted child took {r['taken_by_restart_mib']:.0f} MiB")


def phase_o(report):
    """Observability and the closed loop: Q's BayesLR serve without any obs
    flag and with every one on (O), alternated plain, obs, obs, plain in this
    call; the refresh beside the stats server; the chaos soak with the
    closed loop (O-soak); the soak over process replicas with a SIGKILL
    (O-kill-proc). The writers' and lanes' kernel calls of O and O-soak are
    held against plain."""
    import tempfile

    from repro_torch.launch import serve

    print(f"phase O: observability (repro_torch.obs) and the closed loop "
          f"(repro_torch.fleet.autoscale), bayeslr at Q's settings, {O_QUERIES} requests")
    secs = {}
    t0 = time.perf_counter()
    rates = {"plain": [], "obs": []}
    classes = {"plain": [], "obs": []}

    def run(kind, extra=()):
        out = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
            flags = ("--stats-addr", "127.0.0.1:0", "--obs-dir", tmp, "--alerts",
                     "--trace-dir", tmp) if kind == "obs" else ()
            rc = serve.serve_posterior(serve_args("bayeslr", "--queries", str(O_QUERIES),
                                                  *flags), out)
        check(rc == 0, f"phase O: serve_posterior ({kind}) returned 0 ({rc})")
        return out

    def note(kind, out):
        rates[kind].append(out["req_per_s"])
        classes[kind].append({c: {q: e[q] for q in ("p50_ms", "p95_ms", "p99_ms")}
                              for c, e in out["report"]["classes"].items()})

    note("plain", serve_phase(report, "O-plain", "bayeslr", "--queries", str(O_QUERIES),
                              hold=False))
    out = phase_o_obs(report)
    note("obs", out)
    note("obs", run("obs"))
    last = run("plain")
    note("plain", last)
    cost = stats_thread_cost(last["pool"])
    del out, last
    ratio = statistics.mean(rates["obs"]) / statistics.mean(rates["plain"])
    report["phases"]["O"].update(req_per_s_obs=rates["obs"], req_per_s_plain=rates["plain"],
                                 obs_over_plain=ratio, classes_obs=classes["obs"],
                                 classes_plain=classes["plain"], refresh_beside_stats=cost)
    print(f"  phase O: requests/s with every obs flag {rates['obs']}, with none "
          f"{rates['plain']} (plain, obs, obs, plain): obs / plain {ratio:.3f}; per class with "
          f"obs {classes['obs']}, without {classes['plain']}")
    sp = lambda d: f"{d['median']:.1f} [{d['min']:.1f}, {d['max']:.1f}]"  # noqa: E731
    print("  phase O: the refresh alone, median [min, max] transitions/s; round ops/s: "
          + "; ".join(f"{c} {sp(cost[c]['transitions_per_s'])}; {sp(cost[c]['round_ops_per_s'])}"
                      for c in ("no_server", "server_idle", "server_polled"))
          + f"; {cost['gets_served']} GETs served while polled")
    secs["O"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_o_soak(report)
    secs["O-soak"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_o_kill_proc(report)
    secs["O-kill-proc"] = time.perf_counter() - t0
    report["o_seconds"] = secs
    print("  seconds taken by phase O: " + "; ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; total {sum(secs.values()):.1f}")


Q_PROFILE_S = 3.0  # each window of the paced load in ``profile_q_bg``
Q_SWITCH_INTERVALS = (5e-3, 5e-4, 5e-5)  # sys.setswitchinterval tried; 5e-3 is Python's own


@contextlib.contextmanager
def round_clock():
    """While open, each call of ``ops.t_test_round`` (one a round of the
    sequential test) records, as it starts, (native thread id, wall clock,
    that thread's CPU clock). Yields the list."""
    from repro_torch.kernels import ops

    marks, orig = [], ops.t_test_round

    def call(*args, **kwargs):
        marks.append((threading.get_native_id(), time.perf_counter(), time.thread_time()))
        return orig(*args, **kwargs)

    ops.t_test_round = call
    try:
        yield marks
    finally:
        ops.t_test_round = orig


def round_stats(marks, window, ticks=()) -> dict:
    """A thread's rounds from ``round_clock`` marks (the thread with the
    most) that start and end inside ``window`` (start, end on the wall
    clock): rounds/s, each round's wall in ms at p50 / p90 / p99, and the
    share of the rounds' wall the thread spent off the CPU (waiting for a
    lock, the GIL among them, or asleep; from sums over the window: a
    thread's CPU clock may advance in scheduler ticks). With the query
    ticks of ``paced_queries``, the median wall of rounds that overlap a
    tick against those that do not, and the share of the window the query
    thread spent in ticks."""
    import bisect

    if not marks:
        return {"rounds": 0}
    tid = statistics.mode(m[0] for m in marks)
    rows = [(t, c) for th, t, c in marks if th == tid and window[0] <= t <= window[1]]
    wall_s = window[1] - window[0]
    spans = [(a[0], b[0], b[0] - a[0], b[1] - a[1]) for a, b in zip(rows, rows[1:])]
    walls = sorted(x[2] for x in spans)
    out = {"rounds": len(spans), "rounds_per_s": len(spans) / wall_s,
           "wall_ms": {f"p{q}": 1e3 * walls[min(len(walls) - 1, int(q / 100 * len(walls)))]
                       for q in (50, 90, 99)} if walls else None,
           "off_cpu_share": 1.0 - sum(x[3] for x in spans) / max(sum(walls), 1e-12)}
    if ticks:
        starts = [a for a, _ in ticks]

        def overlaps(a, b):  # the last tick to start before the round ends
            i = bisect.bisect_left(starts, b)
            return i > 0 and ticks[i - 1][1] > a

        hit = [w for a, b, w, _ in spans if overlaps(a, b)]
        miss = [w for a, b, w, _ in spans if not overlaps(a, b)]
        out.update(rounds_overlapping_queries=len(hit),
                   wall_ms_p50_overlapping_queries=1e3 * statistics.median(hit) if hit else None,
                   wall_ms_p50_between_queries=1e3 * statistics.median(miss) if miss else None,
                   query_thread_busy_share=sum(b - a for a, b in ticks) / wall_s)
    return out


def profile_q_bg() -> dict:
    """``--profile``'s serving window: Q's BayesLR pool (K=8, refresh 64,
    window 128), its refresh alone and a background refresh beside the
    paced query load of Q-bg, for ``Q_PROFILE_S`` each. The device's idle
    share comes from torch.profiler (CUDA activity, which covers both
    threads); the host timeline of both threads from the round op's calls
    in the refresh thread and the query ticks in the calling thread (the
    profiler records host ops of the thread that opened it only), and from
    each thread's CPU clock. Then the paced load again at each GIL switch
    interval of ``Q_SWITCH_INTERVALS`` (a thread that waits for the GIL
    asks its holder to drop it after one interval: if the refresh's rounds
    wait out the interval, a shorter one raises their rate), at a lighter
    load (``Q_SLOW_TICK_S``), and beside two contenders in place of the
    queries: pure Python, which holds the GIL and makes no CUDA call
    (at the longest and shortest interval), and loops of short (~10 us) and
    long (~1 ms) kernels on a stream of its own, each waited for with the
    GIL released: the long ones leave the GIL free ~100x longer for the
    same time in CUDA's synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EnsemblePool, FreshnessPolicy, ServingConfig

    pool = EnsemblePool(ServingConfig(num_chains=8, refresh_steps=64, window=128,
                                      freshness=FreshnessPolicy(min_draws=512), seed=0))
    resident = pool.add_workload("bayeslr")
    pool.warm()
    paced_queries(pool, lambda commits, elapsed: elapsed >= 0.5)  # first calls: stream, cuBLAS

    def device_idle(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        busy = sum(dev(e) for e in prof.key_averages()) / 1e6
        return {"wall_s": wall, "device_busy_s": busy,
                "idle_share": None if busy <= 0 else 1.0 - busy / wall}

    def alone():
        t0 = time.perf_counter()
        resident.refresh()
        return t0, time.perf_counter()

    def beside(ticks=None, tick_s=Q_BG_TICK_S):
        return paced_queries(pool, lambda commits, elapsed: elapsed >= Q_PROFILE_S, ticks, tick_s)

    def queries(label, tick_s=Q_BG_TICK_S):
        ticks = []
        with round_clock() as marks:
            run = beside(ticks, tick_s)
        rep = run["queue"].slo_report()
        out[label] = {**round_stats(marks, run["window"], ticks),
                      "req_per_s": run["submitted"] / run["wall"],
                      "refresh_thread_cpu_share": run["refresh_cpu_s"] / run["wall"],
                      "query_thread_cpu_share": run["query_cpu_s"] / run["wall"],
                      "latency_ms": {c: {q: e[q] for q in ("p50_ms", "p99_ms")}
                                     for c, e in rep["classes"].items()}}

    side = torch.cuda.Stream()

    def kernel_wait(cycles):
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
        side.synchronize()

    def contender(label, work):
        """The background refresh while the calling thread runs ``work``."""
        with round_clock() as marks:
            pool.start()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < Q_PROFILE_S:
                work()
            t1 = time.perf_counter()
            pool.stop()
        out[label] = round_stats(marks, (t0, t1))

    out = {"idle_refresh_alone": device_idle(alone),
           "idle_beside_queries": device_idle(beside)}
    with round_clock() as marks:
        window = alone()
    out["refresh_alone"] = round_stats(marks, window)
    default = sys.getswitchinterval()
    try:
        for interval in Q_SWITCH_INTERVALS:
            sys.setswitchinterval(interval)
            queries(f"beside_queries_switch_{interval:g}")
        sys.setswitchinterval(default)
        queries(f"beside_queries_tick_{Q_SLOW_TICK_S:g}", Q_SLOW_TICK_S)
        for interval in (Q_SWITCH_INTERVALS[0], Q_SWITCH_INTERVALS[-1]):
            sys.setswitchinterval(interval)
            contender(f"beside_python_switch_{interval:g}", lambda: sum(range(2000)))
        sys.setswitchinterval(default)
        contender("beside_short_kernels", lambda: kernel_wait(20_000))  # ~10 us each
        contender("beside_long_kernels", lambda: kernel_wait(2_000_000))  # ~1 ms each
    finally:
        sys.setswitchinterval(default)
    for name, r in out.items():
        print(f"  Q-bg {name}: {json.dumps(r, default=float)}")
    return out


def profile_idle_share() -> dict:
    """``--profile``: short windows of the main paths under torch.profiler
    (device activity only): wall time, summed device time of every kernel
    and copy, the device's idle share, and the kernels that take the most
    device time. The profiler slows the host, so each window also runs once
    without it; its wall time beside the profiled busy time gives an
    estimate (two runs, one call) of the unprofiled idle share. Not part of
    the default run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._device import make_generator
    from repro_torch.bayes import TrainConfig, make_train_step
    from repro_torch.configs import ARCHS
    from repro_torch.core import (ChainEnsemble, RandomWalk, ScheduleConfig, SubsampledMHConfig,
                                  run_chain, run_ensemble)
    from repro_torch.data import DataConfig, MarkovStream
    from repro_torch.experiments import bayeslr, jointdpm, stochvol
    from repro_torch.models import init_params
    from repro_torch.runtime import step_generator

    # the launcher's initial model: two of its train steps (H), and the ce
    # target of phases I and J
    cfg = ARCHS[LM_ARCH]
    params = init_params(0, cfg)
    _, ce_target = lm_ce_setup(params, cfg)
    table = params["embed"]["table"].float()
    lm_step = make_train_step(cfg, TrainConfig(round_batch=4, epsilon=0.05, sigma=1e-4))
    lm_batch = MarkovStream(DataConfig(cfg.vocab, 64, 16, seed=0)).batch(0)

    def lm_steps():
        for i in range(2):
            lm_step(step_generator(0, i, table.device), params, lm_batch)

    ce_cfg = SubsampledMHConfig(batch_size=CE_M, epsilon=0.05, sampler="fy")
    tiny = lambda t: t[..., :1, :1].clone()

    lr = bayeslr.synth_mnist_like(0)
    lr_target = bayeslr.make_target(lr.x_train, lr.y_train)
    lr_cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")
    lr_compiled = bayeslr_program(lr.x_train, lr.y_train)

    def compiled_lr_steps():  # phase P's K=32 run, started as phase C starts
        gen = make_generator(3, lr.x_train.device)
        ens = ChainEnsemble(lr_compiled, RandomWalk(0.05), 32, config=lr_cfg)
        theta0 = 0.5 * torch.randn(32, 50, generator=gen, device=lr.x_train.device)
        ens.run(gen, ens.init(theta0, batched=True), 20)

    def serve_window(obs: bool):  # phase O's serve, 200 requests, obs flags off or on
        import tempfile

        from repro_torch.launch import serve

        with tempfile.TemporaryDirectory(prefix="chip_profile_obs_") as tmp:
            flags = ("--stats-addr", "127.0.0.1:0", "--obs-dir", tmp, "--alerts",
                     "--trace-dir", tmp) if obs else ()
            check(serve.serve_posterior(serve_args("bayeslr", "--queries", "200", *flags)) == 0,
                  "profile window O: serve_posterior returned 0")

    sv = stochvol.synth(10, num_series=200, length=5)
    jdpm_cfg = jointdpm.JDPMConfig()
    jdpm = jointdpm.synth(60, JDPM_N, JDPM_N_TEST)
    jdpm0 = jointdpm.init_state(80, jdpm, jdpm_cfg)
    windows = {
        "B: BayesLR one chain, 100 transitions": lambda: run_chain(
            1, torch.zeros(50), lr_target, RandomWalk(0.05), 100, config=lr_cfg),
        "C: BayesLR K=32, 20 steps": lambda: bayeslr.run_posterior_ensemble(
            3, lr, num_chains=32, num_steps=20, batch_size=100, epsilon=0.05, sampler="stream",
            sigma=0.05),
        "P: compiled BayesLR program K=32, 20 steps": compiled_lr_steps,
        "K: BayesLR K=32 masked, 20 steps": lambda: bayeslr.run_posterior_ensemble(
            3, lr, num_chains=32, num_steps=20, batch_size=100, epsilon=0.05, sampler="stream",
            sigma=0.05, stepping="masked"),
        "L: BayesLR K=32 masked + schedule, Fisher-Yates, 20 steps":
            lambda: bayeslr.run_posterior_ensemble(
                3, lr, num_chains=32, num_steps=20, batch_size=100, epsilon=0.05, sampler="fy",
                sigma=0.05, stepping="masked", schedule=ScheduleConfig(epsilon_max=0.2)),
        "E: stochvol one chain, 50 cycle steps": lambda: stochvol.run_posterior_sequential(
            11, sv, 50),
        "F: stochvol K=32, 20 cycle steps": lambda: stochvol.run_posterior_ensemble(
            14, sv, num_chains=32, num_steps=20),
        "M: joint DP mixture one replica, 3 cycles": lambda: jointdpm.run_posterior_sequential(
            82, jdpm, jdpm_cfg, 3, state0=jdpm0),
        f"N: joint DP mixture K={JDPM_K}, 2 cycles": lambda: jointdpm.run_posterior_ensemble(
            92, jdpm, jdpm_cfg, JDPM_K, 2, state0=jdpm0),
        "H: chatglm3-6b train step (launcher defaults), 2 steps": lm_steps,
        "I: ce one chain, 5 transitions": lambda: run_chain(
            31, table, ce_target, RandomWalk(CE_SIGMA), 5, config=ce_cfg, collect=tiny),
        f"J: ce K={CE_K}, 2 steps": lambda: run_ensemble(
            41, table, ce_target, RandomWalk(CE_SIGMA), CE_K, 2, config=ce_cfg, collect=tiny),
        "O (off): serve_posterior BayesLR, 200 requests, no obs flag":
            lambda: serve_window(False),
        "O (on): the same with --stats-addr --obs-dir --alerts --trace-dir":
            lambda: serve_window(True),
    }
    out = {}
    for name, fn in windows.items():
        fn()  # warm-up outside the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()  # the same window without the profiler, for its wall time
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        events = sorted(prof.key_averages(), key=dev, reverse=True)
        busy_ms = sum(dev(e) for e in events) / 1e3
        top = [(e.key[:60], round(dev(e) / 1e3, 3), e.count) for e in events[:14] if dev(e) > 0]
        share = None if busy_ms <= 0 else 1.0 - busy_ms / wall_ms
        # an estimate from two runs of the window: the busy time taken under
        # the profiler over the wall time of the unprofiled run
        est = None if busy_ms <= 0 else 1.0 - busy_ms / plain_wall_ms
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": share,
                     "unprofiled_wall_ms": plain_wall_ms, "idle_share_estimate_unprofiled": est,
                     "top_kernels_ms_count": top}
        shown = "not measured (no device time recorded)" if share is None else f"{share:.4f}"
        print(f"  {name}: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms, idle share {shown}; "
              f"unprofiled wall {plain_wall_ms:.1f} ms, idle share estimated from the two runs "
              f"{'not measured' if est is None else f'{est:.4f}'}")
        for key, ms, count in top:
            print(f"      {ms:9.3f} ms  x{count:<6d} {key}")
    return out


def cf_iterations(state, df) -> int:
    """Continued-fraction steps this state needs, summed over the chains the
    test reached (the data-dependent part of the round op's work)."""
    import numpy as np

    count, mean, m2, mu0 = (s.cpu().numpy().astype(np.float32) for s in state[:4])
    f = np.float32
    std = np.sqrt(m2 / np.maximum(count - 1, 1))
    corr = np.clip(1 - (count - 1) / f(100_199), 0, 1)
    s = std / np.sqrt(np.maximum(count, 1)) * np.sqrt(corr)
    total = 0
    for i in range(len(count)):
        if not s[i] > 0:
            continue
        t = abs(mean[i] - mu0[i]) / s[i]
        a, b = f(df[i] / 2), f(0.5)
        x = f(df[i] / (df[i] + t * t))
        if not x < (a + 1) / (a + b + 2):
            a, b, x = b, a, f(1) - x
        c, d, small = f(np.finfo(np.float32).eps / 2), f(0), f(np.finfo(np.float32).eps / 2)
        for it in range(1, 200):
            if it == 1:
                num = f(1)
            else:
                mm = f((it - 1) // 2)
                if it % 2 == 0:
                    num = -(a + b) * x / (a + 1) if mm == 0 else \
                        -(a + mm) * (a + b + mm) * x / ((a + 2 * mm) * (a + 2 * mm + 1))
                else:
                    num = mm * (b - mm) * x / ((a + 2 * mm - 1) * (a + 2 * mm))
            c = f(1) + num / c
            c = small if abs(c) < small else c
            d = f(1) + num * d
            d = f(1) / (small if abs(d) < small else d)
            total += 1
            if abs(c * d - 1) < small:
                break
    return total


# ---------------------------------------------------------------------------
# Phases B-D: the main path
# ---------------------------------------------------------------------------


def counted(report, phase, fn):
    """Run ``fn`` with every launch count set to 0 first; record the counts
    (and the device memory held when the phase starts)."""
    import torch

    from repro_torch.kernels import ops

    held = torch.cuda.memory_allocated() / 2 ** 30
    report["phases"][phase]["gib_held_at_start"] = held
    print(f"  device memory held at the start of phase {phase}: {held:.2f} GiB")
    ops.reset_launches()
    out = fn()
    import torch

    torch.cuda.synchronize()
    counts = dict(ops.launches)
    report["phases"][phase]["launches"] = counts
    for name, n in counts.items():
        report["kernels"][name]["launches"] += n
    print(f"  launches during phase {phase}: {counts}")
    return out


def phase_b(report, data):
    import numpy as np
    import torch

    from repro_torch.core import RandomWalk, SubsampledMHConfig, acceptance_rate, run_chain
    from repro_torch.experiments import bayeslr

    print("phase B: one chain, N=12214 D=50, 1000 subsampled + 20 exact transitions")
    n = data.x_train.shape[0]
    target = bayeslr.make_target(data.x_train, data.y_train)
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")
    theta0 = torch.zeros(data.x_train.shape[1])

    def run():
        t0 = time.perf_counter()
        th, samples, infos = run_chain(1, theta0, target, RandomWalk(0.05), 1000, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, ex_samples, ex_infos = run_chain(2, th, target, RandomWalk(0.05), 20, kernel="exact")
        torch.cuda.synchronize()
        return th, samples, infos, wall, ex_infos, time.perf_counter() - t0

    th, samples, infos, wall, ex_infos, ex_wall = counted(report, "B", run)
    acc = acceptance_rate(infos)
    n_eval = float(infos.n_evaluated.float().mean())
    rounds = float(infos.rounds.float().mean())
    w_mean = samples[500:].mean(0)
    err_post = bayeslr.test_error(w_mean, data.x_test, data.y_test)
    err_true = bayeslr.test_error(data.w_true, data.x_test, data.y_test)
    r = {"accept": acc, "mean_n_evaluated": n_eval, "mean_rounds": rounds,
         "transitions_per_s": 1000 / wall, "exact_transitions_per_s": 20 / ex_wall,
         "exact_accept": acceptance_rate(ex_infos), "test_error_posterior_mean": err_post,
         "test_error_w_true": err_true}
    report["phases"]["B"].update(r)
    print(f"  acceptance={acc:.3f} mean n_evaluated={n_eval:.1f} ({n_eval / n:.2%} of N) "
          f"rounds={rounds:.2f} transitions/s={1000 / wall:.1f} exact transitions/s={20 / ex_wall:.1f} "
          f"test error {err_post:.3f} (w_true {err_true:.3f})")
    check(bool(torch.isfinite(samples).all()), "phase B samples finite, shape "
          f"{tuple(samples.shape)}")
    check(0.05 < acc < 0.95 and n_eval <= n, "phase B acceptance in (0.05, 0.95), n_evaluated <= N")
    check(err_post <= err_true + 0.05, "posterior-mean test error within 0.05 of w_true's")
    check(bool(np.all(ex_infos.n_evaluated.cpu().numpy() == n)), "exact steps evaluate all N")
    return th


def phase_c(report, data):
    import numpy as np
    import torch

    from repro_torch.core import SubsampledMHConfig
    from repro_torch.experiments import bayeslr

    print("phase C: K=32 chains in lock-step, 1000 steps")
    n = data.x_train.shape[0]
    k, steps = 32, 1000

    def run():
        t0 = time.perf_counter()
        samples, diag, _, infos = bayeslr_ensemble(3, data, k, steps)
        torch.cuda.synchronize()
        return samples, diag, time.perf_counter() - t0, infos

    samples, diag, wall, infos = counted(report, "C", run)
    rhat = np.asarray(diag["rhat"])
    r = {"rhat_max": float(rhat.max()), "rhat_median": float(np.median(rhat)),
         "ess_w0": diag["ess_w0"], "accept": diag["accept_rate_overall"],
         "mean_n_evaluated_frac": diag["mean_n_evaluated_overall"] / n,
         "mean_rounds": diag["mean_rounds_overall"],
         "rounds_p99": diag["rounds_tail"]["p99"],
         "transitions_per_s": k * steps / wall,
         "lockstep_rounds": int(infos.rounds.long().max(0).values.sum()),
         "rounds_per_chain": float(infos.rounds.long().sum(1).float().mean())}
    report["phases"]["C"].update(r)
    print(f"  split R-hat max={r['rhat_max']:.3f} median={r['rhat_median']:.3f} "
          f"ESS(w0)={r['ess_w0']:.1f} acceptance={r['accept']:.3f} "
          f"n_evaluated/N={r['mean_n_evaluated_frac']:.4f} transitions/s={r['transitions_per_s']:.1f}")
    check(bool(np.isfinite(samples).all()) and samples.shape == (k, steps, 50),
          f"phase C samples finite, shape {samples.shape}")
    check(0.05 < r["accept"] < 0.95, "phase C acceptance in (0.05, 0.95)")

    # fused route against the batched plain route on 200 fixed proposals
    target = bayeslr.make_target(data.x_train, data.y_train)
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")
    rng = np.random.default_rng(7)
    flat = samples.reshape(-1, 50)
    theta = torch.tensor(flat[rng.integers(0, len(flat), 200)], device="cuda")
    theta_p = theta + 0.05 * torch.tensor(rng.standard_normal((200, 50)), dtype=torch.float32,
                                          device="cuda")
    log_u = torch.tensor(np.log(rng.uniform(1e-20, 1.0, 200)), dtype=torch.float32, device="cuda")
    report["phases"]["C"]["fused_vs_plain_differ"] = fused_vs_never(
        target, theta, theta_p, log_u, cfg, "phase C")
    return samples, infos, wall



def bayeslr_ensemble(seed, data, num_chains, num_steps, *, sigma=0.05, overdisperse=0.5,
                     batch_size=100, epsilon=0.05, sampler="stream", **ens_kw):
    """What ``bayeslr.run_posterior_ensemble`` does, step for step (the same
    draws from the same generator, so the same samples), through the
    entry points it calls, returning also the final state and the infos it
    only summarises: (samples (K, T, D) numpy, diagnostics, state, infos).
    ``ens_kw`` goes to ``ChainEnsemble`` (stepping, schedule,
    fused_kernels)."""
    import torch

    from repro_torch._device import make_generator
    from repro_torch.core import (ChainEnsemble, RandomWalk, SubsampledMHConfig,
                                  ensemble_summary, multichain_ess, split_rhat)
    from repro_torch.experiments import bayeslr

    dev = torch.device("cuda")
    gen = make_generator(seed, dev)
    target = bayeslr.make_target(data.x_train.to(dev), data.y_train.to(dev))
    cfg = SubsampledMHConfig(batch_size=batch_size, epsilon=epsilon, sampler=sampler)
    ens = ChainEnsemble(target, RandomWalk(sigma), num_chains, config=cfg, device=dev, **ens_kw)
    theta0 = overdisperse * torch.randn(num_chains, data.x_train.shape[1], generator=gen,
                                        device=dev)
    state, samples, infos = ens.run(gen, ens.init(theta0, batched=True), num_steps)
    samples = samples.cpu().numpy()
    w = samples[:, num_steps // 2:]
    diag = {"rhat": split_rhat(w), "ess_w0": multichain_ess(w[..., 0]), **ensemble_summary(infos)}
    return samples, diag, state, infos


def chain_summary(samples, diag, infos, n, wall, k, steps):
    """The numbers phases C, K and L report on a K-chain BayesLR run."""
    import numpy as np

    rhat = np.asarray(diag["rhat"])
    rounds = infos.rounds.long()
    return {"rhat_max": float(rhat.max()), "rhat_median": float(np.median(rhat)),
            "ess_w0": diag["ess_w0"], "accept": diag["accept_rate_overall"],
            "mean_n_evaluated_frac": diag["mean_n_evaluated_overall"] / n,
            "mean_rounds": diag["mean_rounds_overall"], "rounds_p99": diag["rounds_tail"]["p99"],
            "transitions_per_s": k * steps / wall,
            "lockstep_rounds": int(rounds.max(0).values.sum()),
            "supersteps": int(rounds.sum(1).max()),
            "rounds_per_chain": float(rounds.sum(1).float().mean())}


K_STEPS = 250  # phase K's depth: C's first 250 steps


def phase_k(report, data, c_out):
    """Phase C's configuration with masked stepping for C's first
    ``K_STEPS`` steps: the same samples and infos as C's first steps, bit
    for bit (the stream sampler draws nothing in the rounds, so each
    chain's step t draws from lock-step's generator state), in
    max_k sum_t rounds supersteps instead of sum_t max_k rounds rounds."""
    import numpy as np
    import torch

    from repro_torch.core import SubsampledMHInfo

    print(f"phase K: phase C's configuration with stepping='masked', K=32, C's first {K_STEPS} steps")
    n, k, steps = data.x_train.shape[0], 32, K_STEPS
    c_samples, c_infos, c_wall = c_out
    c_samples, c_infos = c_samples[:, :steps], SubsampledMHInfo(*(f[:, :steps] for f in c_infos))

    def run():
        t0 = time.perf_counter()
        samples, diag, _, infos = bayeslr_ensemble(3, data, k, steps, stepping="masked")
        torch.cuda.synchronize()
        return samples, diag, time.perf_counter() - t0, infos

    samples, diag, wall, infos = counted(report, "K", run)
    r = chain_summary(samples, diag, infos, n, wall, k, steps)
    c = report["phases"]["C"]
    r["launches_t_test_round"] = report["phases"]["K"]["launches"].get("t_test_round", 0)
    r["c_lockstep_rounds"] = int(c_infos.rounds.long().max(0).values.sum())
    r["c_transitions_per_s"] = c["transitions_per_s"]
    report["phases"]["K"].update(r)
    print(f"  supersteps={r['supersteps']} (round-op launches {r['launches_t_test_round']}) against "
          f"C's lock-step rounds over the same steps {r['c_lockstep_rounds']}; rounds a chain "
          f"{r['rounds_per_chain']:.1f}; transitions/s={r['transitions_per_s']:.1f} "
          f"(C: {c['transitions_per_s']:.1f}); acceptance={r['accept']:.3f} "
          f"R-hat max={r['rhat_max']:.3f} ESS(w0)={r['ess_w0']:.1f}")
    check(np.array_equal(samples, c_samples), f"phase K samples equal phase C's first {steps} bit for bit")
    same = [name for name, a, b in zip(SubsampledMHInfo._fields, infos, c_infos)
            if a.dtype == b.dtype and torch.equal(a, b)]
    check(len(same) == len(SubsampledMHInfo._fields),
          f"phase K infos equal phase C's first {steps} bit for bit (equal: {same})")
    check(r["supersteps"] == r["launches_t_test_round"] < r["c_lockstep_rounds"],
          "one round op a superstep; fewer supersteps than lock-step rounds")


def first_difference_borderline(a, b) -> tuple[int, bool]:
    """Two masked runs of one configuration from one seed through two routes
    (infos (K, T)): how many transitions differ in decision or n_evaluated,
    and whether the first of them to commit had a p-value within 0.1% of its
    epsilon (phase C's allowance). A chain's transitions run back to back,
    one round a superstep, so transition t of chain k commits at superstep
    sum_{t' <= t} rounds; once one decision differs, every later superstep
    draws from a shifted stream and may differ too."""
    import torch

    differ = (a.accepted != b.accepted) | (a.n_evaluated != b.n_evaluated)
    n_diff = int(differ.sum())
    if not n_diff:
        return 0, True
    commit = torch.minimum(a.rounds.long().cumsum(1), b.rounds.long().cumsum(1))
    flat = torch.where(differ, commit, torch.iinfo(torch.int64).max).flatten().argmin()
    kk, t = divmod(int(flat), differ.shape[1])
    near = lambda i: abs(float(i.pvalue[kk, t]) - float(i.epsilon[kk, t])) <= 1e-3 * float(
        i.epsilon[kk, t])
    return n_diff, near(a) or near(b)


def phase_l(report, data):
    """The README's adaptive form: masked stepping, the per-chain controller
    (ScheduleConfig(epsilon_max=0.2): buckets 50..400), the Fisher–Yates
    sampler (the bounded fy_draw kernel), K=32, 1000 steps; then 20 steps
    through the fused route and through fused_kernels='never'."""
    import numpy as np
    import torch

    from repro_torch.core import ScheduleConfig, SubsampledMHConfig
    from repro_torch.experiments import bayeslr

    print("phase L: adaptive masked stepping, ScheduleConfig(epsilon_max=0.2), fy sampler, "
          "K=32, 1000 steps")
    n, k, steps = data.x_train.shape[0], 32, 1000
    sched = ScheduleConfig(epsilon_max=0.2)
    buckets = sched.buckets_for(SubsampledMHConfig(batch_size=100), n)
    kw = dict(stepping="masked", schedule=sched)

    def run():
        t0 = time.perf_counter()
        out = bayeslr_ensemble(3, data, k, steps, sampler="fy", **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (samples, diag, state, infos), wall = counted(report, "L", run)
    r = chain_summary(samples, diag, infos, n, wall, k, steps)
    eps, meff = infos.epsilon.cpu().numpy(), infos.batch_eff.cpu().numpy()
    w_mean = samples[:, steps // 2:].reshape(-1, samples.shape[-1]).mean(0)
    r.update(launches_t_test_round=report["phases"]["L"]["launches"].get("t_test_round", 0),
             mean_epsilon=float(eps.mean()), final_epsilon=float(eps[:, -1].mean()),
             mean_batch_eff=float(meff.mean()), final_batch_eff=float(meff[:, -1].mean()),
             batch_eff_counts={int(b): int((meff == b).sum()) for b in buckets},
             test_error_posterior_mean=bayeslr.test_error(w_mean, data.x_test, data.y_test),
             test_error_w_true=bayeslr.test_error(data.w_true, data.x_test, data.y_test),
             c_transitions_per_s=report["phases"]["C"]["transitions_per_s"])
    report["phases"]["L"].update(r)
    print(f"  transitions/s={r['transitions_per_s']:.1f} (C: {r['c_transitions_per_s']:.1f}) "
          f"supersteps={r['supersteps']} rounds a transition mean {r['mean_rounds']:.2f} "
          f"p99 {r['rounds_p99']:.0f}; n_evaluated/N={r['mean_n_evaluated_frac']:.4f}; epsilon "
          f"mean {r['mean_epsilon']:.4f} final {r['final_epsilon']:.4f}; batch_eff mean "
          f"{r['mean_batch_eff']:.1f} final {r['final_batch_eff']:.1f} {r['batch_eff_counts']}; "
          f"acceptance={r['accept']:.3f} R-hat max={r['rhat_max']:.3f} ESS(w0)={r['ess_w0']:.1f}; "
          f"test error {r['test_error_posterior_mean']:.3f} (w_true {r['test_error_w_true']:.3f})")
    check(bool(np.isfinite(samples).all()) and samples.shape == (k, steps, 50),
          f"phase L samples finite, shape {samples.shape}")
    check(eps.min() >= np.float32(0.05) and eps.max() <= np.float32(0.2)
          and set(np.unique(meff).tolist()) <= set(buckets)
          and state.controller.t.tolist() == [steps] * k,
          f"phase L knobs within bounds: epsilon in [0.05, 0.2], batch_eff in {buckets}, "
          f"{steps} controller updates a chain")
    check(0.05 < r["accept"] < 0.95, "phase L acceptance in (0.05, 0.95)")
    check(r["test_error_posterior_mean"] <= r["test_error_w_true"] + 0.05,
          "phase L posterior-mean test error within 0.05 of w_true's")

    controller_cost(report, state.controller, infos, sched, buckets, n)

    out = {}
    for route in ("auto", "never"):
        out[route] = bayeslr_ensemble(5, data, k, 20, sampler="fy", fused_kernels=route, **kw)[3]
    n_diff, borderline = first_difference_borderline(out["auto"], out["never"])
    report["phases"]["L"]["fused_vs_plain_differ"] = n_diff
    print(f"  fused vs never, 20 steps: {n_diff} of {k * 20} transitions differ in decision or "
          "n_evaluated")
    check(borderline, "fused and plain routes agree until a p-value within 0.1% of epsilon "
                      "(phase C's allowance) sends them apart")


def controller_cost(report, ctrl, infos, sched, buckets, n):
    """Device and host time of one ``controller_update`` of L's 32 chains,
    with the sigma scale's update (``adapt_proposal``, whose exp repeats
    XLA's CPU polynomial op by op) and without it (L's own setting), and of
    that exp alone beside ``torch.exp``."""
    import dataclasses

    import torch

    from repro_torch.core import SubsampledMHConfig, SubsampledMHInfo, controller_update
    from repro_torch.core.schedule import _exp_f32

    info = SubsampledMHInfo(*(f[:, -1] for f in infos))
    floor = sched.epsilon_floor(SubsampledMHConfig(batch_size=100, epsilon=0.05))
    x = torch.linspace(-0.3, 0.3, ctrl.epsilon.shape[0], device="cuda")
    calls = {"update": lambda: controller_update(ctrl, info, sched, buckets, n, floor),
             "update, adapt_proposal": lambda: controller_update(
                 ctrl, info, dataclasses.replace(sched, adapt_proposal=True), buckets, n, floor),
             "exp as XLA's CPU code": lambda: _exp_f32(x), "torch.exp": lambda: torch.exp(x)}
    r = {}
    for name, fn in calls.items():
        ms, host_ms = time_ms(fn, 10)
        r[name] = {"ms": ms, "host_ms": host_ms}
        print(f"  controller_update cost, K=32: {name:24s} device {ms * 1e3:7.2f}us "
              f"host {host_ms * 1e3:7.2f}us a call")
    report["phases"]["L"]["controller_cost"] = r


MALA_STEPS = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4)  # the sweep of phase B'


def phase_b_mala(report, data, theta0):
    """One chain on B's data from B's last sample, MALA with the gradient of
    the first 100 rows rescaled by N/100: 30 transitions at each step of a
    short sweep, then 200 at the step whose acceptance is nearest MALA's
    0.574."""
    import torch

    from repro_torch.core import MALA, SubsampledMHConfig, acceptance_rate, run_chain
    from repro_torch.experiments import bayeslr

    print("phase B': one chain, MALA (gradient of 100 rows x N/100), N=12214 D=50, 200 transitions")
    target = bayeslr.make_target(data.x_train, data.y_train)
    grad_fn = bayeslr.make_grad_fn(data.x_train, data.y_train, subsample=100)
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05, sampler="stream")

    def run():
        sweep = {}
        for i, step in enumerate(MALA_STEPS):
            _, _, infos = run_chain(10 + i, theta0, target, MALA(step, grad_fn), 30, config=cfg)
            sweep[step] = acceptance_rate(infos)
        step = min(MALA_STEPS, key=lambda s: abs(sweep[s] - 0.574))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, samples, infos = run_chain(4, theta0, target, MALA(step, grad_fn), 200, config=cfg)
        torch.cuda.synchronize()
        return sweep, step, samples, infos, time.perf_counter() - t0

    sweep, step, samples, infos, wall = counted(report, "B'", run)
    r = {"sweep_accept": sweep, "step": step, "accept": acceptance_rate(infos),
         "mean_rounds": float(infos.rounds.float().mean()), "transitions_per_s": 200 / wall,
         "mean_n_evaluated": float(infos.n_evaluated.float().mean())}
    report["phases"]["B'"].update(r)
    print(f"  sweep acceptance {sweep}; step {step}: acceptance={r['accept']:.3f} "
          f"rounds={r['mean_rounds']:.2f} transitions/s={r['transitions_per_s']:.1f}")
    check(bool(torch.isfinite(samples).all()) and tuple(samples.shape) == (200, 50),
          "phase B' samples finite, shape (200, 50)")
    check(0.05 < r["accept"] < 0.95, "phase B' acceptance in (0.05, 0.95)")

def phase_d(report):
    import numpy as np
    import torch

    from repro_torch.core import RandomWalk, SubsampledMHConfig, make_kernel, mh_step
    from repro_torch.experiments import bayeslr

    print("phase D: Fig. 5, evaluated sections per transition at fixed theta")
    rows = []

    def run():
        for n in (10_000, 100_000, 1_000_000):
            data = bayeslr.synth_2d(0, n)
            target = bayeslr.make_target(data.x_train, data.y_train)
            cfg = SubsampledMHConfig(batch_size=100, epsilon=0.01, sampler="stream")
            state0, step = make_kernel(target, RandomWalk(0.1), cfg)
            theta = torch.tensor([1.6, -1.6], device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(100)
            step(gen, theta, state0)  # warm-up
            torch.cuda.synchronize()
            evals = []
            t0 = time.perf_counter()
            for _ in range(60):
                _, _, info = step(gen, theta, state0)  # theta stays fixed
                evals.append(info.n_evaluated)
            torch.cuda.synchronize()
            sub_s = (time.perf_counter() - t0) / 60
            t0 = time.perf_counter()
            for _ in range(3):
                mh_step(gen, theta, target, RandomWalk(0.1))
            torch.cuda.synchronize()
            ex_s = (time.perf_counter() - t0) / 3
            mean_eval = float(torch.stack(evals).float().mean())
            rows.append({"N": n, "mean_n_evaluated": mean_eval, "frac": mean_eval / n,
                         "subsampled_us": sub_s * 1e6, "exact_us": ex_s * 1e6})

    counted(report, "D", run)
    for r in rows:
        print(f"  N={r['N']:>8d} mean n_evaluated={r['mean_n_evaluated']:9.1f} "
              f"({r['frac']:.4%}) subsampled={r['subsampled_us']:.0f}us exact={r['exact_us']:.0f}us")
    report["phases"]["D"]["rows"] = rows
    fr = [r["frac"] for r in rows]
    check(fr[0] > fr[1] > fr[2], "n_evaluated / N falls as N grows")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "kernels", "csrc")):
        print("chip_smoke: run it from a checkout: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_dir = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s into {lib_dir}")
    for src, log in _build.build_log.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(\w+_kernel)(I\w+?E)?Ev", line)
                entry = "".join(g or "" for g in m.groups()) if m else ""
            elif "Used" in line or "spill" in line:
                print(f"  {src}: {entry} {line.strip()}")
    from repro_torch.kernels import fused_ce

    f32, b16 = torch.float32, torch.bfloat16
    print("  fused_ce.cu dynamic shared memory (bytes): " + ", ".join(
        f"{label} {fused_ce.smem_bytes(hd, td, rnd)}" for label, hd, td, rnd in (
            ("bf16 h x fp32 table", b16, f32, False), ("fp32 x fp32", f32, f32, False),
            ("bf16 x bf16", b16, b16, False), ("fp32 h x bf16 table", f32, b16, False),
            ("precision=bf16", f32, f32, True))))
    if "--profile" in sys.argv[1:]:
        print("device idle share under torch.profiler (no checks; not the default run)")
        prof = profile_idle_share()
        print("serving: Q-bg's refresh beside paced queries, the host timeline of both threads")
        q_bg = profile_q_bg()
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_profile.json"), "w") as f:
            json.dump({"card": card, "windows": prof, "q_bg": q_bg}, f, indent=1, default=float)
        print(card)
        return 0

    replaces = {
        "fused_ce": "src/repro/kernels/fused_ce.py:65",
        "batched_fused_ce": "src/repro/kernels/fused_ce.py:144",
        "logit_delta": "src/repro/kernels/logit_loglik.py:35",
        "batched_logit_delta": "src/repro/kernels/batched_loglik.py:40",
        "t_test_round": "src/repro/core/sequential_test.py:32 (XLA-fused, not a pallas_call)",
        "gaussian_ar1_delta": "src/repro/kernels/gaussian_ar1.py:41",
        "fy_draw": "src/repro/core/samplers.py:62 (XLA fori_loop, not a pallas_call)",
        "pgibbs_sweep": "src/repro/kernels/pgibbs.py:58 (XLA-fused scan, not a pallas_call)",
        "gibbs_z_sweep": "src/repro/experiments/jointdpm.py:103 (XLA fori_loop at :138, not a "
                         "pallas_call)",
    }
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {
        "fused_ce": csrc + "fused_ce.cu",
        "batched_fused_ce": csrc + "fused_ce.cu",
        "logit_delta": csrc + "logit_delta.cu",
        "batched_logit_delta": csrc + "logit_delta.cu",
        "t_test_round": csrc + "t_test_round.cu",
        "gaussian_ar1_delta": csrc + "gaussian_ar1_delta.cu",
        "fy_draw": csrc + "fy_draw.cu",
        "pgibbs_sweep": csrc + "pgibbs_sweep.cu",
        "gibbs_z_sweep": csrc + "gibbs_z_sweep.cu",
    }
    report = {"card": card, "kind": kind, "phases": {p: {} for p in
                                                      [*"BCDEFGHIJKLMN", "B'", "P", "P1",
                                                       "P-AR1", "S", "S-compiled", "Q", "Q-bg",
                                                       "Q-sv", "Q-jdpm", "Q-ppl", "Q-resume", "R", "R-sub",
                                                       "R-truth", "R-bg", "R-proc", "O-plain",
                                                       "O", "O-soak", "O-kill-proc"]},
              "kernels": {name: {"name": name, "route": "cuda", "source": sources[name],
                                 "replaces": replaces[name], "launches": 0, "max_abs_err": 0.0,
                                 "ms": None, "plain_ms": None, "bound_ms": None,
                                 "bound_by": None, "library_ms": None, "cases": []}
                          for name in replaces}}
    print("library_ms: torch.matmul + F.cross_entropy(reduction='none') for the two CE kernels "
          "(two calls that build the (T, V) logits); index_select + bmm (or matmul) against the "
          "stacked (D, 2) pair + softplus for the two logit kernels; null for the others, which "
          "no PyTorch call computes")

    from repro_torch.experiments import bayeslr, jointdpm

    phase_a_logit(report)
    phase_a(report)
    phase_a_sv(report)
    jdpm_data = jointdpm.synth(60, JDPM_N, JDPM_N_TEST)
    t_jdpm = time.perf_counter()
    phase_a_jdpm(report, jdpm_data)
    report["jdpm_seconds"] = {"A": time.perf_counter() - t_jdpm}
    data = bayeslr.synth_mnist_like(0)
    theta_b = phase_b(report, data)
    phase_b_mala(report, data, theta_b)
    c_out = phase_c(report, data)
    phase_k(report, data, c_out)
    c_samples, c_infos = c_out[0], c_out[1]  # phase P starts as C does
    del c_out
    phase_l(report, data)
    phase_d(report)
    phase_e(report)
    phase_f(report)
    phase_g(report)
    t_jdpm = time.perf_counter()
    jdpm_state0 = phase_m(report, jdpm_data)
    report["jdpm_seconds"]["M"] = time.perf_counter() - t_jdpm
    phase_n(report, jdpm_data, jdpm_state0)
    report["jdpm_seconds"]["N"] = time.perf_counter() - t_jdpm - report["jdpm_seconds"]["M"]
    print(f"  seconds taken by the joint DP mixture's phases: {report['jdpm_seconds']}")
    del jdpm_data, jdpm_state0
    phase_a_ce(report)
    params, cfg = phase_h(report)
    target, theta = phase_i(report, params, cfg)
    del params  # phase H's model: J needs the room
    torch.cuda.empty_cache()
    phase_j(report, target, theta)
    del target, theta
    torch.cuda.empty_cache()
    t_ps = time.perf_counter()
    compiled = phase_p(report, data, c_samples, c_infos)
    phase_s(report, data, theta_b, compiled)
    report["p_s_seconds"] = time.perf_counter() - t_ps
    print(f"  seconds taken by phases P and S: {report['p_s_seconds']:.1f}")
    del compiled
    torch.cuda.empty_cache()
    phase_q(report)
    torch.cuda.empty_cache()
    phase_r(report)
    torch.cuda.empty_cache()
    phase_o(report)
    for name, e in report["kernels"].items():
        check(e["launches"] > 0, f"{name} launched on the main path ({e['launches']} times)")
    sv = ("gaussian_ar1_delta", "fy_draw", "pgibbs_sweep", "t_test_round")
    for phase, need in (("B", ("logit_delta", "t_test_round")),
                        ("B'", ("logit_delta", "t_test_round")),
                        ("C", ("batched_logit_delta", "t_test_round")),
                        ("K", ("batched_logit_delta", "t_test_round")),
                        ("L", ("batched_logit_delta", "fy_draw", "t_test_round")),
                        ("D", ("logit_delta", "t_test_round")),
                        ("E", sv), ("F", sv), ("G", sv[:2] + sv[3:]),
                        ("M", ("gibbs_z_sweep", "logit_delta", "fy_draw", "t_test_round")),
                        ("N", ("gibbs_z_sweep", "batched_logit_delta", "fy_draw",
                               "t_test_round")),
                        ("H", ("t_test_round",)),
                        ("I", ("fused_ce", "fy_draw", "t_test_round")),
                        ("J", ("batched_fused_ce", "fy_draw", "t_test_round")),
                        ("P", ("batched_logit_delta", "t_test_round")),
                        ("P1", ("t_test_round",)),
                        ("P-AR1", ("gaussian_ar1_delta", "fy_draw", "t_test_round")),
                        ("S", ("logit_delta", "fy_draw", "t_test_round")),
                        ("S-compiled", ("fy_draw", "t_test_round")),
                        *Q_NEEDS.items(), *R_NEEDS.items(), *O_NEEDS.items()):
        got = report["phases"][phase]["launches"]
        check(all(got.get(n, 0) > 0 for n in need), f"phase {phase} went through {need}")
    for phase in ("P1", "S-compiled"):  # one chain of a compiled program: the graph route
        got = report["phases"][phase]["launches"]
        check(got.get("logit_delta", 0) == got.get("batched_logit_delta", 0) == 0,
              f"phase {phase} scored its rounds on the graph, with no pair-delta kernel")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    line = [{k: v for k, v in e.items() if k != "cases"} for e in report["kernels"].values()]
    print(card)
    print(json.dumps({"kernels": line}, default=float))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
