"""Posterior query serving front end, the port of ``repro.launch.serve``'s
posterior path.

Serves posterior-functional queries from a pool of resident ensembles (warm
multi-chain sampler state, optional background refresh, request batching,
SLO-aware freshness; see :mod:`repro_torch.serving`):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload bayeslr
    PYTHONPATH=src python -m repro_torch.launch.serve --workload stochvol \\
        --queries 500 --max-batch 32 --deadline-ms 100
    PYTHONPATH=src python -m repro_torch.launch.serve --workload bayeslr --smoke --device cpu

Per request class it prints p50/p95/p99 latency, deadline hit rate and
snapshot staleness, then cross-checks one served batch of the workload's
default class against the same functional computed offline in float64
numpy from the identical snapshot draws, and ends with
``SERVE_OK workload=... parity=...``. ``--device`` defaults to the card and
raises without one; ``cpu`` runs the plain PyTorch versions.

``--fleet`` serves through the sharded fleet instead
(:mod:`repro_torch.fleet`): writer resident ensembles per workload shard
stream snapshot deltas to ``--replicas`` read replicas (in this process, or
each in a process of its own with ``--replica-transport proc``), and a
router with priorities and admission control spreads requests over the
replica lanes; it ends in ``SERVE_OK ... fleet=1 ... delta_ratio=...
parity=...``, the parity being a replica's answer against its writer's, bit
for bit. ``--subposterior P`` partitions the observations into P stride
shards, each with its own writers under the ``p(theta)^(1/P)`` tempered
prior, and the router combines their windows at query time (``--combine
consensus|product``); ``--stream`` appends an observation chunk to the
running writers mid-serve and prints ``STREAM_OK``:

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --subposterior 4 --stream
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --replica-transport proc

Observability (:mod:`repro_torch.obs`), with the reference's flags and
output lines: ``--obs-dir`` writes per-run JSONL metric streams and a
``summary.json`` (default ``$REPRO_OBS_DIR``), ``--stats-addr HOST:PORT``
serves the live rollup as JSON and prints ``STATS_OK``, ``--alerts``
evaluates the standard rules and prints ``ALERTS_OK``, ``--trace-dir``
tees request spans and exports a Chrome trace (``TRACE_OK``).
``--autoscale`` (implies ``--fleet``) closes the loop from those signals to
the replica count, between the launch count and ``--autoscale-max``.
``--fleet --soak`` runs the chaos soak: mixed-class load for
``--soak-seconds`` while one replica is killed at ~35% and restarted at
~65% (SIGKILL for ``--replica-transport proc``), then, under
``--autoscale``, an overload burst and a quiesce; it ends in ``SOAK_OK``
with every current replica bit for bit its writer. A recorded run renders
with ``python -m repro_torch.obs.dash <obs-dir>/<run-id>``:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --stats-addr 127.0.0.1:0 --obs-dir /tmp/obs --alerts --trace-dir /tmp/trace
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --soak --autoscale --alerts \\
        --smoke --soak-seconds 4 --device cpu

A script that starts ``proc`` replicas itself must do so under ``if
__name__ == "__main__":`` (they are spawned, and a spawned child imports
the main module again).

With ``--fleet``, ``--mesh`` sets the writers' ensembles' ``shard=``:
``auto`` (a 1-d chain mesh when the slots allow), ``2d`` (a chains x data
mesh) or ``off``; ``--devices N`` makes N mesh slots visible while the
fleet runs, cycling over the cards (or N times the CPU): the counterpart of
the reference's forced host devices. A sharded writer is bit for bit the
unsharded one:

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --mesh 2d --devices 4 \
        --smoke --device cpu

``--workload lm`` is the LM decoding demo: batched decoding from one
posterior sample (``--arch``, default xlstm-350m; ``--reduced``,
``--batch``, ``--prompt-len``, ``--gen-len``), randomly initialised or
restored from ``--ckpt-dir`` (a ``repro_torch.launch.train`` checkpoint). It
prints the prefill's and the decode's tokens/s. Every architecture of
``repro_torch.configs.ARCHS`` decodes; whisper-base's encoder reads frame
embeddings ``0.1 * N(0, 1)`` in bf16, (batch, 1 500, 512), drawn from a
generator seeded 2 (the reference draws them from key 2; the bits differ):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch chatglm3-6b \
        --ckpt-dir /tmp/chain
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch whisper-base \
        --reduced --device cpu

``--model-parallel N`` decodes from parameters sharded over the reference's
``make_mesh_for_devices(model_parallel=N)`` (``--devices n`` makes n slots
visible, cycling over the cards): the checkpoint is restored straight onto
the mesh's pieces, each layer is gathered on the card as it runs, and every
logit and token is the unsharded run's, bit for bit:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch chatglm3-6b \
        --ckpt-dir /tmp/chain --model-parallel 2 --devices 4
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

POSTERIOR_WORKLOADS = ("bayeslr", "stochvol", "jointdpm", "ppl")
BURST_FILLS = 40  # the soak's overload burst: at most this many fills to the shed point
MESHES = {"auto": "auto", "2d": ("chains", "data"), "off": False}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default="bayeslr", choices=POSTERIOR_WORKLOADS + ("lm",),
                    help="posterior workload to serve, or 'lm', the LM decoding demo")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: small model, >=100 queries, parity check")
    ap.add_argument("--queries", type=int, default=None,
                    help="number of requests to serve (default: 120 smoke, 400 full)")
    ap.add_argument("--rows-per-query", type=int, default=8,
                    help="request rows (test points / quantile levels) per query")
    ap.add_argument("--chains", type=int, default=None,
                    help="resident chains K (default: 4 smoke, 8 full)")
    ap.add_argument("--refresh-steps", type=int, default=None,
                    help="transitions per refresh block (default: 16 smoke, 64 full)")
    ap.add_argument("--window", type=int, default=None,
                    help="posterior draws retained per chain (default: 32 smoke, 128 full)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="requests coalesced into one evaluation")
    ap.add_argument("--micro-batch", type=int, default=64,
                    help="request rows per evaluation chunk")
    ap.add_argument("--deadline-ms", type=float, default=250.0, help="per-request latency SLO")
    ap.add_argument("--max-staleness-s", type=float, default=30.0,
                    help="freshness: oldest admissible snapshot age")
    ap.add_argument("--min-draws", type=int, default=None,
                    help="freshness: min cross-chain draws before serving "
                         "(default: chains * window / 2)")
    ap.add_argument("--background", action="store_true",
                    help="refresh on a background thread while serving "
                         "(default: refresh synchronously when stale)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the pool if a checkpoint is there, save it on exit")
    ap.add_argument("--profile-dir", default=None,
                    help="capture one torch.profiler trace of the first refresh here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    fl = ap.add_argument_group("sharded serving fleet (--fleet)")
    fl.add_argument("--fleet", action="store_true",
                    help="serve through the writer/replica fleet (repro_torch.fleet)")
    fl.add_argument("--replicas", type=int, default=2, help="read replicas per workload shard")
    fl.add_argument("--fleet-shards", type=int, default=1,
                    help="independent writer shards per workload")
    fl.add_argument("--replica-transport", default="inproc", choices=("inproc", "proc"),
                    help="replicas in this process, or one spawned OS process each")
    fl.add_argument("--mesh", default="auto", choices=tuple(MESHES),
                    help="writer ensemble sharding: 'auto' (1-d chain mesh when the slots "
                         "allow), '2d' (chains x data), 'off'")
    fl.add_argument("--devices", type=int, default=None,
                    help="make N mesh slots visible while the fleet (or --workload lm) runs, "
                         "cycling over the cards (or the CPU): the counterpart of forced "
                         "host devices")
    fl.add_argument("--max-depth", type=int, default=256,
                    help="admission: queue depth before shedding starts")
    fl.add_argument("--max-miss-rate", type=float, default=0.5,
                    help="admission: predicted deadline-miss rate threshold")
    fl.add_argument("--subposterior", type=int, default=1, metavar="P",
                    help="partition the observations into P shards, a writer group each under "
                         "the p(theta)^(1/P) tempered prior, and combine the draws at query "
                         "time (implies --fleet; P=1 is the unpartitioned fleet)")
    fl.add_argument("--combine", default="consensus", choices=("consensus", "product"),
                    help="subposterior draw combination: consensus weighted averaging or the "
                         "Gaussian density product")
    fl.add_argument("--stream", action="store_true",
                    help="mid-serve, append an observation chunk to the running writers and "
                         "show the freshness gate refuses the pre-append windows (implies "
                         "--fleet)")
    fl.add_argument("--autoscale", action="store_true",
                    help="closed-loop replica autoscaling: a control loop over the recorded "
                         "admission/SLO signals adds replicas under overload and retires them "
                         "after quiesce (fleet/soak modes; implies --fleet)")
    fl.add_argument("--autoscale-max", type=int, default=None,
                    help="autoscaler replica ceiling per workload (default: launch replicas + 2)")
    fl.add_argument("--autoscale-cooldown", type=float, default=2.0,
                    help="seconds between autoscaler actuations")
    ob = ap.add_argument_group("observability (repro_torch.obs)")
    ob.add_argument("--stats-addr", default=None, metavar="HOST:PORT",
                    help="expose the live metric rollup as JSON over HTTP (port 0 = ephemeral); "
                         "prints a STATS_OK self-check")
    ob.add_argument("--obs-dir", default=os.environ.get("REPRO_OBS_DIR"),
                    help="write per-run JSONL metric streams + summary.json under this directory "
                         "(default: $REPRO_OBS_DIR, else in memory only)")
    ob.add_argument("--alerts", action="store_true",
                    help="evaluate the standard alert ruleset (threshold / SLO burn-rate / "
                         "anomaly rules with a pending-firing-resolved state machine) over the "
                         "live rollup; transitions land on the 'alerts' stream, /alerts + "
                         "/health appear on --stats-addr, and an ALERTS_OK self-check prints "
                         "on exit")
    ob.add_argument("--soak", action="store_true",
                    help="chaos soak: sustained mixed-class load on the fleet while one replica "
                         "is killed and restarted mid-load; prints SOAK_OK with recovery "
                         "counters")
    ob.add_argument("--soak-seconds", type=float, default=None,
                    help="soak load duration (default: 6 smoke, 30 full)")
    ob.add_argument("--trace-dir", default=None,
                    help="end-to-end request tracing: tee every span to <dir>/spans.jsonl and "
                         "export a Chrome/Perfetto <dir>/trace.json on exit (prints TRACE_OK)")
    # -- LM decoding flags (only read under --workload lm) -------------------
    from ..configs import ARCHS

    lm = ap.add_argument_group("lm decoding demo (--workload lm)")
    lm.add_argument("--arch", default="xlstm-350m", choices=list(ARCHS))
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--prompt-len", type=int, default=64)
    lm.add_argument("--gen-len", type=int, default=64)
    lm.add_argument("--model-parallel", type=int, default=1)
    return ap


# ---------------------------------------------------------------------------
# The offline cross-check, float64 numpy from the snapshot's draws
# ---------------------------------------------------------------------------


def _softmax(logw: np.ndarray) -> np.ndarray:
    top = logw.max(-1, keepdims=True)
    e = np.exp(logw - top)
    return e / e.sum(-1, keepdims=True)


def _jdpm_predictive_f64(draws, xs: np.ndarray) -> np.ndarray:
    """The mixture-of-experts predictive of every draw in float64 (the NIW
    Student-t with exact lgamma), averaged over the draws: (B,)."""
    from ..experiments.jointdpm import JDPMConfig

    cfg = JDPMConfig()
    f64 = lambda a: np.asarray(a, np.float64)
    stats = draws["stats"]
    n = f64(stats[0]).reshape((-1,) + np.shape(stats[0])[2:])  # (S, K)
    sx = f64(stats[1]).reshape(n.shape + (-1,))  # (S, K, D)
    d = sx.shape[-1]
    sxx = f64(stats[2]).reshape(n.shape + (d, d))
    w = f64(draws["w"]).reshape(n.shape + (d + 1,))  # (S, K, D+1)
    x = f64(xs)  # (B, D)
    k0, v0 = cfg.niw_k0, cfg.niw_v0
    s0 = cfg.niw_s0_scale * np.eye(d)
    kn, vn = k0 + n, v0 + n
    mn = sx / kn[..., None]  # m0 = 0
    sn = s0 + sxx - kn[..., None, None] * (mn[..., :, None] * mn[..., None, :])
    df = vn - d + 1.0
    scale = sn * ((kn + 1.0) / (kn * df))[..., None, None] + 1e-6 * np.eye(d)
    chol = np.linalg.cholesky(scale)  # (S, K, D, D)
    diff = x[None, :, None, :] - mn[:, None]  # (S, B, K, D)
    sol = np.linalg.solve(chol[:, None], diff[..., None])[..., 0]
    quad = (sol * sol).sum(-1)
    logdet = 2.0 * np.log(np.diagonal(chol, axis1=-2, axis2=-1)).sum(-1)  # (S, K)
    lgamma = np.vectorize(math.lgamma)
    norm = (lgamma((df + d) / 2.0) - lgamma(df / 2.0) - 0.5 * d * (np.log(df) + np.log(np.pi))
            - 0.5 * logdet)
    feat = norm[:, None] - 0.5 * (df + d)[:, None] * np.log1p(quad / df[:, None])  # (S, B, K)
    with np.errstate(divide="ignore"):
        logw = np.where(n[:, None] > 0.5, np.log(np.maximum(n, 1e-12))[:, None] + feat, -np.inf)
    x_aug = np.concatenate([x, np.ones((x.shape[0], 1))], -1)
    p_k = 1.0 / (1.0 + np.exp(-np.einsum("bd,skd->sbk", x_aug, w)))
    return (_softmax(logw) * p_k).sum(-1).mean(0)


def _offline_reference(workload, spec, snap, xs) -> np.ndarray | None:
    """The served functional recomputed offline in float64 numpy from the
    same snapshot draws (the acceptance cross-check), for each workload's
    default class; None where no offline form is wired up."""
    from ..experiments import bayeslr

    xs = np.asarray(xs, np.float64)
    if workload.name in ("bayeslr", "ppl") and spec.name == "predictive":
        w = np.asarray(snap.draws, np.float64)
        return bayeslr.predictive_mean_prob(w.reshape(-1, w.shape[-1]), xs)[-1]
    if workload.name == "stochvol" and spec.name == "vol_quantile":
        phi = np.asarray(snap.draws["phi"], np.float64).ravel()
        s2 = np.asarray(snap.draws["sigma2"], np.float64).ravel()
        vol = np.sqrt(np.maximum(s2, 1e-12) / np.maximum(1.0 - phi ** 2, 1e-6))
        return np.quantile(vol, np.clip(xs.reshape(xs.shape[0], -1)[:, 0], 0.0, 1.0))
    if workload.name == "jointdpm" and spec.name == "cluster_predictive":
        return _jdpm_predictive_f64(snap.draws, xs)
    return None


# The reference's bound on served (float32) against offline (float64) values.
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Observability wiring (repro_torch.obs)
# ---------------------------------------------------------------------------


def _setup_obs(args, source=None):
    """Recorder + optional HTTP stats endpoint + SLO sampler + tracer for a
    serve run, or (None, None, None, None) when no observability flag is
    set."""
    if not (args.stats_addr is not None or args.obs_dir or args.soak
            or args.trace_dir or args.profile_dir or args.alerts
            or args.autoscale):
        return None, None, None, None
    from ..obs import Recorder, SLOSampler, StatsServer, Tracer

    recorder = Recorder(args.obs_dir, meta={"workload": args.workload, "argv": sys.argv[1:]})
    tracer = None
    if args.trace_dir:
        tracer = Tracer(recorder=recorder,
                        jsonl_path=os.path.join(args.trace_dir, "spans.jsonl"))
        print(f"trace: spans tee to {args.trace_dir}/spans.jsonl")
    server = None
    if args.stats_addr is not None:
        server = StatsServer(recorder, args.stats_addr, tracer=tracer)
        print(f"stats: live rollup at {server.url}")
    sampler = SLOSampler(recorder, source) if source is not None else None
    return recorder, server, sampler, tracer


def _setup_alerts(args, recorder, stats_server, workload, fleet=None):
    """AlertEngine over the run's recorder, wired into the stats endpoint
    (``/alerts`` and a component-health ``/health``), or None with
    ``--alerts`` off: the request path then never sees any of this."""
    if not args.alerts or recorder is None:
        return None
    from ..obs import default_rules, health_report
    from ..obs.alerts import AlertEngine

    rules = default_rules(args.workload, workload.default_class,
                          deadline_ms=args.deadline_ms, max_depth=args.max_depth)
    engine = AlertEngine(recorder, rules)
    if stats_server is not None:
        stats_server.alerts = engine
        stats_server.health = lambda: health_report(
            recorder.rollup(),
            fleet_report=fleet.report() if fleet is not None else None,
            alert_status=engine.status(),
            max_depth=args.max_depth if fleet is not None else None,
        )
        print(f"alerts: {len(rules)} rules over the live rollup; "
              f"/alerts and /health at {stats_server.url}")
    else:
        print(f"alerts: {len(rules)} rules over the live rollup")
    return engine


def _setup_autoscaler(args, fleet, router, recorder, engine):
    """The closed-loop actuator (``--autoscale``): scale between the launch
    replica count and ``--autoscale-max`` on the admission/SLO signals (and
    the overload alerts, when ``--alerts`` is also on)."""
    if not args.autoscale:
        return None
    from ..fleet import AutoScaleConfig, AutoScaler

    launch = fleet.replica_count(args.workload)
    ceiling = args.autoscale_max
    if ceiling is None:
        ceiling = launch + 2
    config = AutoScaleConfig(
        min_replicas=launch, max_replicas=max(ceiling, launch),
        scale_up_depth=args.max_depth, scale_down_depth=max(args.max_depth // 16, 2),
        quiesce_ticks=2, cooldown_s=args.autoscale_cooldown,
    )
    scaler = AutoScaler(fleet, router, args.workload, config, recorder=recorder, engine=engine)
    print(f"autoscale: replicas {launch}..{config.max_replicas}, "
          f"scale_up_depth={config.scale_up_depth} "
          f"scale_down_depth={config.scale_down_depth} "
          f"cooldown={config.cooldown_s}s")
    return scaler


def _get_json(url: str) -> dict:
    import json
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def _alerts_selfcheck(engine, server) -> bool:
    """The ALERTS_OK line: the engine evaluated at least once and, when an
    endpoint is up, ``/alerts`` serves its live status."""
    ok = engine.evaluations >= 1
    if server is not None:
        try:
            ok = ok and bool(_get_json(server.url.rstrip("/") + "/alerts").get("available"))
        except Exception:  # noqa: BLE001 -- an unreachable endpoint is a fail
            ok = False
    firing = ",".join(engine.firing()) or "-"
    line = "ALERTS_OK" if ok else "ALERTS_FAIL"
    print(f"{line} rules={len(engine.rules)} "
          f"evaluations={engine.evaluations} "
          f"transitions={engine.transitions} fired={engine.fired_total} "
          f"resolved={engine.resolved_total} firing={firing}")
    return ok


def _obs_num_sections(ensemble):
    """``num_sections`` of a serving ensemble's target(s), in the shape
    :func:`repro_torch.obs.record_transition_cost` wants: an int for a
    builder-constructed single target, a per-op dict for a composite
    ``cycle()`` transition, None when nothing is subsampled."""
    if ensemble.target is not None:
        return int(ensemble.target.num_sections)
    transition = getattr(ensemble, "transition", None)
    if transition is not None and hasattr(transition, "mh_ops"):
        names = transition.names
        return {names[i]: int(op.target.num_sections) for i, op in transition.mh_ops}
    return None


def _record_transition_cost(recorder, workload_name, snap, num_sections):
    from ..obs import record_transition_cost

    record_transition_cost(recorder, workload_name, snap.summary, num_sections=num_sections)


def _record_profile(recorder, args, resident) -> None:
    """Note a completed ``--profile-dir`` capture on the ``profile`` stream
    (no record when the one-shot capture never fired)."""
    if recorder is None or resident is None:
        return
    captured = getattr(resident, "last_profile_dir", None)
    if captured:
        recorder.record("profile", {"workload": args.workload, "capture_dir": captured,
                                    "tool": "torch.profiler"})
        print(f"profile: torch.profiler capture in {captured}")


def _stats_selfcheck(server) -> bool:
    """Fetch our own endpoint and print STATS_OK/STATS_FAIL: the proof that
    the rollup is reachable and carries the headline fields."""
    roll = _get_json(server.url)
    streams = roll.get("streams", {})
    slo_last = streams.get("slo", {}).get("last", {})
    snap_last = streams.get("snapshot", {}).get("last", {})
    ok = ("req_per_s" in slo_last and "p95_ms" in slo_last
          and "shed" in slo_last and "staleness_s" in snap_last)
    sublinear = ""
    try:
        sub = _get_json(server.url.rstrip("/") + "/sublinear")
        frac = sub.get("frac_data_touched", {}).get("mean") \
            if isinstance(sub.get("frac_data_touched"), dict) else None
        if frac is not None:
            sublinear = f" frac_data_touched={frac:.4f}"
    except Exception:  # noqa: BLE001 -- the sublinear view is informational
        pass
    line = "STATS_OK" if ok else "STATS_FAIL"
    print(f"{line} url={server.url} streams={sorted(streams)} "
          f"req_per_s={slo_last.get('req_per_s', float('nan')):.0f} "
          f"p95_ms={slo_last.get('p95_ms', float('nan')):.2f} "
          f"shed={slo_last.get('shed', 'n/a')} "
          f"staleness_s={snap_last.get('staleness_s', float('nan')):.3f}"
          f"{sublinear}")
    return ok


def _teardown_obs(recorder, server, tracer=None, trace_dir=None) -> None:
    if server is not None:
        server.close()
    if tracer is not None:
        if trace_dir:
            _export_trace(tracer, trace_dir)
        tracer.close()
    if recorder is not None:
        path = recorder.close()
        if path:
            print(f"obs: metric streams + summary in {recorder.dir}")


def _export_trace(tracer, trace_dir) -> None:
    """Write the Chrome/Perfetto export next to the spans tee and print the
    TRACE_OK line."""
    from ..obs.trace import export_chrome_trace

    spans = tracer.spans()
    out = export_chrome_trace(spans, os.path.join(trace_dir, "trace.json"))
    n_traces = len({s.get("trace_id") for s in spans if s.get("trace_id")})
    print(f"TRACE_OK spans={len(spans)} traces={n_traces} "
          f"dropped={tracer.dropped} export={out}")


# ---------------------------------------------------------------------------
# Posterior serving path
# ---------------------------------------------------------------------------


def serve_posterior(args, out: dict | None = None) -> int:
    """Serve ``args.queries`` requests from a warm pool and cross-check one
    batch offline; returns the exit code. ``out``, when given, receives the
    run's numbers (warm seconds, requests/s, the SLO report, staleness,
    parity error, transitions committed while serving) and, with an obs
    flag, the run directory, the final snapshot's summary, the sections it
    was taken over and the two self-checks' results."""
    from ..serving import EnsemblePool, FreshnessPolicy, RequestQueue, ServingConfig

    out = {} if out is None else out
    smoke = args.smoke
    dflt = lambda v, d: d if v is None else v
    chains = dflt(args.chains, 4 if smoke else 8)
    refresh_steps = dflt(args.refresh_steps, 16 if smoke else 64)
    window = dflt(args.window, 32 if smoke else 128)
    num_queries = dflt(args.queries, 120 if smoke else 400)
    # --min-draws 0 is meaningful (disable the draw-count freshness floor)
    min_draws = dflt(args.min_draws, max(chains * window // 2, chains))
    config = ServingConfig(
        num_chains=chains, refresh_steps=refresh_steps, window=window,
        micro_batch=args.micro_batch, max_batch=args.max_batch,
        freshness=FreshnessPolicy(max_staleness_s=args.max_staleness_s, min_draws=min_draws),
        default_deadline_s=args.deadline_ms / 1e3, seed=args.seed, device=args.device,
    )
    print(f"pool: workload={args.workload} K={chains} refresh={refresh_steps} "
          f"window={window} min_draws={min_draws} max_staleness={args.max_staleness_s}s")
    pool = EnsemblePool(config)
    resident = pool.add_workload(args.workload, smoke=smoke)
    dev = resident.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                              else ""))
    if args.profile_dir:  # one-shot: the first refresh (inside warm()) lands the capture
        resident.arm_profile(args.profile_dir)
    workload = pool.workload(args.workload)
    print(f"target: {workload.description}; request classes: {sorted(workload.query_specs)}")

    if args.ckpt_dir:
        from ..checkpoint.manager import latest_step

        if latest_step(args.ckpt_dir) is not None:
            restored = pool.restore(args.ckpt_dir)
            print(f"restored warm pool from {args.ckpt_dir} (step {restored})")

    t0 = time.perf_counter()
    pool.warm()
    sync()
    warm_s = time.perf_counter() - t0
    print(f"warm in {warm_s:.1f}s: {resident.steps_done} transitions/chain resident "
          f"({chains * resident.steps_done} total)")
    # one query per class before the measured window (first-call set-up:
    # the stream, cuBLAS handles)
    wgen = torch.Generator().manual_seed(args.seed + 2)
    for cls in sorted(workload.query_specs):
        pool.query(args.workload, cls,
                   workload.query_specs[cls].make_queries(wgen, args.rows_per_query))
    if args.background:
        pool.start()

    queue = RequestQueue(pool, max_batch=args.max_batch,
                         default_deadline_s=args.deadline_ms / 1e3)
    recorder, stats_server, sampler, tracer = _setup_obs(args, source=queue)
    queue.tracer = tracer
    engine = _setup_alerts(args, recorder, stats_server, workload)
    num_sections = _obs_num_sections(resident.ensemble)
    classes = sorted(workload.query_specs)
    qgen = torch.Generator().manual_seed(args.seed + 1)
    steps_before = resident.steps_done
    t0 = time.perf_counter()
    served = 0
    # Submit in bursts (1..max_batch) so the batcher actually coalesces.
    burst = max(2, args.max_batch // 2)
    for i in range(0, num_queries, burst):
        take = min(burst, num_queries - i)
        for j in range(take):
            cls = classes[(i + j) % len(classes)]
            queue.submit(args.workload, cls,
                         workload.query_specs[cls].make_queries(qgen, args.rows_per_query))
        served += len(queue.drain())
        if sampler is not None:
            from ..obs import record_snapshot

            sampler.sample()
            snap_now = resident.snapshot()
            record_snapshot(recorder, args.workload, snap_now)
            _record_transition_cost(recorder, args.workload, snap_now, num_sections)
            if engine is not None:
                engine.evaluate()
    wall = time.perf_counter() - t0
    steps_during = resident.steps_done - steps_before
    report = queue.slo_report()

    print(f"\nserved {served} requests ({args.rows_per_query} rows each) in {wall:.2f}s "
          f"({served / max(wall, 1e-9):.0f} req/s)")
    for cls, entry in report["classes"].items():
        if not entry.get("count"):
            print(f"  {cls:28s} ALL {entry['errors']} requests FAILED")
            continue
        print(f"  {cls:28s} p50={entry['p50_ms']:7.2f}ms p95={entry['p95_ms']:7.2f}ms "
              f"p99={entry['p99_ms']:7.2f}ms deadline_hit={entry['deadline_hit_rate']:.1%} "
              f"batch~{entry['mean_batch_size']:.1f} "
              f"staleness~{entry.get('staleness_mean_s') or float('nan'):.3f}s")
    if report["errors"]:
        print(f"  WARNING: {report['errors']} request(s) failed")
    snap_report = pool.slo_snapshot_report()[args.workload]
    print(f"  snapshot: staleness={snap_report['staleness_s']:.3f}s "
          f"draws={snap_report['num_draws']} steps_done={snap_report['steps_done']} "
          f"fresh={snap_report['fresh']}")
    if args.background:
        print(f"  background refresh: {steps_during} transitions/chain committed while "
              f"serving ({steps_during // refresh_steps} refreshes, "
              f"{chains * steps_during / max(wall, 1e-9):.1f} transitions/s summed)")

    # -- parity: a served batch of the default class against offline ------
    spec = workload.query_specs[workload.default_class]
    xs = spec.make_queries(qgen, 16)
    snap = pool.ensure_fresh(args.workload)
    served_vals, snap = pool.query(args.workload, workload.default_class, xs, snapshot=snap)
    ref = _offline_reference(workload, spec, snap, xs)
    parity, err = "n/a", None
    if ref is not None:
        err = float(np.max(np.abs(served_vals - ref)))
        if not np.allclose(served_vals, ref, **PARITY_TOL):
            print(f"PARITY FAIL: served vs offline max|delta|={err:.3g}")
            if args.background:
                pool.stop()
            _teardown_obs(recorder, stats_server, tracer, args.trace_dir)
            return 1
        parity = f"ok(max|delta|={err:.2g})"
        print(f"  parity: served {workload.default_class} == offline float64 from the same "
              f"draws ({parity})")

    if args.background:
        pool.stop()
    if args.ckpt_dir:
        path = pool.save(args.ckpt_dir)
        print(f"saved warm pool to {path}")
    out.update(warm_s=warm_s, served=served, wall_s=wall, req_per_s=served / max(wall, 1e-9),
               report=report, snapshot=snap_report, parity_max_abs=err,
               steps_during_serve=steps_during, chains=chains, refresh_steps=refresh_steps,
               pool=pool)

    stats_ok = alerts_ok = True
    if recorder is not None:
        from ..obs import record_adaptation

        snap = resident.snapshot()
        record_adaptation(recorder, args.workload, snap.summary)
        _record_transition_cost(recorder, args.workload, snap, num_sections)
        _record_profile(recorder, args, resident)
        if engine is not None:
            engine.evaluate()
            alerts_ok = _alerts_selfcheck(engine, stats_server)
        if stats_server is not None:
            stats_ok = _stats_selfcheck(stats_server)
        _teardown_obs(recorder, stats_server, tracer, args.trace_dir)
        out.update(obs_dir=recorder.dir, obs_summary=snap.summary, num_sections=num_sections,
                   stats_ok=stats_ok, alerts_ok=alerts_ok)

    first = next((e for e in report["classes"].values() if e.get("count")), None)
    if first is None or report["errors"] or not stats_ok or not alerts_ok:
        print(f"SERVE_FAIL workload={args.workload} errors={report['errors']}")
        return 1
    # new fields go after parity=, so that the line's earlier fields keep their places
    print(f"SERVE_OK workload={args.workload} queries={served} "
          f"p50_ms={first['p50_ms']:.2f} p95_ms={first['p95_ms']:.2f} "
          f"deadline_hit={first['deadline_hit_rate']:.3f} "
          f"staleness_s={snap_report['staleness_s']:.3f} parity={parity}"
          + (f" alerts_fired={engine.fired_total}" if engine is not None else ""))
    if smoke and served < 100:
        print(f"SERVE_FAIL smoke must serve >= 100 queries, served {served}")
        return 1
    return 0


# ---------------------------------------------------------------------------
# Sharded serving fleet (--fleet)
# ---------------------------------------------------------------------------


def _slot_count(args) -> int:
    """Mesh slots the writers see (the reference prints ``len(jax.devices())``)."""
    from ..distributed import visible_slots

    return len(visible_slots(args.device or "cuda"))


@contextlib.contextmanager
def _forced_slots(args):
    """``--devices N``: N mesh slots for as long as the fleet runs."""
    from ..distributed import force_devices

    with force_devices(args.devices) if args.devices else contextlib.nullcontext():
        yield


def _build_fleet(args):
    """The fleet's config, the fleet and its workload; returns (fleet,
    workload, classes)."""
    from ..fleet import Fleet, FleetConfig
    from ..serving import FreshnessPolicy, ServingConfig

    smoke = args.smoke
    dflt = lambda v, d: d if v is None else v
    chains = dflt(args.chains, 4 if smoke else 8)
    refresh_steps = dflt(args.refresh_steps, 16 if smoke else 64)
    window = dflt(args.window, 32 if smoke else 128)
    min_draws = dflt(args.min_draws, max(chains * window // 2, chains))
    config = FleetConfig(
        replicas=args.replicas, shards=args.fleet_shards, transport=args.replica_transport,
        mesh=MESHES[args.mesh], subposterior=args.subposterior,
        combine=args.combine,
        serving=ServingConfig(
            num_chains=chains, refresh_steps=refresh_steps, window=window,
            micro_batch=args.micro_batch, max_batch=args.max_batch,
            freshness=FreshnessPolicy(max_staleness_s=args.max_staleness_s,
                                      min_draws=min_draws),
            default_deadline_s=args.deadline_ms / 1e3, seed=args.seed, device=args.device,
        ),
    )
    print(f"fleet: workload={args.workload} shards={args.fleet_shards} "
          f"replicas={args.replicas}/shard transport={args.replica_transport} mesh={args.mesh} "
          f"devices={_slot_count(args)} K={chains} refresh={refresh_steps} window={window} "
          f"subposterior={args.subposterior} combine={args.combine}")
    fleet = Fleet(config)
    fleet.add_workload(args.workload, smoke=smoke, seed=args.seed)
    workload = fleet.workload(args.workload)
    classes = sorted(workload.query_specs)
    print(f"target: {workload.description}; request classes: {classes}")
    return fleet, workload, classes


def _build_router(args, fleet, workload):
    """A router over the fleet whose default class outranks the rest, so
    that under overload the others are shed first."""
    from ..fleet import AdmissionConfig, FleetRouter

    priorities = {cls: 0 for cls in sorted(workload.query_specs)}
    priorities[workload.default_class] = 1
    return FleetRouter(
        fleet, priorities=priorities,
        admission=AdmissionConfig(max_depth=args.max_depth, max_miss_rate=args.max_miss_rate),
        max_batch=args.max_batch, default_deadline_s=args.deadline_ms / 1e3,
    )


def _compile_lanes(args, fleet, workload, router=None):
    """One query of every class on every replica lane (and, partitioned, on
    the router's combined window) before the measured window: first-call
    set-up (streams, cuBLAS handles, a process replica's first evaluation)."""
    wgen = torch.Generator().manual_seed(args.seed + 2)
    for shard in fleet.shards(args.workload):
        for replica in shard.replicas:
            for cls in sorted(workload.query_specs):
                spec = workload.query_specs[cls]
                replica.serve(spec, cls, spec.make_queries(wgen, args.rows_per_query))
    if router is not None and args.subposterior > 1:
        for cls in sorted(workload.query_specs):
            spec = workload.query_specs[cls]
            router.warm_combined(args.workload, cls,
                                 spec.make_queries(wgen, args.rows_per_query))


def _stream_append(args, fleet, out: dict | None = None) -> int:
    """The ``--stream`` demo: append a bootstrap resample of the observations
    (host numpy rows, one sixteenth of the pool) to the running writers
    mid-serve, show that the append marked them stale, then pump one
    refresh and broadcast round so that serving goes on against the grown
    posterior. Returns the rows appended; ``out["stream"]``, given ``out``,
    receives the writers' sections before and after, how many read as stale
    after the append, and their steps before and after the pump."""
    from .._device import tree_map
    from ..core import spec_of

    base = fleet.workload(args.workload)
    if base.ensemble.target is None:
        raise RuntimeError(f"--stream needs a builder-constructed target; workload "
                           f"{args.workload!r} runs a composite transition")
    spec = spec_of(base.ensemble.target)
    rng = np.random.default_rng(args.seed + 7)
    n = int(spec.num_sections)
    idx = rng.integers(0, n, size=max(8, n // 16))
    chunk = tree_map(lambda a: a.detach().cpu().numpy()[idx], spec.data)
    shards = fleet.shards(args.workload)
    sections = [s.writer.ensemble.target.num_sections for s in shards]
    added = fleet.append_observations(args.workload, chunk)
    stale = [s.writer.snapshot().staleness_s for s in shards]
    grew = [s for s in stale if not np.isfinite(s)]
    steps = [s.writer.steps_done for s in shards]
    fleet.pump(args.workload)  # fold the grown targets into fresh windows
    if out is not None:
        out["stream"] = {
            "appended": added, "writers": len(shards), "stale_after_append": len(grew),
            "sections_before": sections,
            "sections_after": [s.writer.ensemble.target.num_sections for s in shards],
            "steps_before_pump": steps, "steps_after_pump": [s.writer.steps_done for s in shards]}
    print(f"STREAM_OK appended={added} rows mid-serve; {len(grew)}/{len(stale)} writer(s) "
          "marked stale by the append, refreshed without restart")
    return added


def serve_fleet(args, out: dict | None = None) -> int:
    """Serve ``args.queries`` requests through the fleet's router and hold a
    replica's answer to its writer's; returns the exit code. ``out``, when
    given, receives the run's numbers (warm seconds, requests/s, the SLO
    report, the delta stream's counters, the writers' transitions while
    serving) and the fleet and router."""
    with _forced_slots(args):
        return _serve_fleet(args, {} if out is None else out)


def _serve_fleet(args, out: dict) -> int:
    smoke = args.smoke
    dflt = lambda v, d: d if v is None else v
    num_queries = dflt(args.queries, 120 if smoke else 400)
    fleet, workload, classes = _build_fleet(args)
    shard0 = fleet.shards(args.workload)[0]
    dev = shard0.writer.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    if args.ckpt_dir:
        from ..checkpoint.manager import latest_step

        if latest_step(args.ckpt_dir) is not None:
            restored = fleet.restore(args.ckpt_dir)
            print(f"restored warm fleet from {args.ckpt_dir} (step {restored})")
    if args.profile_dir:
        shard0.writer.arm_profile(args.profile_dir)
    t0 = time.perf_counter()
    fleet.warm()
    sync()
    warm_s = time.perf_counter() - t0
    print(f"warm in {warm_s:.1f}s: writers at "
          f"{[s.writer.steps_done for s in fleet.shards(args.workload)]} transitions/chain, "
          f"replicas synced to {[r.version for r in shard0.replicas]}")

    router = _build_router(args, fleet, workload)
    recorder, stats_server, sampler, tracer = _setup_obs(args, source=router)
    router.tracer = tracer
    engine = _setup_alerts(args, recorder, stats_server, workload, fleet)
    scaler = _setup_autoscaler(args, fleet, router, recorder, engine)
    num_sections = _obs_num_sections(shard0.writer.ensemble)
    _compile_lanes(args, fleet, workload, router)
    if args.background:
        fleet.start()
        router.start_workers()

    writers = [s.writer for s in fleet.shards(args.workload)]
    steps_before = [w.steps_done for w in writers]
    qgen = torch.Generator().manual_seed(args.seed + 1)
    burst = max(2, args.max_batch // 2)
    t0 = time.perf_counter()
    served = stream_rows = 0
    streamed = False
    pending = []
    for i in range(0, num_queries, burst):
        take = min(burst, num_queries - i)
        for j in range(take):
            cls = classes[(i + j) % len(classes)]
            xs = workload.query_specs[cls].make_queries(qgen, args.rows_per_query)
            pending.append(router.submit(args.workload, cls, xs))
        if args.background:
            # done.wait, not result(): a shed or failed request paces the
            # bursts instead of ending them (shedding is a feature here)
            pending[-1].done.wait(timeout=60.0)
        else:
            served += len(router.drain())
            if (i // burst) % 8 == 7:
                fleet.pump(args.workload)  # fresh deltas mid-serve
        if args.stream and not streamed and i + burst >= num_queries // 2:
            stream_rows = _stream_append(args, fleet, out)
            streamed = True
        if sampler is not None and (i // burst) % 4 == 3:
            from ..obs import record_fleet_sync

            sampler.sample()
            record_fleet_sync(recorder, fleet)
            _record_transition_cost(recorder, args.workload, shard0.writer.snapshot(),
                                    num_sections)
            if engine is not None:
                engine.evaluate()
            if scaler is not None:
                scaler.tick()
    if args.background:
        for req in pending:
            req.done.wait(timeout=60.0)
        # a shed request completes at once with error "shed: ...": not served
        served = len([r for r in pending
                      if r.done.is_set() and not (r.error or "").startswith("shed")])
    wall = time.perf_counter() - t0
    steps_during = [w.steps_done - b for w, b in zip(writers, steps_before)]
    stats_ok = alerts_ok = True
    if sampler is not None:
        from ..obs import record_adaptation, record_fleet_sync, record_snapshot

        sampler.sample()
        record_fleet_sync(recorder, fleet)
        snap = shard0.writer.snapshot()
        record_snapshot(recorder, args.workload, snap)
        record_adaptation(recorder, args.workload, snap.summary)
        _record_transition_cost(recorder, args.workload, snap, num_sections)
        _record_profile(recorder, args, shard0.writer)
        if engine is not None:
            engine.evaluate()
            alerts_ok = _alerts_selfcheck(engine, stats_server)
        if stats_server is not None:
            stats_ok = _stats_selfcheck(stats_server)
    report = router.slo_report()

    print(f"\nserved {served} requests ({args.rows_per_query} rows each) in {wall:.2f}s "
          f"({served / max(wall, 1e-9):.0f} req/s) across "
          f"{args.fleet_shards * args.replicas} replica lane(s)")
    for cls, entry in report["classes"].items():
        if not entry.get("count"):
            print(f"  {cls:28s} admitted={entry.get('admitted', 0)} "
                  f"shed={entry.get('shed', 0)} (nothing served)")
            continue
        print(f"  {cls:28s} p50={entry['p50_ms']:7.2f}ms p95={entry['p95_ms']:7.2f}ms "
              f"p99={entry['p99_ms']:7.2f}ms deadline_hit={entry['deadline_hit_rate']:.1%} "
              f"prio={entry['priority']} admitted={entry['admitted']} shed={entry['shed']} "
              f"staleness~{entry.get('staleness_mean_s') or float('nan'):.3f}s")
    adm = report["admission"]
    print(f"  admission: depth={adm['depth']} predicted_miss={adm['predicted_miss_rate']:.3f} "
          f"shed_floor={adm['shed_floor']} total_shed={report['shed']}")
    stats = dict(fleet.sync_stats)
    ratio = stats["delta_wire_bytes"] / max(stats["full_wire_bytes"], 1)
    print(f"  delta stream: {stats['syncs']} syncs, {stats['delta_wire_bytes']} delta bytes vs "
          f"{stats['full_wire_bytes']} full-snapshot bytes ({ratio:.2f}x)")
    if args.background:
        k = fleet.config.serving.num_chains
        print(f"  background refresh: {steps_during} transitions/chain committed per writer "
              f"while serving ({k * sum(steps_during) / max(wall, 1e-9):.1f} transitions/s "
              "summed)")
        router.stop_workers()
        fleet.stop()

    # -- parity: a replica's answer against its writer's from the same version
    fleet.sync_all()  # the replicas now mirror the writers exactly
    spec = workload.query_specs[workload.default_class]
    xs = spec.make_queries(qgen, 16)
    w_vals, w_snap = shard0.writer.query(spec, xs)
    r_vals, _ = shard0.replicas[0].serve(spec, workload.default_class, xs)
    err = float(np.max(np.abs(np.asarray(w_vals) - np.asarray(r_vals)))) if len(xs) else 0.0
    out.update(warm_s=warm_s, served=served, wall_s=wall, req_per_s=served / max(wall, 1e-9),
               report=report, sync=stats, delta_ratio=ratio, steps_during_serve=steps_during,
               parity_max_abs=err, fleet=fleet, router=router)
    if not np.array_equal(np.asarray(w_vals), np.asarray(r_vals)):
        print(f"PARITY FAIL: replica vs writer max|delta|={err:.3g} (writer "
              f"v{w_snap.steps_done}, replica v{shard0.replicas[0].version})")
        _teardown_obs(recorder, stats_server, tracer, args.trace_dir)
        fleet.close()
        return 1
    parity = "ok(bitexact)"
    print(f"  parity: replica {workload.default_class} == writer from the same delta-streamed "
          f"window ({parity})")

    if args.ckpt_dir:
        path = fleet.save(args.ckpt_dir)
        print(f"saved warm fleet to {path}")
    _teardown_obs(recorder, stats_server, tracer, args.trace_dir)
    fleet.close()

    first = next((e for e in report["classes"].values() if e.get("count")), None)
    if (first is None or report["errors"] or (smoke and served < 100)
            or not stats_ok or not alerts_ok):
        # the smoke floor gates before SERVE_OK: a failed smoke never prints it
        print(f"SERVE_FAIL workload={args.workload} fleet=1 errors={report['errors']} "
              f"served={served}")
        return 1
    print(f"SERVE_OK workload={args.workload} fleet=1 shards={args.fleet_shards} "
          f"replicas={args.replicas} queries={served} p50_ms={first['p50_ms']:.2f} "
          f"p95_ms={first['p95_ms']:.2f} deadline_hit={first['deadline_hit_rate']:.3f} "
          f"shed={report['shed']} delta_ratio={ratio:.2f} parity={parity} "
          f"subposterior={args.subposterior} combine={args.combine} "
          f"devices={_slot_count(args)}"
          + (f" stream_rows={stream_rows}" if args.stream else "")
          + (f" alerts_fired={engine.fired_total}" if engine is not None else "")
          + (f" scale_up={scaler.events['scale_up']} scale_down={scaler.events['scale_down']}"
             if scaler is not None else ""))
    return 0


# ---------------------------------------------------------------------------
# Chaos soak (--soak)
# ---------------------------------------------------------------------------


def serve_soak(args, out: dict | None = None) -> int:
    """Sustained mixed-class load against the multi-replica fleet while one
    replica is killed mid-load (SIGKILL for a process replica) and later
    restarted: the router reroutes around the dead lane without dropping
    top-class requests, and the revived replica full-resyncs to bit-exact
    parity with the warm writer. Under ``--autoscale``, a closed-loop
    overload burst follows (shed floor -> alert -> scale-up), then a quiesce
    that retires what the scaler added. Prints ``SOAK_OK``/``SOAK_FAIL``
    with the recovery counters; ``out``, when given, receives the run's
    numbers (served, wall seconds, the SLO report, resyncs, the scaler's
    events, the alerts fired, post-chaos parity and the replicas left)."""
    with _forced_slots(args):
        return _serve_soak(args, {} if out is None else out)


def _serve_soak(args, out: dict) -> int:
    from ..obs import record_fleet_sync, record_snapshot

    smoke = args.smoke
    soak_s = args.soak_seconds or (6.0 if smoke else 30.0)
    # Killing a replica must leave a live lane in its shard.
    args.replicas = max(args.replicas, 2)
    fleet, workload, classes = _build_fleet(args)
    if args.profile_dir:
        fleet.shards(args.workload)[0].writer.arm_profile(args.profile_dir)
    fleet.warm()
    shard0 = fleet.shards(args.workload)[0]
    victim = shard0.replicas[-1]
    router = _build_router(args, fleet, workload)
    recorder, stats_server, sampler, tracer = _setup_obs(args, source=router)
    router.tracer = tracer
    engine = _setup_alerts(args, recorder, stats_server, workload, fleet)
    scaler = _setup_autoscaler(args, fleet, router, recorder, engine)
    num_sections = _obs_num_sections(shard0.writer.ensemble)
    _compile_lanes(args, fleet, workload)
    top = workload.default_class
    print(f"soak: {soak_s:.0f}s mixed-class load ({', '.join(classes)}; top class {top!r}), "
          f"kill {victim.name} at ~35%, restart at ~65%")

    fleet.start()  # background refresh + delta sync
    router.start_workers()  # one worker thread per replica lane

    t0 = time.perf_counter()
    end = t0 + soak_s
    kill_at = t0 + 0.35 * soak_s
    recover_at = t0 + 0.65 * soak_s
    killed = recovered = False
    full_before = 0
    pending: list = []
    # query rows from a generator seeded seed + 1, where the reference splits key(seed + 1)
    qgen = torch.Generator().manual_seed(args.seed + 1)
    i = 0
    last_sample = t0
    while True:
        now = time.perf_counter()
        if now >= end and recovered:
            break
        if not killed and now >= kill_at:
            recorder.record("chaos", {"event": "kill", "replica": victim.name})
            victim.kill()
            killed = True
            print(f"chaos: killed {victim.name} at t+{now - t0:.1f}s "
                  f"(pending={router.pending_count})")
        if killed and not recovered and now >= recover_at and (
                router.dead_lanes >= 1 or now >= end):
            full_before = fleet.sync_stats["full_deltas"]
            victim.restart()
            fleet.sync_shard(fleet.shards(args.workload)[0])  # version 0 -> full resync
            revived = router.revive()
            recovered = True
            recorder.record("chaos", {"event": "restart", "replica": victim.name,
                                      "revived_lanes": revived,
                                      "replica_version": victim.version})
            print(f"chaos: restarted {victim.name} at t+{now - t0:.1f}s "
                  f"(revived {revived} lane(s), replica v{victim.version})")
        if router.pending_count > 4 * args.max_depth:
            time.sleep(0.01)  # backpressure: let the lane workers catch up
        else:
            cls = classes[i % len(classes)]
            xs = workload.query_specs[cls].make_queries(qgen, args.rows_per_query)
            pending.append(router.submit(args.workload, cls, xs))
            i += 1
            if i % 8 == 0:
                time.sleep(0.002)  # yield to the worker threads
        if sampler is not None and now - last_sample >= max(soak_s / 12, 0.25):
            sampler.sample()
            record_fleet_sync(recorder, fleet)
            snap_now = shard0.writer.snapshot()
            record_snapshot(recorder, args.workload, snap_now)
            _record_transition_cost(recorder, args.workload, snap_now, num_sections)
            if engine is not None:
                engine.evaluate()
            # The scaler does not tick during the kill/restart window: the
            # burst below is the deterministic scale-up-under-pressure /
            # scale-down-after-quiesce proof, and an actuation mid-chaos
            # would spend the replica headroom first.
            last_sample = now

    # -- closed-loop overload burst (--autoscale) --------------------------
    # Drive submissions past the admission shed point and hold them there
    # until the loop closes: the sampler records the active shed floor, the
    # admission_overload rule fires, and the scaler actuates a scale-up.
    # The floor stands only while the backlog is at the shed point, and on a
    # fast card the lanes drain as fast as this thread submits, each popping
    # a batch the moment it runs: the sample would read a depth already
    # below the point, and the overload alert the loop waits for would not
    # fire. So the lanes' workers are stopped while a fill builds the
    # backlog and the probe, the sample and the scaler read it (a stall the
    # lanes cannot serve through), then started again. At most BURST_FILLS
    # fills are made; a loop that has not closed by then leaves SOAK_OK's
    # checks to say what is missing.
    burst_submitted = burst_shed = 0
    if scaler is not None:
        low = next((c for c in classes if c != top), top)
        up_before = scaler.events["scale_up"]
        fired_before = engine.fired_total if engine is not None else 0
        overload = set(scaler.config.overload_alerts)
        # The loop has closed once a scale-up has followed an overload alert.
        # An overload alert that the saturated load above already fired, and
        # that is still firing, counts: the reference waits for a new fire,
        # which then never comes.
        burst_done = lambda: (scaler.events["scale_up"] > up_before  # noqa: E731
                              and (engine is None or engine.fired_total > fired_before
                                   or bool(overload & set(engine.firing()))))
        burst_deadline = time.perf_counter() + 60.0
        fills, reasons = 0, []
        while (not burst_done() and fills < BURST_FILLS
               and time.perf_counter() < burst_deadline):
            router.stop_workers()
            try:
                while router.pending_count < args.max_depth + 8:
                    xs = workload.query_specs[top].make_queries(qgen, args.rows_per_query)
                    pending.append(router.submit(args.workload, top, xs))
                    burst_submitted += 1
                fills += 1
                # With the floor up, a low-class submission is refused: the
                # shed that proves the overload point was actually crossed.
                shed_probe = router.submit(
                    args.workload, low,
                    workload.query_specs[low].make_queries(qgen, args.rows_per_query))
                burst_shed += int((shed_probe.error or "").startswith("shed"))
                if sampler is not None:
                    sampler.sample()
                if engine is not None:
                    engine.evaluate()
                decision = scaler.tick()
            finally:
                router.start_workers()
            if decision["action"] == "scale_up":
                reasons.append(decision["reason"])
            time.sleep(0.05)
        print(f"chaos: overload burst submitted {burst_submitted} top-class "
              f"requests in {fills} fills (depth {router.pending_count}), {burst_shed} "
              f"low-class shed, scale_up={scaler.events['scale_up']} "
              f"(on {'; '.join(reasons) or 'nothing'}), alerts fired in the burst "
              f"{(engine.fired_total - fired_before) if engine is not None else 0}")
        out["burst_fills"] = fills

    for req in pending:
        req.done.wait(timeout=120.0)

    # -- quiesce: the backlog is drained; tick the scaler until it has
    # retired every replica it added (calm depth -> scale-down events).
    # Each tick also submits a calm trickle of top-class requests (one burst
    # of the front end's size): the router predicts deadline misses from its
    # last completions, and with no traffic at all a saturated load's missed
    # tail would hold the shed floor, and the overload alert, up for good.
    if scaler is not None:
        scaler.observe()  # absorb the burst's shed counters: not fresh pressure
        quiesce_deadline = time.perf_counter() + 60.0
        trickle = max(2, args.max_batch // 2)
        while scaler.outstanding and time.perf_counter() < quiesce_deadline:
            if sampler is not None:
                sampler.sample()
            if engine is not None:
                engine.evaluate()
            scaler.tick()
            for _ in range(trickle):
                xs = workload.query_specs[top].make_queries(qgen, args.rows_per_query)
                pending.append(router.submit(args.workload, top, xs))
            time.sleep(max(args.autoscale_cooldown / 4, 0.05))
        for req in pending:
            req.done.wait(timeout=120.0)
        print(f"chaos: quiesce done, scale_down={scaler.events['scale_down']} "
              f"replicas={fleet.replica_count(args.workload)}")
    wall = time.perf_counter() - t0
    stats_ok = alerts_ok = True
    if sampler is not None:
        sampler.sample()
        record_fleet_sync(recorder, fleet)
        snap_final = shard0.writer.snapshot()
        record_snapshot(recorder, args.workload, snap_final)
        _record_transition_cost(recorder, args.workload, snap_final, num_sections)
        _record_profile(recorder, args, shard0.writer)
        if engine is not None:
            engine.evaluate()
            alerts_ok = _alerts_selfcheck(engine, stats_server)
        if stats_server is not None:
            stats_ok = _stats_selfcheck(stats_server)
    report = router.slo_report()
    router.stop_workers()
    fleet.stop()

    # -- post-chaos parity: every current replica (the revived victim and
    # any autoscaler survivors) against the warm writer, bit for bit ------
    fleet.sync_all()
    resyncs = fleet.sync_stats["full_deltas"] - full_before
    spec = workload.query_specs[top]
    xs = spec.make_queries(qgen, 16)
    # Re-read shard0: runtime add/remove_replica swapped the shard entry,
    # so the launch-time NamedTuple's replica tuple is stale.
    shard0 = fleet.shards(args.workload)[0]
    w_vals, w_snap = shard0.writer.query(spec, xs)
    parity_bad = []
    for replica in shard0.replicas:
        r_vals, _ = replica.serve(spec, top, xs)
        if not np.array_equal(np.asarray(w_vals), np.asarray(r_vals)):
            err = float(np.max(np.abs(np.asarray(w_vals) - np.asarray(r_vals))))
            parity_bad.append(f"{replica.name} max|delta|={err:.3g} v{replica.version}")
    parity_ok = not parity_bad

    served = len([r for r in pending
                  if r.done.is_set() and not (r.error or "").startswith("shed")])
    recovery = report["recovery"]
    top_entry = report["classes"].get(f"{args.workload}.{top}", {})
    top_reqs = [r for r in pending if r.query_class == top]
    dropped = [r for r in top_reqs if not r.done.is_set()]
    print(f"\nsoak: {served} served / {len(pending)} submitted in {wall:.1f}s "
          f"({served / max(wall, 1e-9):.0f} req/s), shed={report['shed']}, "
          f"lane_deaths={recovery['lane_deaths']}, rerouted={recovery['rerouted']}, "
          f"dead_lanes={recovery['dead_lanes']}, resyncs={resyncs}")
    out.update(served=served, submitted=len(pending), wall_s=wall,
               req_per_s=served / max(wall, 1e-9), report=report, resyncs=resyncs,
               burst_submitted=burst_submitted, burst_shed=burst_shed,
               scaler_events=None if scaler is None else dict(scaler.events),
               alerts_fired=None if engine is None else engine.fired_total,
               parity_ok=parity_ok, replicas=[r.name for r in shard0.replicas])

    failures = []
    if not top_entry.get("count"):
        failures.append(f"no completed top-class ({top!r}) requests in report")
    if not killed or not recovered:
        failures.append("kill/restart never fired (soak too short?)")
    if recovery["lane_deaths"] < 1:
        failures.append("victim lane never died under load")
    if recovery["dead_lanes"]:
        failures.append(f"{recovery['dead_lanes']} lane(s) still dead after revive")
    if dropped:
        failures.append(f"{len(dropped)} top-class request(s) never completed")
    if top_entry.get("errors", 0):
        failures.append(f"top-class errors={top_entry['errors']}")
    if top_entry.get("shed", 0):
        failures.append(f"top-class shed={top_entry['shed']}")
    if resyncs < 1:
        failures.append("restarted replica never full-resynced")
    if not parity_ok:
        failures.append(f"parity vs writer v{w_snap.steps_done}: " + "; ".join(parity_bad))
    if not stats_ok:
        failures.append("stats endpoint self-check failed")
    if not alerts_ok:
        failures.append("alert engine self-check failed")
    if scaler is not None:
        if scaler.events["scale_up"] < 1:
            failures.append("autoscaler never scaled up under overload")
        if scaler.events["scale_down"] < 1:
            failures.append("autoscaler never scaled down after quiesce")
        if burst_shed < 1:
            failures.append("overload burst never crossed the shed point")
        if engine is not None and engine.fired_total < 1:
            failures.append("no alert fired during the overload burst")

    _teardown_obs(recorder, stats_server, tracer, args.trace_dir)
    fleet.close()
    if failures:
        print(f"SOAK_FAIL workload={args.workload} " + "; ".join(failures))
        return 1
    # new fields go after parity=, so that the line's earlier fields keep their places
    print(f"SOAK_OK workload={args.workload} soak_s={wall:.1f} "
          f"served={served} kills=1 recovered=1 resyncs={resyncs} "
          f"reroutes={recovery['rerouted']} "
          f"lane_deaths={recovery['lane_deaths']} shed={report['shed']} "
          f"top_class_errors=0 "
          f"p95_ms={top_entry.get('p95_ms') or float('nan'):.2f} "
          f"parity=ok(bitexact)"
          + (f" alerts_fired={engine.fired_total}" if engine is not None else "")
          + (f" scale_up={scaler.events['scale_up']} scale_down={scaler.events['scale_down']}"
             if scaler is not None else ""))
    return 0


# ---------------------------------------------------------------------------
# LM decoding demo (--workload lm)
# ---------------------------------------------------------------------------


def serve_lm(args, out: dict | None = None) -> int:
    """Batched decoding from one posterior sample: the parameters of
    ``--ckpt-dir`` (or random ones from seed 0) of ``--arch``, decoded by
    :func:`decode_lm`, on the mesh of ``--model-parallel`` (sharded when it
    has more than one slot; ``--devices`` forces the slots). ``out``, when
    given, receives what ``decode_lm`` leaves there."""
    from ..distributed import force_devices

    with force_devices(args.devices) if args.devices else contextlib.nullcontext():
        return _serve_lm(args, out)


def _serve_lm(args, out: dict | None) -> int:
    from .._device import resolve_device, tree_map
    from ..checkpoint import manager as ckpt
    from ..configs import ARCHS, reduce_config
    from ..distributed.sharding import logical_axis_rules
    from ..models import init_params, param_specs
    from .mesh import make_mesh_for_devices
    from .steps import spec_tree_to_shardings
    from .train import init_sharded_params

    device = resolve_device(args.device)
    mesh = make_mesh_for_devices(model_parallel=args.model_parallel, device=device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sharded = mesh.size > 1
    if args.ckpt_dir:
        # the checkpoint's leaves replace every initial one: a target that
        # names them and their device, with nothing drawn; on a mesh each
        # leaf's pieces are read from the file straight onto their slots
        specs = param_specs(cfg)
        target = tree_map(lambda _: torch.empty(0, device=device), specs)
        shardings = spec_tree_to_shardings(specs, mesh) if sharded else None
        _, params = ckpt.restore(args.ckpt_dir, target=target, shardings=shardings)
        print(f"restored posterior sample from {args.ckpt_dir}")
    elif sharded:
        params = init_sharded_params(0, cfg, mesh, device=device)
    else:
        params = init_params(0, cfg, device=device)
    with logical_axis_rules(mesh):
        return decode_lm(params, cfg, batch=args.batch, prompt_len=args.prompt_len,
                         gen_len=args.gen_len, out=out)


def decode_lm(params: dict, cfg, *, batch: int, prompt_len: int, gen_len: int,
              out: dict | None = None) -> int:
    """The body of ``serve_lm`` on given parameters and config: prompts of
    ``prompt_len`` tokens from a generator seeded 1 (and, for the audio
    family, frames from one seeded 2), a prefill into a cache of
    ``prompt_len + gen_len + 8`` positions, then ``gen_len`` decode steps,
    the first token the prefill's argmax and each later one sampled from the
    logits (Gumbel-max, as ``jax.random.categorical`` draws) by a generator
    seeded 3. Prints the two rates. ``out``, when given, receives the
    parameters, the config, the prompts, the extra inputs, the prefill's
    cache and logits, every generated token (``tokens``, (batch, gen_len)),
    the times, tokens/s and the peak device memory. Sharded parameters
    decode on their home device."""
    from .._device import make_generator, tree_leaves
    from ..models import decode_step, prefill

    out = {} if out is None else out
    device = tree_leaves(params)[0].device
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), dtype=torch.int32,
                            device=device, generator=make_generator(1, device))
    extra = None
    if cfg.family == "audio":
        extra = {"frames": 0.1 * torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                             generator=make_generator(2, device),
                                             dtype=torch.bfloat16, device=device)}
    max_len = prompt_len + gen_len + 8

    sync()
    t0 = time.perf_counter()
    cache, logits = prefill(params, prompts, cfg, max_len, extra)
    sync()
    t_pre = time.perf_counter() - t0
    out.update(params=params, cfg=cfg, prompts=prompts, extra=extra, max_len=max_len,
               cache0=cache, prefill_logits=logits)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    gen = make_generator(3, device)
    toks = []
    t0 = time.perf_counter()
    for _ in range(gen_len):
        cache, logits = decode_step(params, cache, tok, cfg)
        u = torch.rand(logits.shape, generator=gen, device=device).clamp_min(1e-20)
        tok = torch.argmax(logits - torch.log(-torch.log(u)), -1)[:, None].to(torch.int32)
        toks.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    out.update(prefill_s=t_pre, decode_s=t_dec,
               prefill_tok_s=batch * prompt_len / t_pre,
               decode_tok_s=batch * gen_len / t_dec,
               decode_step_ms=1e3 * t_dec / max(gen_len, 1), last_tokens=tok,
               tokens=torch.cat(toks, dim=1) if toks else tok[:, :0],
               peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None)
    print(f"prefill {batch}x{prompt_len}: {t_pre:.2f}s "
          f"({batch * prompt_len / t_pre:.0f} tok/s)")
    print(f"decode {gen_len} steps: {t_dec:.2f}s "
          f"({batch * gen_len / t_dec:.0f} tok/s)")
    return 0


_LM_ONLY_FLAGS = ("arch", "reduced", "batch", "prompt_len", "gen_len", "model_parallel")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    lm = args.workload == "lm"
    if args.fleet and lm:
        parser.error("--fleet serves posterior workloads, not the lm demo")
    if args.subposterior > 1 or args.stream:
        if lm:
            parser.error("--subposterior/--stream serve posterior workloads through the fleet, "
                         "not the lm demo")
        args.fleet = True  # both modes live on the fleet's serve path
    if args.autoscale:
        if lm:
            parser.error("--autoscale scales the replica fleet, not the lm demo")
        args.fleet = True  # the actuator needs replica lanes to scale
    if args.alerts and lm:
        parser.error("--alerts applies to posterior serving, not the lm demo")
    if not lm:
        # the LM flags must not be silently ignored by posterior serving
        drifted = [f"--{name.replace('_', '-')}" for name in _LM_ONLY_FLAGS
                   if getattr(args, name) != parser.get_default(name)]
        if drifted:
            parser.error(f"{', '.join(drifted)} only apply to the LM decoding demo; "
                         "add --workload lm (posterior serving ignores them)")
    if args.soak and (lm or not args.fleet):
        parser.error("--soak drives the replica fleet: add --fleet (and a posterior --workload)")
    if lm:
        return serve_lm(args)
    if args.soak:
        return serve_soak(args)
    if args.fleet:
        return serve_fleet(args)
    return serve_posterior(args)


if __name__ == "__main__":
    sys.exit(main())
