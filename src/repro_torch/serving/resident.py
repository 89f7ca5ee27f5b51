"""Resident posterior ensembles: warm sampler state behind a query API, the
port of ``repro.serving.resident``.

A :class:`ResidentEnsemble` keeps a
:class:`repro_torch.core.ensemble.ChainEnsemble` alive across requests
(per-chain sampler state and, when scheduled, controller state stay on the
device) and interleaves

  * **refresh**: advance every chain a block of transitions on the
    resident's own ``torch.Generator`` and append the collected draws to a
    rolling per-chain window. The generator carries the schedule: refreshes
    continue its stream, so chunked refreshes reproduce one offline
    ``ensemble.run`` of the same total steps on a generator with the same
    seed, bit for bit, wherever chunking does not move the draws (see
    :mod:`repro_torch.core.ensemble`: lock-step with either sampler, masked
    with the ``stream`` sampler);
  * **snapshot**: the current cross-chain window plus
    :func:`repro_torch.core.stats.ensemble_summary` diagnostics and a
    staleness clock, the unit the freshness policy in
    :mod:`repro_torch.serving.pool` admits or refuses;
  * **query**: a posterior functional (a :class:`QuerySpec`) over every
    snapshot draw, micro-batched over request rows at one fixed shape.

The window lives on the host as numpy arrays (K, W, ...), as in the
reference; the evaluator keeps one device copy of the flattened (S, ...)
window per snapshot generation, and on the card evaluates on a CUDA stream
of its own, so a query does not queue behind a background refresh's kernels.
Background refresh runs on a daemon thread (:meth:`start_background`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .._device import make_generator, resolve_device, tree_leaves, tree_map
from ..checkpoint.manager import _flatten
from ..core.ensemble import ChainEnsemble, EnsembleState
from ..core.stats import ensemble_summary

Params = Any


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One posterior-functional request class.

    ``fn(draws, xs) -> (S, B)`` scores every posterior draw on B request
    rows at once: ``draws`` is the snapshot's window flattened to (S, ...)
    leaves (S = chains x window depth) on the evaluator's device, ``xs`` the
    (B, ...) rows as a float32 tensor there. (The reference's ``fn`` scores
    one draw and is vmapped; here it is a plain function on the whole batch
    of draws.) The resident aggregates over the draw axis:

      * ``aggregate="mean"``: the posterior mean of ``fn`` per row, e.g.
        BayesLR predictive probabilities ``E[sigmoid(x.w)]``;
      * ``aggregate="quantile"``: per-row posterior quantiles, where
        ``xs[b]`` is the quantile level for row ``b``, e.g. stochvol
        stationary-volatility quantiles (``fn`` then typically broadcasts a
        per-draw statistic to (S, B)).

    ``make_queries(gen, rows) -> xs`` draws representative request inputs
    from a CPU ``torch.Generator`` (the serve front end, benches, tests).
    """

    fn: Callable[[Params, torch.Tensor], torch.Tensor]
    aggregate: str = "mean"  # "mean" | "quantile"
    make_queries: Callable[[torch.Generator, int], np.ndarray] | None = None
    name: str = ""

    def __post_init__(self):
        if self.aggregate not in ("mean", "quantile"):
            raise ValueError(f"unknown aggregate {self.aggregate!r}")


class Snapshot(NamedTuple):
    """An immutable view of a resident ensemble's posterior window."""

    draws: Params  # tree of host numpy arrays, leaves (K, W, ...)
    num_draws: int  # K * W
    steps_done: int  # transitions committed per chain since init/restore
    staleness_s: float  # age of the newest draw at snapshot time
    summary: dict  # ensemble_summary of the last refresh's infos
    created_at: float  # time.monotonic() at construction


def _host(leaf):
    """A state or sample leaf as a host numpy array (ints stay numbers)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _clone(leaf):
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def _summarize_infos(infos) -> dict:
    """ensemble_summary over plain or composite (dict-keyed) infos."""
    if infos is None:
        return {}
    if hasattr(infos, "accepted"):
        return ensemble_summary(infos)
    if isinstance(infos, dict):
        return {name: ensemble_summary(v) for name, v in infos.items() if hasattr(v, "accepted")}
    return {}


def _window_append(window, block, limit: int):
    """Append a (K, n, ...) block to the (K, W, ...) host window, keep the
    last ``limit`` draws per chain."""
    block = tree_map(_host, block)
    merged = block if window is None else tree_map(
        lambda a, b: np.concatenate([a, b], axis=1), window, block)
    return tree_map(lambda a: a[:, -limit:], merged)


def _rebuild(like, flat: dict, put: Callable, prefix: str = ""):
    """``like``'s nesting with each leaf ``put(flat[name], like_leaf)``,
    names as :func:`repro_torch.checkpoint.manager._flatten` gives them."""
    join = lambda k: f"{prefix}__{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, put, join(k)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        kids = [_rebuild(v, flat, put, join(i)) for i, v in enumerate(like)]
        return type(like)(*kids) if hasattr(like, "_fields") else type(like)(kids)
    return put(flat[prefix], like)


def quantile_per_row(per_draw: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Column b's ``levels[b]`` quantile of (S, B) draws, with linear
    interpolation in the reference's order of operations (``jnp.quantile``:
    q = level * (S - 1), the floor and ceil order statistics weighted by
    1 - (q - floor q) and q - floor q; a column holding a NaN gives NaN).
    ``torch.quantile`` would apply every level to every column."""
    s = per_draw.shape[0]
    srt = torch.sort(per_draw, dim=0).values
    srt = torch.where(torch.isnan(per_draw).any(0, keepdim=True),
                      torch.full_like(srt, float("nan")), srt)
    q = levels * float(s - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    low = low.clamp(0, s - 1).long()
    high = high.clamp(0, s - 1).long()
    low_v = srt.gather(0, low[None]).squeeze(0)
    high_v = srt.gather(0, high[None]).squeeze(0)
    return low_v * low_w + high_v * high_w


class SnapshotEvaluator:
    """Micro-batched posterior-functional evaluation against snapshots.

    Keeps a per-snapshot-generation device copy of the flattened (S, ...)
    window, so a batch of queries against one snapshot uploads the draws
    once. Rows go through in fixed ``micro_batch``-row chunks (the last one
    padded by repeating its last row), so the evaluation shape never
    depends on the request batch, and both reductions over the draw axis are
    column by column: a request served inside a batch returns exactly what
    it returns alone. On the card the evaluation runs on its own CUDA
    stream, and the result's copy to the host waits on that stream only.
    """

    def __init__(self, micro_batch: int = 64, device=None):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        self.micro_batch = int(micro_batch)
        self.device = resolve_device(device)
        self._flat_cache: tuple[Any, Any] | None = None
        self._stream = None

    def invalidate(self) -> None:
        """Drop the device-side window cache (call when the window is
        replaced out of band, e.g. on checkpoint restore: a stale cache could
        otherwise collide on the generation key)."""
        self._flat_cache = None

    def _stream_ctx(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _reduce(self, spec: QuerySpec, flat, x: torch.Tensor) -> torch.Tensor:
        per_draw = spec.fn(flat, x)  # (S, mb)
        if spec.aggregate == "mean":
            return per_draw.mean(dim=0)
        levels = x.reshape(x.shape[0], -1)[:, 0].clamp(0.0, 1.0).to(per_draw.dtype)
        return quantile_per_row(per_draw, levels)

    def evaluate(self, spec: QuerySpec, snap: Snapshot, xs,
                 span_sink: list | None = None) -> np.ndarray:
        """Evaluate ``spec`` over every draw of ``snap`` on request rows
        ``xs``; returns the aggregated (B,) values as float64.

        ``span_sink``, when given, receives one raw ``device_eval`` trace
        span (a plain dict) covering the window upload and every
        micro-batched evaluation."""
        t_open = time.monotonic()
        xs = np.asarray(xs)
        if xs.ndim == 0:
            xs = xs[None]
        if xs.shape[0] == 0:
            return np.zeros((0,), np.float64)
        dev, b, mb = self.device, xs.shape[0], self.micro_batch
        vals = []
        with self._stream_ctx():
            gen = (snap.steps_done, snap.num_draws)
            cached = self._flat_cache
            if cached is not None and cached[0] == gen:
                flat = cached[1]
            else:  # (S, ...) with S = K * W, copied (a restored window is read-only)
                flat = tree_map(lambda a: torch.from_numpy(
                    np.array(a.reshape((-1,) + a.shape[2:]))).to(dev), snap.draws)
                self._flat_cache = (gen, flat)
            for start in range(0, b, mb):
                chunk = xs[start:start + mb]
                pad = mb - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                x = torch.from_numpy(np.ascontiguousarray(chunk))
                if x.is_floating_point():
                    x = x.to(torch.float32)
                v = self._reduce(spec, flat, x.to(dev)).cpu().numpy()  # (mb,)
                vals.append(v[:mb - pad])
        out = np.concatenate(vals, axis=0).astype(np.float64)
        if span_sink is not None:
            span_sink.append({
                "trace_id": None,
                "span_id": None,
                "parent_id": None,
                "name": f"device_eval:{spec.name or spec.aggregate}",
                "stage": "device_eval",
                "start_s": t_open,
                "dur_s": time.monotonic() - t_open,
                "pid": os.getpid(),
                "rows": int(b),
                "draws": int(snap.num_draws),
            })
        return out


@contextlib.contextmanager
def _torch_profile(profile_dir: str, cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "refresh_trace.json"))


class ResidentEnsemble:
    """A warm :class:`~repro_torch.core.ensemble.ChainEnsemble` serving
    queries.

    Thread-safe: refresh (foreground or background) and query/snapshot may
    interleave. The committed state (theta, sampler and controller state,
    steps, window and the generator's state) changes only under a lock,
    all together; a refresh runs from a copy of it, so a checkpoint taken
    mid-refresh holds the generator state that matches its theta.
    """

    def __init__(
        self,
        ensemble: ChainEnsemble,
        theta0: Params,
        *,
        seed: int = 0,
        window: int = 64,
        refresh_steps: int = 32,
        micro_batch: int = 64,
        name: str = "resident",
        batched_theta0: bool = False,
    ):
        if window < 1 or refresh_steps < 1 or micro_batch < 1:
            raise ValueError("window, refresh_steps, micro_batch must be >= 1")
        self.ensemble = ensemble
        self.name = name
        self.window = int(window)
        self.refresh_steps = int(refresh_steps)
        self.micro_batch = int(micro_batch)
        self.device = ensemble._device
        self._gen = make_generator(seed, self.device)
        self._gen_state = self._gen.get_state()  # the committed stream position
        self._state: EnsembleState = ensemble.init(theta0, batched=batched_theta0)
        self._steps_done = 0
        self._draws = None  # tree of numpy arrays, leaves (K, W<=window, ...)
        self._last_infos = None
        self._last_refresh: float | None = None
        # _lock guards the committed state (snapshot/query reads, commits);
        # _refresh_lock serialises the mutators (refresh, load_flat), so the
        # long MCMC run happens outside _lock and never blocks snapshots.
        self._lock = threading.RLock()
        self._refresh_lock = threading.RLock()
        self._evaluator = SnapshotEvaluator(micro_batch, self.device)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # One-shot torch.profiler capture of the next refresh (arm_profile).
        self._profile_dir: str | None = None
        self.last_profile_dir: str | None = None

    # -- refresh -----------------------------------------------------------

    @property
    def steps_done(self) -> int:
        return self._steps_done

    @property
    def state(self) -> EnsembleState:
        return self._state

    def arm_profile(self, profile_dir: str) -> None:
        """Capture a ``torch.profiler`` trace of the next refresh block into
        ``profile_dir`` (one-shot). Best effort: a profiler that is missing
        or fails leaves the refresh as it would be."""
        self._profile_dir = profile_dir

    def _profile_ctx(self):
        """The armed one-shot capture around one refresh run, or a no-op."""
        profile_dir, self._profile_dir = self._profile_dir, None
        if profile_dir is None:
            return contextlib.nullcontext(), None
        return _torch_profile(profile_dir, self.device.type == "cuda"), profile_dir

    def _run_block(self, state, gen_state, n):
        """``n`` transitions from a copy of the committed ``state``, the
        generator set to the committed ``gen_state`` (runs update sampler
        buffers in place; the committed ones must stay as they are)."""
        self._gen.set_state(gen_state)
        out = self.ensemble.run(self._gen, tree_map(_clone, state), n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def refresh(self, num_steps: int | None = None) -> int:
        """Advance every chain ``num_steps`` (default ``refresh_steps``)
        transitions and fold the collected draws into the window.

        The resident's generator carries on from the committed state, so any
        sequence of refreshes equals one offline ``ensemble.run`` over the
        same total steps on a generator seeded alike (where the ensemble's
        stepping keeps its draws under chunking; see the module docstring).
        """
        n = self.refresh_steps if num_steps is None else int(num_steps)
        if n < 1:
            raise ValueError(f"refresh needs num_steps >= 1, got {n}")
        with self._refresh_lock:
            # Only mutators hold _refresh_lock, so these reads are stable; the
            # run happens with _lock released and snapshots keep serving.
            with self._lock:
                state, steps_done, gen_state = self._state, self._steps_done, self._gen_state
            ctx, profiled = self._profile_ctx()
            try:
                with ctx:
                    new_state, samples, infos = self._run_block(state, gen_state, n)
            except Exception:
                if profiled is None:
                    raise
                # The profiler itself failed (e.g. another capture active):
                # redo the block unprofiled from the same committed state.
                profiled = None
                new_state, samples, infos = self._run_block(state, gen_state, n)
            if profiled is not None:
                self.last_profile_dir = profiled
            new_gen_state = self._gen.get_state()
            draws = _window_append(self._draws, samples, self.window)
            last_infos = tree_map(_host, infos)
            with self._lock:
                self._draws = draws
                self._last_infos = last_infos
                self._state = new_state
                self._gen_state = new_gen_state
                self._steps_done = steps_done + n
                self._last_refresh = time.monotonic()
        return n

    # -- streaming append --------------------------------------------------

    def append(self, new_data) -> int:
        """Fold newly appended observations into the running chains; returns
        the number of sections added.

        The ensemble's target is rebuilt on ``cat([old, new])`` from its
        :class:`~repro_torch.core.target_builder.TargetSpec` (the same as a
        build on the concatenated pool), while theta, ``steps_done`` and the
        resident's generator carry over: the next :meth:`refresh` continues
        the same stream against the grown posterior, with no restart and no
        burn-in from ``theta0``. Sampler and controller state are shaped by
        ``num_sections``, so both are initialised again for the grown pool
        (no buffer of the old N is kept). The window stays but reads as
        infinitely stale (``_last_refresh = None``): the freshness policy
        then refuses it until a refresh folds the new data in.

        An empty append is a bit-for-bit no-op: the same target object,
        state, window and staleness clock.
        """
        from ..core.target_builder import append_observations

        with self._refresh_lock:
            if self.ensemble.target is None:
                raise ValueError(f"resident {self.name!r} runs a composite transition with no "
                                 "single appendable target")
            new_target = append_observations(self.ensemble.target, new_data)
            if new_target is self.ensemble.target:
                return 0
            added = new_target.num_sections - self.ensemble.target.num_sections
            new_ensemble = dataclasses.replace(self.ensemble, target=new_target)
            with self._lock:
                theta = self._state.theta
            fresh = new_ensemble.init(theta, batched=True)
            with self._lock:
                self.ensemble = new_ensemble
                self._state = fresh
                self._last_refresh = None  # the pre-append window is not fresh
        return int(added)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Snapshot:
        """The current posterior window (empty draws before any refresh)."""
        with self._lock:
            # Clock read under the lock: a concurrent refresh advancing
            # _last_refresh must not yield negative staleness.
            now = time.monotonic()
            draws = self._draws  # host arrays, replaced (never mutated) by refresh
            staleness = float("inf") if self._last_refresh is None else now - self._last_refresh
            num = 0
            if draws is not None:
                lead = tree_leaves(draws)[0].shape
                num = int(lead[0] * lead[1])
            return Snapshot(draws=draws, num_draws=num, steps_done=self._steps_done,
                            staleness_s=staleness, summary=_summarize_infos(self._last_infos),
                            created_at=now)

    # -- queries -----------------------------------------------------------

    def query(self, spec: QuerySpec, xs, *, snapshot: Snapshot | None = None,
              span_sink: list | None = None) -> tuple[np.ndarray, Snapshot]:
        """Evaluate ``spec`` on request rows ``xs`` against a snapshot;
        returns ``(values (B,), snapshot_used)``."""
        snap = snapshot if snapshot is not None else self.snapshot()
        if snap.draws is None:
            raise RuntimeError(
                f"resident {self.name!r} has no draws yet; refresh() first "
                "(or serve through EnsemblePool, which enforces freshness)")
        return self._evaluator.evaluate(spec, snap, xs, span_sink=span_sink), snap

    # -- background refresh ------------------------------------------------

    def start_background(self, interval_s: float = 0.0) -> None:
        """Refresh continuously (or every ``interval_s``) on a daemon thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()

            def loop():
                while not self._stop.is_set():
                    self.refresh()
                    if interval_s:
                        self._stop.wait(interval_s)

            self._thread = threading.Thread(target=loop, name=f"refresh-{self.name}",
                                            daemon=True)
            self._thread.start()

    def stop_background(self, timeout_s: float = 30.0) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=timeout_s)
        self._thread = None

    # -- persistence -------------------------------------------------------

    def state_dict(self) -> dict:
        """Host tree for :mod:`repro_torch.checkpoint.manager` (numpy
        arrays): the generator's state (``gen_state``, uint8) where the
        reference keeps its key, beside the committed steps, theta, sampler
        and controller state and the window."""
        with self._lock:
            out = {
                "gen_state": self._gen_state.numpy().copy(),
                "steps_done": np.asarray(self._steps_done, np.int64),
                "theta": tree_map(_host, self._state.theta),
                "sampler": tree_map(_host, self._state.sampler_state),
            }
            if self._state.controller is not None:
                out["controller"] = tree_map(_host, self._state.controller)
            if self._draws is not None:
                out["draws"] = self._draws
            return out

    def load_flat(self, flat: dict) -> None:
        """Restore from the flat leaf dict a checkpoint ``restore`` (without
        target) yields for this resident's subtree. The structure comes from
        this resident's own freshly initialised state, so only a pool
        configured as the saved one was can restore, and the generator's
        state restores only onto the device type it was saved from (a CUDA
        generator's state is 16 bytes, a CPU one's 5 056)."""
        with self._refresh_lock, self._lock:
            core = {"steps_done": 0, "theta": self._state.theta,
                    "sampler": self._state.sampler_state}
            if self._state.controller is not None:
                core["controller"] = self._state.controller
            missing = [n for n in ["gen_state", *_flatten(core)] if n not in flat]
            if missing:
                raise KeyError(f"checkpoint is missing leaves for resident {self.name!r}: "
                               f"{missing[:5]}")
            gen_state = torch.as_tensor(np.asarray(flat["gen_state"])).to(torch.uint8).cpu()
            want = self._gen.get_state().numel()
            if gen_state.numel() != want:
                raise ValueError(
                    f"checkpoint's generator state is {gen_state.numel()} bytes, resident "
                    f"{self.name!r}'s {self.device.type} generator takes {want}: a resident "
                    "restores onto the device type it was saved from")

            def put(a, like):
                a = np.asarray(a)
                if not isinstance(like, torch.Tensor):  # a shared number (a pool size):
                    vals = np.unique(a)  # one value, or the same one per chain
                    if vals.size != 1:
                        raise ValueError(f"checkpoint leaf {a} of {self.name!r} must hold one "
                                         "value")
                    return type(like)(vals[0].item())
                if a.shape != tuple(like.shape):
                    raise ValueError(
                        f"checkpoint leaf shape {a.shape} != resident shape {tuple(like.shape)} "
                        f"for {self.name!r}: the pool must be configured (num_chains, workload "
                        "sizes, schedule) exactly as when it was saved")
                return torch.from_numpy(a.copy()).to(device=like.device, dtype=like.dtype)

            core = _rebuild(core, flat, put)
            self._gen.set_state(gen_state)
            self._gen_state = gen_state.clone()
            self._steps_done = int(core["steps_done"])
            self._state = EnsembleState(core["theta"], core["sampler"], core.get("controller"))
            if any(k == "draws" or k.startswith("draws__") for k in flat):
                tmpl = {"draws": (self.ensemble.collect or (lambda t: t))(self._state.theta)}
                self._draws = _rebuild(tmpl, flat, lambda a, like: np.asarray(a))["draws"]
            self._last_infos = None
            self._last_refresh = None  # unknown age: freshness forces a refresh
            # The restored window replaces what was resident; a stale device
            # cache could otherwise collide on the (steps, draws) generation.
            self._evaluator.invalidate()
