"""Append-only per-run metric recording with live rollups, the port of
``repro.obs.recorder`` (stdlib and numpy, as there; torch scalars and
tensors in a record are moved to the host when it is written).

A :class:`Recorder` owns one run directory (``<root>/<run_id>/``) holding
one JSONL file per metric *stream* — ``slo.jsonl``, ``snapshot.jsonl``,
``fleet.jsonl``, ``refresh.jsonl``, ``adaptation.jsonl``, ``chaos.jsonl``
in the serving front-end — plus ``meta.json`` at start and ``summary.json``
(the final rollup) at close. Every record is one JSON object per line with
a wall-clock ``t`` and a run-relative ``rel_s`` stamp, so streams from one
run can be joined on time.

The rollup is maintained incrementally (count / mean / min / max / last
plus streaming P² p50/p95 per numeric field per stream) and is cheap to
read at any moment — it is what
the ``serve --stats-addr`` HTTP endpoint returns while the run is live, and
what ``summary.json`` freezes at the end.

``root_dir=None`` records in memory only (rollup works, nothing touches
disk) — what tests and ephemeral smoke runs use.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch


def _host(t: torch.Tensor):
    """A tensor as a host value: a 0-d one as the Python number it holds,
    any other as a numpy array."""
    a = t.detach().cpu().numpy()
    return a.item() if a.ndim == 0 else a


def json_default(obj):
    """JSON encoder fallback for the numpy and torch scalars/arrays metric
    dicts naturally carry (a tensor is copied to the host: a 0-d one as its
    number, any other as nested lists)."""
    if isinstance(obj, torch.Tensor):
        obj = _host(obj)
        if not isinstance(obj, np.ndarray):
            return obj
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return str(obj)


def _as_scalar(value) -> float | None:
    """The aggregatable float behind a metric value, or None for
    non-numeric values (bool counts as numeric: rates of flags are useful).
    A 0-d torch tensor counts as the number it holds (one host read)."""
    if isinstance(value, torch.Tensor):
        if value.ndim != 0:
            return None
        value = value.item()
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float, np.integer, np.floating)):
        v = float(value)
        return v if np.isfinite(v) else None
    return None


class _P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator (5 markers).

    O(1) memory per field: below 5 observations the exact sorted-buffer
    quantile is returned; from the 5th on, the marker heights track the
    target quantile with piecewise-parabolic adjustment. This is what lets
    the rollup report latency tails without re-reading the raw JSONL."""

    __slots__ = ("p", "q", "n", "np_", "dn", "_buf")

    def __init__(self, p: float):
        self.p = float(p)
        self._buf: list[float] = []
        self.q: list[float] | None = None

    def add(self, x: float) -> None:
        if self.q is None:
            self._buf.append(x)
            if len(self._buf) == 5:
                self._buf.sort()
                p = self.p
                self.q = list(self._buf)
                self.n = [0.0, 1.0, 2.0, 3.0, 4.0]
                self.np_ = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]
                self.dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
            return
        q, n = self.q, self.n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x < q[1]:
            k = 0
        elif x < q[2]:
            k = 1
        elif x < q[3]:
            k = 2
        elif x <= q[4]:
            k = 3
        else:
            q[4] = x
            k = 3
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self.np_[i] += self.dn[i]
        for i in (1, 2, 3):
            d = self.np_[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qi = self._parabolic(i, d)
                if not q[i - 1] < qi < q[i + 1]:
                    qi = self._linear(i, d)
                q[i] = qi
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        d = int(d)
        q, n = self.q, self.n
        return q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])

    def value(self) -> float:
        if self.q is not None:
            return self.q[2]
        s = sorted(self._buf)
        if not s:
            return 0.0
        idx = self.p * (len(s) - 1)
        lo = int(idx)
        frac = idx - lo
        if lo + 1 >= len(s):
            return s[-1]
        return s[lo] + (s[lo + 1] - s[lo]) * frac


class _FieldAgg:
    """Streaming count/sum/min/max/last + P² tail quantiles for one
    numeric field."""

    __slots__ = ("count", "total", "min", "max", "last", "q50", "q95")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0
        self.q50 = _P2Quantile(0.5)
        self.q95 = _P2Quantile(0.95)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v
        self.q50.add(v)
        self.q95.add(v)

    def summary(self) -> dict:
        # count/mean/min/max/last are byte-identical to the pre-quantile
        # rollup; p50/p95 are additive keys (dashboards keying on the
        # original five fields are unaffected).
        return {
            "count": self.count,
            "mean": self.total / max(self.count, 1),
            "min": self.min,
            "max": self.max,
            "last": self.last,
            "p50": self.q50.value(),
            "p95": self.q95.value(),
        }


class Recorder:
    """Thread-safe append-only metric streams + incremental rollup."""

    def __init__(self, root_dir: str | None = None, *,
                 run_id: str | None = None, meta: dict | None = None):
        self.run_id = run_id or (
            f"run-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        )
        self.meta = dict(meta or {})
        self.dir: str | None = None
        self._files: dict[str, object] = {}
        self._streams: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        self._closed = False
        if root_dir:
            self.dir = os.path.join(root_dir, self.run_id)
            os.makedirs(self.dir, exist_ok=True)
            with open(os.path.join(self.dir, "meta.json"), "w") as f:
                json.dump({"run_id": self.run_id, "started_at": self._t0_wall,
                           **self.meta}, f, default=json_default, indent=2)

    # -- writing -----------------------------------------------------------

    def record(self, stream: str, metrics: dict | None = None, **kw) -> dict:
        """Append one record to ``stream``; returns the record (with its
        time stamps) as written."""
        rec = {"t": time.time(),
               "rel_s": time.monotonic() - self._t0_mono}
        rec.update(metrics or {})
        rec.update(kw)
        for field, value in rec.items():
            if isinstance(value, torch.Tensor):
                rec[field] = _host(value)
        line = json.dumps(rec, default=json_default)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"recorder {self.run_id!r} is closed")
            agg = self._streams.setdefault(
                stream, {"count": 0, "fields": {}, "last": {}}
            )
            agg["count"] += 1
            agg["last"] = rec
            for field, value in rec.items():
                v = _as_scalar(value)
                if v is None:
                    continue
                agg["fields"].setdefault(field, _FieldAgg()).add(v)
            if self.dir is not None:
                f = self._files.get(stream)
                if f is None:
                    safe = stream.replace(os.sep, "_")
                    f = open(os.path.join(self.dir, f"{safe}.jsonl"), "a",
                             buffering=1)
                    self._files[stream] = f
                f.write(line + "\n")
        return rec

    # -- reading -----------------------------------------------------------

    def rollup(self) -> dict:
        """The current end-of-run summary, computable at any moment: per
        stream the record count, the last record, and count/mean/min/max/last
        per numeric field."""
        with self._lock:
            return {
                "run_id": self.run_id,
                "uptime_s": time.monotonic() - self._t0_mono,
                "meta": dict(self.meta),
                "streams": {
                    name: {
                        "count": agg["count"],
                        "last": dict(agg["last"]),
                        "fields": {
                            f: a.summary() for f, a in agg["fields"].items()
                        },
                    }
                    for name, agg in self._streams.items()
                },
            }

    def stream_path(self, stream: str) -> str | None:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"{stream.replace(os.sep, '_')}.jsonl")

    def read_stream(self, stream: str) -> list[dict]:
        """Parse a stream's JSONL back into records (empty when the stream
        was never written or the recorder is memory-only)."""
        path = self.stream_path(stream)
        if path is None or not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    # -- lifecycle ---------------------------------------------------------

    def write_summary(self) -> str | None:
        """Freeze the rollup to ``summary.json``; returns its path (None
        for a memory-only recorder)."""
        if self.dir is None:
            return None
        path = os.path.join(self.dir, "summary.json")
        with open(path, "w") as f:
            json.dump(self.rollup(), f, default=json_default, indent=2)
        return path

    def close(self) -> str | None:
        """Write the summary and close every stream file (idempotent)."""
        with self._lock:
            if self._closed:
                return None
            files, self._files = self._files, {}
        path = self.write_summary()
        for f in files.values():
            f.close()
        with self._lock:
            self._closed = True
        return path

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
