"""Historical perf trend store: a ring buffer of bench artifact sets, the
port of ``repro.obs.history`` (stdlib only, as there).

The CI perf gate used to diff against exactly one previous run's
``BENCH_*.json`` set — one noisy baseline, no memory. A
:class:`HistoryStore` keeps the last ``capacity`` runs' artifacts
(``BENCH_*.json`` plus the run's ``GATE_verdict.json``) in an append-only
ring under one root directory::

    <root>/index.json              {"next_seq": 7, "runs": [...]}  oldest first
    <root>/000004-20260807-.../    BENCH_serving.json, ..., GATE_verdict.json
    <root>/000005-.../
    <root>/000006-.../

The reference's ``benchmarks/gate.py --trend --history <root>`` reads the
last K runs for a median-of-last-K baseline plus monotone-drift detection,
then appends the current run; the store's layout is the reference's, so
one root serves both packages' artifacts.

The store is deliberately dumb: it copies files and prunes the oldest
entries past ``capacity``. All metric math (record matching, direction,
thresholds) stays with the gate. A missing or corrupt
``index.json`` is rebuilt from the run directories on disk, so an
expired/partial CI cache degrades to "shorter history", never to a crash.
"""
from __future__ import annotations

import json
import os
import shutil
import time

_ARTIFACT_PREFIX = "BENCH_"
_VERDICT = "GATE_verdict.json"


class HistoryStore:
    """Append-only ring buffer of the last N runs' bench artifacts."""

    def __init__(self, root: str, capacity: int = 20):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.root = root
        self.capacity = int(capacity)
        os.makedirs(self.root, exist_ok=True)
        self._index = self._load_index()

    # -- index -------------------------------------------------------------

    @property
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    def _load_index(self) -> dict:
        try:
            with open(self._index_path) as f:
                index = json.load(f)
            runs = [r for r in index.get("runs", [])
                    if os.path.isdir(os.path.join(self.root, r["id"]))]
            return {"next_seq": int(index.get("next_seq", len(runs))),
                    "runs": runs}
        except (OSError, ValueError, KeyError, TypeError):
            # No/corrupt index: rebuild from the run dirs on disk (their
            # zero-padded seq prefix keeps them sortable oldest-first).
            runs = [
                {"id": d, "saved_at": None}
                for d in sorted(os.listdir(self.root))
                if os.path.isdir(os.path.join(self.root, d))
            ]
            next_seq = 0
            for r in runs:
                try:
                    next_seq = max(next_seq, int(r["id"].split("-", 1)[0]) + 1)
                except ValueError:
                    pass
            return {"next_seq": next_seq, "runs": runs}

    def _write_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1, default=str)

    # -- reading -----------------------------------------------------------

    def runs(self) -> list[dict]:
        """Run entries, oldest first: ``{"id", "saved_at", ...}``."""
        return [dict(r) for r in self._index["runs"]]

    def run_dir(self, run_id: str) -> str:
        return os.path.join(self.root, run_id)

    def last(self, n: int) -> list[dict]:
        """The newest ``n`` run entries, oldest first."""
        return self.runs()[-n:] if n > 0 else []

    def __len__(self) -> int:
        return len(self._index["runs"])

    # -- appending ---------------------------------------------------------

    def append(self, artifact_dir: str, run_id: str | None = None,
               meta: dict | None = None) -> str:
        """Copy one run's ``BENCH_*.json`` (+ ``GATE_verdict.json`` when
        present) into the ring; prunes past ``capacity``. Returns the run
        id. A run with no bench artifacts at all is refused — an empty
        entry would silently shorten every later trend window."""
        files = sorted(
            f for f in os.listdir(artifact_dir)
            if (f.startswith(_ARTIFACT_PREFIX) and f.endswith(".json"))
            or f == _VERDICT
        )
        if not any(f.startswith(_ARTIFACT_PREFIX) for f in files):
            raise FileNotFoundError(
                f"no {_ARTIFACT_PREFIX}*.json artifacts in {artifact_dir!r}"
            )
        seq = self._index["next_seq"]
        self._index["next_seq"] = seq + 1
        if run_id is None:
            run_id = f"{seq:06d}-{time.strftime('%Y%m%d-%H%M%S')}"
        else:
            run_id = f"{seq:06d}-{run_id}"
        dst = self.run_dir(run_id)
        os.makedirs(dst, exist_ok=True)
        for f in files:
            shutil.copy2(os.path.join(artifact_dir, f), os.path.join(dst, f))
        self._index["runs"].append({
            "id": run_id,
            "saved_at": time.time(),
            "artifacts": files,
            **(meta or {}),
        })
        while len(self._index["runs"]) > self.capacity:
            oldest = self._index["runs"].pop(0)
            shutil.rmtree(self.run_dir(oldest["id"]), ignore_errors=True)
        self._write_index()
        return run_id
