#!/usr/bin/env python3
"""The deterministic values of ``chip_smoke.py``'s report, and a check that
a run reproduces them.

A value is deterministic when it follows from the seeds alone: acceptance,
rounds, evaluated sections, R-hat and ESS, every launch count of a phase
that is not a timed window, decisions, held errors. Rates, times, memory
and the counts of timed windows (a soak's requests, a paced load's
queries) are not. :func:`deterministic` keeps the first kind by the names
of the report's fields; :func:`make` keeps, of the first run's, those that
every other run it is given either equals or lacks (an earlier run of the
same code may predate a phase), so a value that moved between two runs of
the same code is left out.

    python3 tools/proof_values.py make OUT.json RUN.json [RUN.json ...]
    python3 tools/proof_values.py check VALUES.json RUN.json

``chip_smoke.py`` holds its own run to ``tools/proof_values.json`` at its
end (:func:`differences`).
"""
from __future__ import annotations

import json
import re
import sys

# fields, and whole subtrees, that hold times, rates, memory, host paths or
# the counts of a window bounded by time; alerts fire on latencies and rates
_VOLATILE_LEAF = re.compile(
    r"(^|_)(s|ms|us|seconds|wall|gib|mib|bytes|share|staleness)$|per_s|_ms_|^ms_|_us_|"
    r"^(free|gib|peak)_|_over_|^req_per|^time|^alerts")
_VOLATILE_TREE = {
    "argv", "controller_cost", "obs_parts", "refresh_beside_stats", "cpu_share", "classes",
    "classes_beside_refresh", "classes_obs", "classes_plain", "op_us", "seconds", "joins",
    "scaler_events", "beside_intervals", "alone_replicas_up", "alone_after_window",
    "alone_replicas_closed", "rounds_per_s_alone_replicas_up", "rounds_per_s_alone_after_window",
    "rounds_per_s_alone_replicas_closed", "req_per_s", "req_per_s_obs", "req_per_s_plain",
    "refresh_alone_transitions_per_s", "grad_ms", "step_s", "w_moves_from_final",
}
# phases that run for a set time or beside a paced load: their counts follow the clock
_TIMED_PHASES = {"O-soak", "O-kill-proc", "R-bg", "R-proc", "Q-bg", "U", "H-adam"}


def flatten(tree, prefix: str = "") -> dict:
    """``{"/phase/field[i]/...": leaf}`` of a JSON tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _volatile(path: str) -> bool:
    parts = [re.sub(r"\[\d+\]$", "", p) for p in path.strip("/").split("/")]
    if parts[0] in _TIMED_PHASES:
        return True
    if any(re.sub(r"\[\d+\]", "", p) in _VOLATILE_TREE for p in parts[1:]):
        return True
    return bool(_VOLATILE_LEAF.search(parts[-1]))


def deterministic(phases: dict) -> dict:
    """The report's ``phases`` (as JSON gives them back) flattened, less the
    volatile fields."""
    return {k: v for k, v in flatten(json.loads(json.dumps(phases, default=float))).items()
            if not _volatile(k)}


def make(runs: list[dict]) -> dict:
    """The deterministic values of ``runs[0]`` (phases) that every other run
    equals or lacks."""
    first = deterministic(runs[0])
    rest = [deterministic(r) for r in runs[1:]]
    return {k: v for k, v in first.items() if all(r.get(k, v) == v for r in rest)}


def differences(values: dict, phases: dict) -> list[str]:
    """Each value of ``values`` that the run's ``phases`` do not reproduce
    (missing, or another value)."""
    got = flatten(json.loads(json.dumps(phases, default=float)))
    return [f"{k}: {v!r} -> {got.get(k, '<missing>')!r}" for k, v in values.items()
            if got.get(k, "<missing>") != v]


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "make":
        runs = [json.load(open(p))["phases"] for p in argv[2:]]
        values = make(runs)
        with open(argv[1], "w") as f:
            json.dump(values, f, indent=0, sort_keys=True)
        print(f"{len(values)} values of the first of {len(runs)} runs -> {argv[1]}")
        return 0
    if len(argv) == 3 and argv[0] == "check":
        diffs = differences(json.load(open(argv[1])), json.load(open(argv[2]))["phases"])
        print("\n".join(diffs) or "every value reproduced")
        return 1 if diffs else 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
