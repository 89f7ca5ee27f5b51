"""Cells of the benchmark at sizes a CPU test can hold: the cell's own
configuration and traffic with the sizes cut, everything else as run."""
from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

from mcmcbench.lib import spec

ROOT = Path(__file__).resolve().parents[2]
LM_CELL = "chatglm3-6b.mh-pool1024"
LR_CELL = "bayeslr-mnist.masked-k1024"


def lm_cell() -> spec.Cell:
    cell = spec.load_cell(ROOT, LM_CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(num_layers=2, hidden_size=64, num_attention_heads=4, multi_query_group_num=2,
               kv_channels=16, ffn_hidden_size=96, padded_vocab_size=128)
    tr = dict(cell.traffic, pool=32, seq_len=8, round_batch=8, burn_in_steps=3, check_steps=2,
              trace_steps=1)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def held_out_cell(name: str) -> spec.Cell:
    """A cell of ``held_out/<name>.json``: entries as BENCHMARK.json would hold them."""
    held = spec.load_json(spec.BENCH_DIR / "held_out" / f"{name}.json")
    w = held["workload"]

    def metrics(kind):
        return tuple(spec.Metric(m["name"], m["unit"]) for m in held["metrics"]
                     if ("bound" in m) == (kind == "end_to_end"))

    return spec.Cell(w["name"], int(w["chips"]), spec.load_json(ROOT / held["config"]["file"]),
                     spec.load_json(spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                     metrics("end_to_end") + (spec.Metric("setup_s", "s"),),
                     metrics("per_layer"))


def lr_cell() -> spec.Cell:
    cell = held_out_cell(LR_CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["data"] = dict(cfg["data"], n_train=600, n_test=100, d=5)
    cfg["num_steps"] = 4
    tr = dict(cell.traffic, chains=16, round_batch=50, burn_in_steps=3, trace_steps=2,
              check_transitions=64)
    return dataclasses.replace(cell, config=cfg, traffic=tr)
