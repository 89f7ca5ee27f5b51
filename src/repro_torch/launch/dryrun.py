"""The dry run: each (arch x shape) cell's step on the production mesh, run
on the meta device (the port of ``repro.launch.dryrun``). No card and no
memory: every op is dispatched and every shape checked.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell for 512 forced host devices and
reads XLA's memory and cost analyses and the HLO's collectives. Here:

- **"lower + compile"** is one run of the cell's step on meta tensors under
  ``force_devices(512)`` and the production mesh of meta slots
  (``make_production_mesh(device="meta")``), its inputs split by the cell's
  shardings. A train cell runs one round's device work: the proposal, the
  prior, and the theta and theta' forwards over ``round_batch`` rows (the
  sequential test's ``done`` cannot be read from a meta tensor, and XLA's
  cost analysis counts a ``while`` body once).
- ``memory.argument_bytes`` / ``output_bytes``: over all slots, the largest
  sum of the bytes of the pieces a slot holds of every input / output with a
  sharding (params, batch, cache, logits). Slot (0, ..., 0) owns every
  replicated leaf, so this is the reference's ``sum(leaf bytes / shard
  count)``. ``temp_bytes``: the home device's peak of live bytes that are
  neither inputs nor outputs during the run (a ``TorchDispatchMode`` follows
  every op output's storage). ``alias_bytes``: null, no counterpart.
- ``flops_home``: ``torch.utils.flop_counter.FlopCounterMode``'s total. All
  compute runs on the home device, so there is no per-device split; it
  counts matmuls and attention products, not elementwise work, which XLA's
  cost analysis counts, so the two are never compared.
- ``transfers``: the sharded leaves' own gathers and scatters (count,
  bytes; ``distributed.sharding.transfer_counts``), in place of the
  reference's collectives. ``parse_collectives`` reads XLA HLO text and is
  not ported.
- **Loops.** Each cell is traced at 2 and 3 trips of its layer scan
  (:func:`scan_trip_count`) and ``flops_home``, ``temp_bytes`` and the
  transfers are extrapolated linearly to ``loop_scale`` trips: exact where
  the trips are alike, the reference's own first-order correction (2, not
  1: a one-trip peak lacks the state an earlier trip leaves live, such as
  a prefill's keys and values, so its growth to two trips overshoots). Inside a
  trip, a recurrence's loop over time steps (``models/ssm.py``) longer than
  ``2 * TIME_CUT`` steps and a flash attention's loop over more than ``2 *
  FLASH_CUT`` query chunks (``models/layers.py``) are traced at the cut and
  at twice it and extrapolated alike (``time_cut``, ``flash_cut``).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .._device import tree_leaves
from ..bayes.train import _prior_delta, _rows_of, propose
from ..configs import ARCHS, SHAPES, shape_applicable
from ..distributed import sharding
from ..distributed.sharding import ShardedTensor, logical_axis_rules
from ..distributed.slots import force_devices
from ..models import layers, transformer
from ..models.transformer import cache_template, forward_loglik
from .mesh import make_production_mesh
from .steps import (
    RULE_PRESETS,
    Cell,
    _generator,
    cell_for,
    default_train_config,
    place_inputs,
    spec_tree_to_abstract,
)

N_SLOTS = 512  # the multi-pod mesh's slots, forced for every cell
TRIPS = (2, 3)  # layer-scan trips each cell is traced at
TIME_CUT = 16  # time steps a long recurrence is traced at (and twice it)
FLASH_CUT = 2  # query chunks a long flash attention is traced at (and twice it)


def scan_trip_count(cfg) -> int:
    """Trip count of the model's layer scan (the reference's): a layer, a
    hybrid period, or an xLSTM pair."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    return cfg.n_layers


def cut_depth(cfg, trips: int):
    """``cfg`` with ``trips`` trips of its layer scan (whisper: as many
    encoder layers as decoder layers, as its config has)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=trips * cfg.attn_period)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2 * trips)
    if cfg.family == "audio":
        if cfg.enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: the cut scales encoder and decoder alike, "
                             f"but it has {cfg.enc_layers} and {cfg.n_layers} layers")
        return dataclasses.replace(cfg, n_layers=trips, enc_layers=trips)
    return dataclasses.replace(cfg, n_layers=trips)


# ---------------------------------------------------------------------------
# What a trace records
# ---------------------------------------------------------------------------


def _tensors(tree):
    for leaf in tree_leaves(tree):
        if isinstance(leaf, ShardedTensor):
            yield from leaf.pieces
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _LiveBytes(TorchDispatchMode):
    """A timeline of every op output's storage: its bytes from its first
    tensor to the death of its last (``skip``: the inputs' storages)."""

    def __init__(self, skip: set):
        super().__init__()
        self.skip = skip
        self.refs: dict[int, list] = {}  # storage -> [bytes, live tensors, its event]
        self.events: list[tuple[int, int]] = []  # (storage, +bytes / -bytes)
        self.live = 0
        self.window = 0  # the most ``live`` reached since it was last set
        self._spikes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            key = _key(t)
            if key in self.skip:
                continue
            rec = self.refs.get(key)
            if rec is None:
                rec = self.refs[key] = [t.untyped_storage().nbytes(), 0, len(self.events)]
                self._add(key, rec[0])
            rec[1] += 1
            weakref.finalize(t, self._drop, key)
        return out

    def _add(self, key: int, nbytes: int) -> None:
        self.events.append((key, nbytes))
        self.live += nbytes
        self.window = max(self.window, self.live)

    def _drop(self, key: int) -> None:
        rec = self.refs[key]
        rec[1] -= 1
        if rec[1] == 0:
            del self.refs[key]
            self.events.append((key, -rec[0]))
            self.live -= rec[0]

    def spike(self, nbytes: int) -> None:
        """``nbytes`` live for an instant (a cut loop's extrapolated rise)."""
        if nbytes > 0:
            self._spikes -= 1
            self._add(self._spikes, int(nbytes))
            self.events.append((self._spikes, -int(nbytes)))
            self.live -= int(nbytes)

    def peak(self, outputs) -> int:
        """The most bytes live at once, the storages of ``outputs`` (tensors
        alive now) left out."""
        exclude = {self.refs[k][2] for k in map(_key, outputs) if k in self.refs}
        live = top = 0
        for i, (key, nbytes) in enumerate(self.events):
            if i not in exclude:
                live += nbytes
                top = max(top, live)
        return top


class _Trace:
    """The counters a cut loop reads and corrects while a trace runs."""

    def __init__(self, flops: FlopCounterMode, mem: _LiveBytes):
        self.flops, self.mem = flops, mem
        self.flop_adjust = 0.0

    def total_flops(self) -> int:
        return self.flops.get_total_flops()


_TRACE: _Trace | None = None


def _extrapolated(run, n: int, k: int, full):
    """A call whose cost is linear in a length ``n``, traced at ``k`` and
    ``2 k`` (``run(m)``): its flops and its peak rise over the live bytes
    it found are extrapolated to ``n``; ``full(result of the 2 k run)``
    gives the output at ``n``."""
    t = _TRACE
    rises = []
    counts = [t.total_flops()]
    for m in (k, 2 * k):
        result = None  # the k run's output is freed before the 2 k run starts
        entry = t.mem.window = t.mem.live
        result = run(m)
        counts.append(t.total_flops())
        rises.append(t.mem.window - entry)
    c1, c2 = counts[1] - counts[0], counts[2] - counts[1]
    t.flop_adjust += (c1 + (c2 - c1) * (n / k - 1)) - c1 - c2
    out = full(result)
    del result
    t.mem.spike(entry + rises[0] + (rises[1] - rises[0]) * (n / k - 1) - t.mem.live)
    return out


def _cut_recurrence(block):
    """``block(x, p, state)`` (an ssm block, linear in x's length) traced
    over ``TIME_CUT`` and twice that many steps when ``x`` is longer."""
    def run_block(x, p, state=None):
        b, s = x.shape[0], x.shape[1]
        if _TRACE is None or s <= 2 * TIME_CUT:
            return block(x, p, state)

        def full(r):
            y, st = r
            return torch.empty((b, s) + tuple(y.shape[2:]), dtype=y.dtype, device=y.device), st

        return _extrapolated(lambda m: block(x[:, :m], p, state), s, TIME_CUT, full)

    return run_block


def _cut_flash(flash):
    """``_attend_flash`` traced over ``FLASH_CUT`` and twice that many query
    chunks when it has more (its cost is linear in their count)."""
    def run_flash(qg, k_all, v_all, q_pos, k_pos, window, causal, scale, chunk_q=256,
                  chunk_kv=512):
        s = qg.shape[1]
        cq = min(chunk_q, s)
        nq = -(-s // cq)
        if _TRACE is None or nq <= 2 * FLASH_CUT:
            return flash(qg, k_all, v_all, q_pos, k_pos, window, causal, scale, chunk_q, chunk_kv)

        def run(m):
            rows = m * cq
            return flash(qg[:, :rows], k_all, v_all, q_pos[:rows], k_pos, window, causal, scale,
                         chunk_q, chunk_kv)

        def full(r):
            return torch.empty((r.shape[0], s) + tuple(r.shape[2:]), dtype=r.dtype,
                               device=r.device)

        return _extrapolated(run, nq, FLASH_CUT, full)

    return run_flash


@contextlib.contextmanager
def _cut_loops():
    saved = {(transformer, n): getattr(transformer, n)
             for n in ("mamba_block", "mlstm_block", "slstm_block")}
    saved[(layers, "_attend_flash")] = layers._attend_flash
    try:
        for (mod, name), fn in saved.items():
            setattr(mod, name, _cut_flash(fn) if name == "_attend_flash" else _cut_recurrence(fn))
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _train_round(cell: Cell, seed, params, batch, cache=None):
    """One round of a train step's device work: log u and theta', the prior
    ratio, and the theta' and theta forwards over the pool's first
    ``round_batch`` rows (a cached step's first round, its cache empty,
    runs both forwards too)."""
    del cache
    tc = cell.train_cfg
    theta_p, log_u = propose(_generator(seed, params), params, tc)
    g = _prior_delta(params, theta_p, tc.prior_var)
    rows = _rows_of(batch, 0, min(tc.round_batch, batch["tokens"].shape[0]))
    lp = forward_loglik(theta_p, rows, cell.cfg, ce_chunk=tc.ce_chunk)
    lc = forward_loglik(params, rows, cell.cfg, ce_chunk=tc.ce_chunk)
    return theta_p, (lp - lc, g, log_u)


def trace_cell(cell: Cell) -> dict:
    """One run of ``cell``'s step (a train cell: :func:`_train_round`) on
    meta inputs split by its shardings: flops, transfers and temp bytes.
    The cyclic collector is off during the run, so when a storage dies is
    decided by its tensors' references alone and the peak is the same on
    every run."""
    global _TRACE
    args = tuple(cell.in_specs)
    if cell.spec.kind == "train":
        args = (0,) + args[1:]
    inputs = place_inputs(cell, *args)
    skip = {_key(t) for t in _tensors(inputs)}
    run = (lambda: _train_round(cell, *inputs)) if cell.spec.kind == "train" \
        else (lambda: cell.step(*inputs))
    sharding.reset_transfers()
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), _cut_loops(), FlopCounterMode(display=False) as fc, \
                _LiveBytes(skip) as mem:
            _TRACE = _Trace(fc, mem)
            out = run()
            flops = fc.get_total_flops() + _TRACE.flop_adjust
    finally:
        _TRACE = None
        gc.enable()
    seconds = time.perf_counter() - t0
    temp = mem.peak(_tensors(out))
    del out, inputs
    return {"flops": flops, "temp": temp, "transfers": sharding.transfer_counts(),
            "seconds": seconds}


def slot_bytes(specs, shardings) -> dict:
    """``{slot: bytes}``: the sum of the bytes of the pieces each slot holds
    of the leaves of ``specs`` (tensors, meta ones too) that have a
    sharding."""
    per_slot: collections.Counter = collections.Counter()
    for t, sh in zip(tree_leaves(specs), tree_leaves(shardings)):
        if t is None or sh is None:
            continue
        for blk in sh.owners(t.shape):
            n = int(np.prod([s.stop - s.start for s in blk.index], dtype=np.int64))
            per_slot[blk.slot] += n * t.element_size()
    return dict(per_slot)


def _slot_bytes(specs, shardings) -> int:
    """Over all slots, the largest of :func:`slot_bytes`."""
    return max(slot_bytes(specs, shardings).values(), default=0)


def _output_specs(cell: Cell):
    """Meta stand-ins of the step's outputs, in ``cell.out_shardings``' nesting."""
    if cell.spec.kind == "train":
        params = cell.in_specs[1]
        return (params, cell.in_specs[3], None) if cell.train_cfg.cached else (params, None)
    gb, s = cell.spec.global_batch, cell.spec.seq_len
    cache = spec_tree_to_abstract(cache_template(cell.cfg, gb, s))
    return cache, torch.empty((gb, cell.cfg.vocab), dtype=torch.float32, device="meta")


def _extrapolate(one: float, two: float, trips: int) -> float:
    """The value at ``trips`` from those at ``TRIPS``, linearly."""
    a, b = TRIPS
    return one + (two - one) * (trips - a) / (b - a)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             rules_name: str = "default", kv_dtype: str | None = None,
             tag: str = "", cached: bool = False, spec=None) -> dict:
    """Dry-run one cell on the single- or multi-pod mesh and write its
    record as ``<out_dir>/<arch>__<shape>__<mesh>[__<tag>].json`` (none
    when ``out_dir`` is empty). ``spec``, a ``ShapeSpec``, stands in for
    ``SHAPES[shape]``."""
    spec = spec or SHAPES[shape]
    mesh_name = "multi" if multi_pod else "single"
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                    "rules": rules_name, "kv_dtype": kv_dtype, "tag": tag}
    ok, reason = shape_applicable(arch, shape) if shape in SHAPES else (True, "")
    if not ok:
        record.update(status="skipped", reason=reason)
        _write(record, out_dir)
        return record
    try:
        rules = RULE_PRESETS[rules_name]
        cfg = ARCHS[arch]
        if kv_dtype is not None:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
        train_cfg = None
        if cached and spec.kind == "train":
            train_cfg = dataclasses.replace(default_train_config(cfg, spec), cached=True)
        with force_devices(N_SLOTS):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            with logical_axis_rules(mesh, rules):
                cell = cell_for(cfg, spec, mesh, train_cfg, rules, arch=arch)
                trips = scan_trip_count(cfg)
                one, two = (trace_cell(cell_for(cut_depth(cfg, k), spec, mesh, train_cfg, rules,
                                                arch=arch)) for k in TRIPS)
        transfers = {kind: {f: int(round(_extrapolate(one["transfers"][kind][f],
                                                      two["transfers"][kind][f], trips)))
                            for f in ("count", "bytes")}
                     for kind in ("gather", "scatter")}
        record.update(
            status="ok",
            trace_s=round(one["seconds"] + two["seconds"], 2),
            flops_home=float(_extrapolate(one["flops"], two["flops"], trips)),
            memory={
                "argument_bytes": _slot_bytes(cell.in_specs, cell.in_shardings),
                "output_bytes": _slot_bytes(_output_specs(cell), cell.out_shardings),
                "temp_bytes": int(round(_extrapolate(one["temp"], two["temp"], trips))),
                "alias_bytes": None,
            },
            transfers=transfers,
            transfer_bytes=sum(t["bytes"] for t in transfers.values()),
            loop_scale=trips,
            traced_trips=list(TRIPS),
            time_cut=TIME_CUT,
            flash_cut=FLASH_CUT,
            n_chips=mesh.size,
            params_total=cfg.param_count(),
            params_active=cfg.active_param_count(),
            tokens=spec.global_batch * spec.seq_len,
            step_kind=spec.kind,
            train_round_batch=(cell.train_cfg.round_batch if cell.train_cfg else None),
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    _write(record, out_dir)
    return record


def _write(record: dict, out_dir: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{record['tag']}" if record["tag"] else ""
        fn = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}"
                                   f"{suffix}.json")
        with open(fn, "w") as f:
            json.dump(record, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="dry run of every cell on the meta device")
    ap.add_argument("--arch", default=None, choices=list(ARCHS), help="one architecture")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--rules", default="default", choices=list(RULE_PRESETS))
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "fp8"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--cached", action="store_true", help="lazy loglik cache train step")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all and not args.arch and not args.shape:
        ap.error("pass --all or select --arch/--shape")

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name == "multi", args.out,
                               rules_name=args.rules, kv_dtype=args.kv_dtype,
                               tag=args.tag, cached=args.cached)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" flops/home={rec['flops_home']:.3e}"
                             f" transfers={rec['transfer_bytes']:.3e}B"
                             f" args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB"
                             f" temp={rec['memory']['temp_bytes'] / 2**30:.2f}GiB"
                             f" trace={rec['trace_s']}s")
                elif status == "error":
                    failures += 1
                    extra = " " + rec["error"][:160]
                print(f"[{status:7s}] {arch} x {shape} x {mesh_name}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
