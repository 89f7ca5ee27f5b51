"""Launch-parameter tuner for the hand kernels, with a winner cache on disk:
the port of ``repro.kernels.autotune``.

The reference tunes its Pallas kernels' block sizes per backend. The port's
kernels are CUDA sources whose launch parameters were fixed by heuristic;
this module races a small grid of them per *kernel family* the first time a
(family, shape bucket) is dispatched on a card, and caches the winner on
disk keyed by ``(card, family, shape bucket)``, so later processes go
straight to it. The five families are the reference's:

  ``logit_delta``       the pair delta of one chain (``csrc/logit_delta.cu``),
  ``batched_loglik``    the same kernel over K chains (and its gather),
  ``gaussian_ar1``      the AR(1) delta (``csrc/gaussian_ar1_delta.cu``),
  ``fused_ce``          the CE kernel of one chain (``csrc/fused_ce.cu``),
  ``batched_fused_ce``  the same kernel over K chains (and its gather).

**The bit rule.** Every candidate must give its family's default bits: a
run's numbers may not depend on which candidate won on which machine. So
only parameters that leave each output's order of arithmetic alone are
candidates: warps a block of the pair delta and of the AR(1) delta. The two
CE families have a grid of one, their default: their one such parameter,
the depth of the shared-memory ring, moved the kernel's time by 0.2% at
most on an H100, and the vocabulary split (``tile_v``) is not one, since it
sets the order in which the splits' partials merge. While it races, the
tuner holds every candidate's output to the default's, bit for bit, and
raises on a difference; it never drops a candidate.

Knobs:

* ``REPRO_AUTOTUNE=1`` forces tuning on, ``REPRO_AUTOTUNE=0`` pins the
  defaults (:data:`DEFAULT_TILES`; 0 means the source's own heuristic).
  Unset or ``auto`` tunes for CUDA tensors only: CPU tensors take the plain
  versions, which have no launch parameters.
* ``REPRO_AUTOTUNE_DIR`` relocates the cache; the default is
  ``~/.cache/repro_torch/autotune``. The file is ``<card>.json``, the card
  being the device's name and compute capability. Each winner carries the
  hash of the kernel sources it was raced on (the name of the build's
  directory, :func:`repro_torch.kernels._build.build_dir`); a winner of
  other sources is raced again. A cache directory that cannot be written
  keeps the winner in memory for this process.
* Shapes are bucketed to powers of two as the reference's are; the race runs
  at the shape of the call that first reaches a bucket.
* Races are timed with CUDA events over a loop of launches queued behind a
  sleep kernel (best of three): one launch of a few microseconds is below
  what a host clock resolves. Their launches count under
  :data:`race_launches`, never under ``ops.launches``. A resolved bucket is
  read from a plain dict with no lock; a lock guards a miss (the disk, the
  race), so serving lanes whose bucket is known never wait on a race.

Consulted by :mod:`repro_torch.kernels.ops` on the kernel route, in every
wrapper that launches one of the five kernels; explicit launch keyword
arguments win over the tuner. ``python -m repro_torch.kernels.autotune``
tunes the representative buckets (:func:`warm`) on the card.
"""
from __future__ import annotations

import functools
import json
import os
import re
import threading
import time
from typing import Any, Callable

import torch

from . import _build

ENV_VAR = "REPRO_AUTOTUNE"
DIR_ENV_VAR = "REPRO_AUTOTUNE_DIR"

#: What ``REPRO_AUTOTUNE=0`` pins, and the first candidate of every grid: 0
#: is the source's own choice (the pair delta: 4 warps a block; the AR(1)
#: delta: warps by how many fill the SMs once). The two CE families have a
#: grid of one, their default, and no launch parameter (see above).
DEFAULT_TILES: dict[str, dict[str, int]] = {
    "logit_delta": {"warps": 0},
    "batched_loglik": {"warps": 0},
    "gaussian_ar1": {"warps": 0},
    "fused_ce": {},
    "batched_fused_ce": {},
}

_PAIR_GRID = ({"warps": 0},) + tuple({"warps": w} for w in (1, 2, 8))  # 4 is the default

CANDIDATES: dict[str, tuple[dict[str, int], ...]] = {
    "logit_delta": _PAIR_GRID,
    "batched_loglik": _PAIR_GRID,
    "gaussian_ar1": ({"warps": 0},) + tuple({"warps": w} for w in (1, 2, 4, 8)),
    "fused_ce": ({},),
    "batched_fused_ce": ({},),
}

_lock = threading.Lock()
_memory_cache: dict[str, dict[str, Any]] = {}
_loaded_cards: set[str] = set()
# (family, device, bucket) -> tiles: what tiles_for resolved, read with no lock
_resolved: dict[tuple, dict[str, int]] = {}
race_launches = _build.RACE_LAUNCHES  # launches made by races, by kernel name
# races run in this process, their wall time and their cache keys in order
race_stats: dict[str, Any] = {"races": 0, "seconds": 0.0, "keys": []}


def enabled(device=None) -> bool:
    """Tune? ``REPRO_AUTOTUNE`` 1/0 forces; unset or ``auto`` tunes for
    tensors on a CUDA device (``device=None``: whether a card is present)."""
    env = os.environ.get(ENV_VAR, "auto").lower()
    if env in ("0", "false", "off", "never"):
        return False
    if env in ("1", "true", "on", "always"):
        return True
    if device is None:
        return torch.cuda.is_available()
    return (device if isinstance(device, torch.device) else torch.device(device)).type == "cuda"


def cache_dir() -> str:
    return os.environ.get(DIR_ENV_VAR) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune")


def card_name(device=None) -> str:
    """The cache's name for a device: the card's name and compute capability
    (``"NVIDIA H100 80GB HBM3 sm_90"``), or ``"cpu"``."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available() else
                       (device or "cpu"))
    if dev.type != "cuda":
        return dev.type
    return _card(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.cache
def _card(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def _sources() -> str:
    """The hash of the kernel sources (and nvcc flags) a winner was raced on."""
    return _build.build_dir().name


def _cache_path(card: str) -> str:
    return os.path.join(cache_dir(), re.sub(r"[^A-Za-z0-9_.-]+", "_", card) + ".json")


def clear_cache(memory_only: bool = False) -> None:
    """Forget tuned winners (tests; or after a toolchain upgrade): in memory,
    and unless ``memory_only`` the cache files of the cache directory."""
    with _lock:
        _memory_cache.clear()
        _loaded_cards.clear()
        _resolved.clear()
    if memory_only:
        return
    d = cache_dir()
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.endswith(".json"):
                os.remove(os.path.join(d, name))


def _load_disk(card: str) -> None:
    if card in _loaded_cards:
        return
    _loaded_cards.add(card)
    try:
        with open(_cache_path(card)) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return
    src = _sources()  # a winner of other kernel sources is raced again
    _memory_cache.update({k: e for k, e in entries.items() if e.get("sources") == src})


def _save_disk(card: str) -> None:
    path = _cache_path(card)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        entries = {k: v for k, v in _memory_cache.items() if k.startswith(f"{card}|")}
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only directory: the in-memory winner still applies


def _bucket(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def cache_key(family: str, shape: tuple[int, ...], card: str | None = None) -> str:
    """``"<card>|<family>|<bucket>"``, the shape's dims rounded up to powers
    of two (the reference's buckets)."""
    bucket = "x".join(str(_bucket(int(d))) for d in shape)
    return f"{card_name() if card is None else card}|{family}|{bucket}"


def _device_us(fn: Callable[[], Any], reps: int | None = None) -> float:
    """Device µs of one ``fn()``: best of three loops of ``reps`` calls
    queued behind a sleep kernel, timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = max(time.perf_counter() - t0, 1e-6)
    if reps is None:
        reps = int(min(100, max(3, 2e-3 / host_s)))
    best = float("inf")
    for attempt in range(3):
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        # ~3x the enqueueing at <= 2 GHz, doubled each time the host was slower
        torch.cuda._sleep(int(3 * 2 ** attempt * host_s * reps * 2e9))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e3 / reps)
    return best


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _race(family: str, run: Callable[[dict], torch.Tensor],
          timer: Callable[[Callable[[], Any]], float] = _device_us,
          candidates: tuple[dict[str, int], ...] | None = None) -> dict:
    """Race ``candidates`` (the family's grid): ``run(cand)`` launches the
    kernel with those parameters and returns its output; ``timer(fn)``
    gives µs. Every candidate's output must equal the default's bit for bit:
    a difference raises. Returns the cache entry."""
    cands = CANDIDATES[family] if candidates is None else candidates
    default = DEFAULT_TILES[family]
    want = run(default)
    timings = []
    for cand in cands:
        got = run(cand)
        if not _same_bits(got, want):
            raise RuntimeError(
                f"autotune: {family} with {cand} gives other bits than the default "
                f"{default}: no candidate may change a kernel's bits")
        timings.append((timer(lambda c=cand: run(c)), cand))
    best_us, best = min(timings, key=lambda tc: tc[0])
    return {"tiles": dict(best), "us": best_us, "candidates": len(timings),
            "default_us": next((us for us, c in timings if c == default), None),
            "bitwise": True}


def _synth_run(family: str, shape: tuple[int, ...], device) -> Callable[[dict], torch.Tensor]:
    """A launcher of ``family``'s kernel on random inputs at ``shape`` on
    ``device``, in the form the main path calls it: gathered rows for a
    round, a contiguous run for a long pass; fp32 pools."""
    from . import batched_loglik, gaussian_ar1, logit_loglik

    gen = torch.Generator(device=device).manual_seed(0)
    f32 = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    pm1 = lambda *s: torch.where(f32(*s) > 0, 1.0, -1.0)  # noqa: E731
    rows = lambda k, m, n: torch.randint(0, n, (k, m), generator=gen, device=device,  # noqa: E731
                                         dtype=torch.int32)
    if family == "logit_delta":
        m, d = shape
        if m >= 1 << 16:  # a full pass: the contiguous form
            x, y, w, wp = f32(m, d), pm1(m), f32(d), f32(d)
            return lambda c: logit_loglik.logit_delta(x, y, w, wp, idx=range(0, m), **c)
        n = max(4 * m, 4096)
        x, y, w, wp, idx = f32(n, d), pm1(n), f32(d), f32(d), rows(1, m, n)[0]
        return lambda c: logit_loglik.logit_delta(x, y, w, wp, idx=idx, **c)
    if family == "batched_loglik":
        k, m, d = shape
        n = max(4 * k * m, 4096)
        x, y, w, wp, idx = f32(n, d), pm1(n), f32(k, d), f32(k, d), rows(k, m, n)
        return lambda c: batched_loglik.gather_and_delta(x, y, idx, w, wp, **c)
    if family == "gaussian_ar1":
        k, m = shape
        par = [f32(k) * 0.1 + 0.9, f32(k).abs() + 0.01, f32(k) * 0.1 + 0.9, f32(k).abs() + 0.01]
        if k == 1 and m > 512:  # an exact pass: a contiguous run of the pools
            xt, xp = f32(m), f32(m)
            return lambda c: gaussian_ar1.gather_ar1_delta(xt, xp, range(0, m), *par, **c)
        n = max(4 * m, 1000)
        xt, xp, idx = f32(k, n), f32(k, n), rows(k, m, n)
        return lambda c: gaussian_ar1.gather_ar1_delta(xt, xp, idx, *par, **c)
    raise KeyError(f"no race for kernel family {family!r}")


def _benchmark(family: str, shape: tuple[int, ...], device) -> dict:
    """Race the family's grid at ``shape`` on the CUDA ``device``; return the
    cache entry (with the race's launches and seconds)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"autotune races the hand kernels on a CUDA device, not {dev}")
    t0 = time.perf_counter()
    before = sum(race_launches.values())
    with _build.racing(), torch.cuda.device(dev):
        entry = _race(family, _synth_run(family, shape, dev))
    torch.cuda.synchronize(dev)
    entry["shape"] = [int(s) for s in shape]
    entry["race_launches"] = sum(race_launches.values()) - before
    entry["race_s"] = time.perf_counter() - t0
    return entry


def tiles_for(family: str, shape: tuple[int, ...], device=None) -> dict[str, int]:
    """The launch parameters to dispatch ``family`` with at ``shape`` on
    ``device``: the defaults where tuning is off or the grid is one, else
    the cached winner, racing the grid on first use."""
    if family not in DEFAULT_TILES:
        raise KeyError(f"unknown kernel family {family!r}")
    if len(CANDIDATES[family]) == 1 or not enabled(device):
        return dict(DEFAULT_TILES[family])
    dev = device if isinstance(device, torch.device) else torch.device(
        device if device is not None else "cuda" if torch.cuda.is_available() else "cpu")
    bucket = tuple(_bucket(int(d)) for d in shape)
    tiles = _resolved.get((family, dev, bucket))
    if tiles is None:
        with _lock:
            card = card_name(dev)
            key = cache_key(family, shape, card)
            _load_disk(card)
            entry = _memory_cache.get(key)
            if entry is None:
                entry = _benchmark(family, tuple(int(s) for s in shape), dev)
                entry["sources"] = _sources()
                race_stats["races"] += 1
                race_stats["seconds"] += entry.get("race_s", 0.0)
                race_stats["keys"].append(key)
                _memory_cache[key] = entry
                _save_disk(card)
            tiles = _resolved[(family, dev, bucket)] = dict(entry["tiles"])
    return dict(tiles)


WARM_SHAPES: dict[str, list[tuple[int, ...]]] = {  # the CE families' grids are one
    "logit_delta": [(4096, 64)],
    "batched_loglik": [(8, 256, 64)],
    "gaussian_ar1": [(8, 1024)],
}
_WARM_FULL = {"logit_delta": (65536, 64), "batched_loglik": (64, 512, 64),
              "gaussian_ar1": (64, 4096)}


def warm(families: tuple[str, ...] | None = None, fast: bool = True, device=None) -> dict:
    """Tune representative buckets of each family with a grid to race (the
    reference's shapes; ``fast=False`` adds a larger one)."""
    out = {}
    for family in families or tuple(WARM_SHAPES):
        shapes = list(WARM_SHAPES[family])
        if not fast and family in _WARM_FULL:
            shapes.append(_WARM_FULL[family])
        for shape in shapes:
            out[cache_key(family, shape, card_name(device))] = tiles_for(family, shape, device)
    return out


if __name__ == "__main__":
    os.environ.setdefault(ENV_VAR, "1")
    for k, tiles in warm().items():
        print(f"{k}: {tiles}")
    print(f"cache: {_cache_path(card_name())}")
