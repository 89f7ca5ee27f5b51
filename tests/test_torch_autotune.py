"""The launch-parameter tuner (``repro_torch.kernels.autotune``) on the CPU:
its switches, its cache (memory, disk, a directory it cannot write), its
keys against the reference's ``repro.kernels.autotune.cache_key``, the bit
rule of the race, and ``ops``' consultation of it in every wrapper that
launches one of the five tuned kernels. The race itself needs the card: it
is replaced here by an injected one, and held on the card in
``tests/test_torch_cuda.py``."""
import json
import os
import threading

import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro_torch.kernels import autotune, ops

FAMILIES = ("logit_delta", "batched_loglik", "gaussian_ar1", "fused_ce", "batched_fused_ce")


@pytest.fixture
def tuner(monkeypatch, tmp_path):
    """Tuning forced on, the cache in a fresh directory, the race replaced by
    one that returns each family's last candidate and counts its calls."""
    monkeypatch.setenv(autotune.ENV_VAR, "1")
    monkeypatch.setenv(autotune.DIR_ENV_VAR, str(tmp_path / "cache"))
    autotune.clear_cache(memory_only=True)
    races = []

    def fake(family, shape, device):
        races.append((family, tuple(shape), str(device)))
        return {"tiles": dict(autotune.CANDIDATES[family][-1]), "us": 1.0, "candidates": 1,
                "default_us": 2.0, "bitwise": True}

    monkeypatch.setattr(autotune, "_benchmark", fake)
    yield races
    autotune.clear_cache(memory_only=True)


def test_families_and_defaults(monkeypatch):
    """The reference's five family names; ``REPRO_AUTOTUNE=0`` pins the
    defaults (0: the source's own choice), the default is every grid's first
    candidate, the two CE families have a grid of one, and an unknown family
    raises ``KeyError``."""
    assert tuple(autotune.DEFAULT_TILES) == tuple(j_autotune.DEFAULT_TILES) == FAMILIES
    assert set(autotune.CANDIDATES) == set(FAMILIES)
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    assert not autotune.enabled() and not autotune.enabled("cuda")
    for family in FAMILIES:
        assert autotune.CANDIDATES[family][0] == autotune.DEFAULT_TILES[family]
        assert all(v == 0 for v in autotune.DEFAULT_TILES[family].values())
        assert autotune.tiles_for(family, (8, 8, 8, 8)[:2]) == autotune.DEFAULT_TILES[family]
        for cand in autotune.CANDIDATES[family]:
            assert set(cand) == set(autotune.DEFAULT_TILES[family])
    assert autotune.CANDIDATES["fused_ce"] == autotune.CANDIDATES["batched_fused_ce"] == ({},)
    with pytest.raises(KeyError):
        autotune.tiles_for("no_such_kernel", (1,))


def test_auto_races_nothing_for_cpu_tensors(monkeypatch, tmp_path):
    """Unset or ``auto``: CPU tensors take the plain versions and race
    nothing, through ``ops`` or asked directly."""
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    monkeypatch.setenv(autotune.DIR_ENV_VAR, str(tmp_path))
    calls = []
    monkeypatch.setattr(autotune, "_benchmark", lambda *a: calls.append(a))
    assert not autotune.enabled("cpu")
    assert autotune.tiles_for("gaussian_ar1", (32, 100), device="cpu") == {"warps": 0}
    x, y = torch.randn(50, 3), torch.ones(50)
    w = torch.randn(4, 3)
    idx = torch.randint(0, 50, (4, 10), dtype=torch.int32)
    ops.gather_and_delta(x, y, idx, w, w + 0.1)
    ops.logit_delta(x, y, w[0], w[1], idx=idx[0])
    ops.gather_ar1_delta(torch.randn(50), torch.randn(50), idx, *torch.rand(4, 4))
    monkeypatch.setenv(autotune.ENV_VAR, "auto")
    ops.gather_and_delta(x, y, idx, w, w + 0.1)
    assert calls == [] and not os.listdir(tmp_path)


def test_cache_memory_then_disk(tuner, tmp_path):
    """The first call races once and writes the card's JSON under
    ``cache_key``; the second is answered from memory; after
    ``clear_cache(memory_only=True)`` the disk answers; after a full
    ``clear_cache`` it races again."""
    shape = (32, 100, 50)
    winner = autotune.CANDIDATES["batched_loglik"][-1]
    assert autotune.tiles_for("batched_loglik", shape) == winner
    assert len(tuner) == 1
    assert autotune.tiles_for("batched_loglik", (30, 128, 64)) == winner  # same bucket
    assert len(tuner) == 1
    path = tmp_path / "cache" / "cpu.json"
    entries = json.loads(path.read_text())
    assert list(entries) == [autotune.cache_key("batched_loglik", shape, "cpu")]
    assert entries[autotune.cache_key("batched_loglik", shape, "cpu")]["tiles"] == winner
    autotune.clear_cache(memory_only=True)
    assert autotune.tiles_for("batched_loglik", shape) == winner
    assert len(tuner) == 1
    autotune.clear_cache()
    assert not path.exists()
    autotune.tiles_for("batched_loglik", shape)
    assert len(tuner) == 2


def test_winner_of_other_sources_is_raced_again(tuner, tmp_path):
    """A winner on disk carries the kernel sources' hash; one raced on other
    sources is not trusted: the bucket is raced again and the file rewritten."""
    shape = (32, 100)
    autotune.tiles_for("gaussian_ar1", shape)
    path = tmp_path / "cache" / "cpu.json"
    entries = json.loads(path.read_text())
    key = autotune.cache_key("gaussian_ar1", shape, "cpu")
    assert entries[key]["sources"] == autotune._sources()
    entries[key]["sources"] = "0" * 16
    path.write_text(json.dumps(entries))
    autotune.clear_cache(memory_only=True)
    autotune.tiles_for("gaussian_ar1", shape)
    assert len(tuner) == 2
    assert json.loads(path.read_text())[key]["sources"] == autotune._sources()


def test_resolved_bucket_needs_no_lock(tuner):
    """Once a bucket is resolved, a call answers with no lock: another
    thread holding the tuner's lock (as a race does) does not hold it up."""
    winner = autotune.CANDIDATES["batched_loglik"][-1]
    assert autotune.tiles_for("batched_loglik", (32, 100, 50)) == winner
    got = []
    with autotune._lock:
        t = threading.Thread(target=lambda: got.append(
            autotune.tiles_for("batched_loglik", (30, 99, 50))))
        t.start()
        t.join(timeout=10)
    assert got == [winner] and len(tuner) == 1


@pytest.mark.parametrize("family,shape", [
    ("logit_delta", (12214, 50)), ("logit_delta", (1, 3)), ("batched_loglik", (32, 100, 50)),
    ("batched_loglik", (32, 400, 50)), ("batched_loglik", (8, 100, 3)),
    ("gaussian_ar1", (32, 100)), ("gaussian_ar1", (1, 100000)),
    ("fused_ce", (100, 4096, 65024)), ("batched_fused_ce", (8, 100, 4096, 65024))])
def test_cache_key_buckets_match_reference(family, shape):
    """The key is ``<card>|<family>|<bucket>`` with the reference's
    powers-of-two buckets."""
    mine = autotune.cache_key(family, shape, "NVIDIA H100 80GB HBM3 sm_90")
    ref = j_autotune.cache_key(family, shape, "gpu")
    assert mine.split("|")[1:] == ref.split("|")[1:]
    assert mine.split("|")[0] == "NVIDIA H100 80GB HBM3 sm_90"


def test_read_only_cache_dir_keeps_the_winner(tuner, monkeypatch, tmp_path):
    """A cache directory that cannot be made keeps the winner in memory: no
    second race, nothing written."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(autotune.DIR_ENV_VAR, str(blocker / "cache"))
    winner = autotune.CANDIDATES["gaussian_ar1"][-1]
    assert autotune.tiles_for("gaussian_ar1", (32, 100)) == winner
    assert autotune.tiles_for("gaussian_ar1", (32, 100)) == winner
    assert len(tuner) == 1 and blocker.read_text() == "not a directory"


def test_explicit_launch_kwargs_win(tuner):
    """An explicit launch parameter is used as given, and the tuner is not
    asked; without one the tuner's winner is merged in; the CE families'
    own keyword arguments pass through their grid of one."""
    x = torch.zeros(4, 3)
    assert ops._tuned("batched_loglik", (4, 10, 3), x, {"warps": 8}) == {"warps": 8}
    assert ops._tuned("fused_ce", (10, 64, 256), x, {"tile_v": 256}) == {"tile_v": 256}
    assert tuner == []
    assert ops._tuned("batched_loglik", (4, 10, 3), x, {}) == \
        autotune.CANDIDATES["batched_loglik"][-1]
    assert len(tuner) == 1


def _fake_kernel(seen, name):
    def kernel(*args, **kw):
        seen.append((name, kw))
        return torch.zeros(1)
    return kernel


WRAPPERS = [  # (ops wrapper, the kernel name it reaches in ops, family, args, shape)
    ("logit_delta", "_logit_kernel", "logit_delta",
     lambda: (torch.randn(50, 3), torch.ones(50), torch.randn(3), torch.randn(3)),
     {"idx": torch.arange(7, dtype=torch.int32)}, (7, 3)),
    ("batched_logit_delta", "_batched_kernel", "batched_loglik",
     lambda: (torch.randn(4, 9, 3), torch.ones(4, 9), torch.randn(4, 3), torch.randn(4, 3)),
     {}, (4, 9, 3)),
    ("gather_and_delta", "_gather_kernel", "batched_loglik",
     lambda: (torch.randn(50, 3), torch.ones(50), torch.zeros(4, 9, dtype=torch.int32),
              torch.randn(4, 3), torch.randn(4, 3)), {}, (4, 9, 3)),
    ("batched_gaussian_ar1_delta", "_ar1_batched_kernel", "gaussian_ar1",
     lambda: (torch.randn(4, 9), torch.randn(4, 9), *torch.rand(4, 4)), {}, (4, 9)),
    ("gather_ar1_delta", "_ar1_gather_kernel", "gaussian_ar1",
     lambda: (torch.randn(50), torch.randn(50), range(3, 40), *torch.rand(4, 1)), {}, (1, 37)),
    ("fused_ce", "_ce_kernel", "fused_ce",
     lambda: (torch.randn(20, 8), torch.randn(33, 8), torch.zeros(20, dtype=torch.int32)),
     {"idx": torch.arange(5, dtype=torch.int32)}, (5, 8, 33)),
    ("batched_fused_ce", "_batched_ce_kernel", "batched_fused_ce",
     lambda: (torch.randn(2, 6, 8), torch.randn(2, 33, 8), torch.zeros(2, 6, dtype=torch.int32)),
     {}, (2, 6, 8, 33)),
    ("gather_fused_ce", "_gather_ce_kernel", "batched_fused_ce",
     lambda: (torch.randn(20, 8), torch.zeros(20, dtype=torch.int32),
              torch.zeros(2, 6, dtype=torch.int32), torch.randn(33, 8)), {}, (2, 6, 8, 33)),
]


@pytest.mark.parametrize("wrapper,kernel,family,args,kw,shape", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_every_tuned_wrapper_consults_the_tuner(tuner, monkeypatch, wrapper, kernel, family,
                                                args, kw, shape):
    """On the kernel route each of the eight wrappers asks the tuner for its
    family at its call's shape and hands the winner to the kernel (the
    route forced and the kernel stubbed: no kernel runs on the CPU); the CE
    families' grids are one, so nothing is raced for them."""
    seen, asked = [], []
    tiles_for = autotune.tiles_for
    monkeypatch.setattr(autotune, "tiles_for", lambda f, s, device=None: (
        asked.append((f, tuple(s))), tiles_for(f, s, device))[1])
    monkeypatch.setattr(ops, "use_kernel", lambda mode="auto", tensor=None: True)
    monkeypatch.setattr(ops, kernel, _fake_kernel(seen, kernel))
    getattr(ops, wrapper)(*args(), **kw)
    assert asked == [(family, shape)]
    raced = len(autotune.CANDIDATES[family]) > 1
    assert tuner == ([(family, shape, "cpu")] if raced else [])
    assert seen and seen[0][1].items() >= autotune.CANDIDATES[family][-1].items()


def _const(v):
    return lambda fn: v


def test_race_holds_every_candidate_to_the_default_bits():
    """The race picks the fastest candidate when every output equals the
    default's bit for bit, and raises on a candidate whose bits differ
    (here -0.0 against 0.0: equal as floats, other bits)."""
    base = torch.tensor([1.0, 0.0, -2.5])
    times = iter([5.0, 3.0, 4.0, 2.0, 6.0])
    entry = autotune._race("gaussian_ar1", lambda c: base.clone(), timer=lambda fn: next(times))
    assert entry["tiles"] == {"warps": 4} and entry["us"] == 2.0
    assert entry["default_us"] == 5.0 and entry["candidates"] == 5 and entry["bitwise"]

    def differs(c):
        out = base.clone()
        if c == {"warps": 4}:
            out[1] = -0.0
        return out

    with pytest.raises(RuntimeError, match="other bits than the default"):
        autotune._race("gaussian_ar1", differs, timer=_const(1.0))


def test_benchmark_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune._benchmark("gaussian_ar1", (4, 9), "cpu")


def test_dispatch_summary_names_autotune(monkeypatch):
    monkeypatch.setenv(autotune.ENV_VAR, "1")
    assert "autotune=on" in ops.dispatch_summary()
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    assert "autotune=off" in ops.dispatch_summary()
