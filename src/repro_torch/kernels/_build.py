"""Build the hand kernels at first use and load them through ``ctypes``.

Every ``*.cu`` file under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (route (b): no PyTorch headers,
so a build takes seconds). All sources are compiled together, one ``nvcc``
process each, into ``build/repro_torch_kernels/<hash>/`` at the repository
root (``$REPRO_TORCH_BUILD_DIR`` overrides the root), where ``<hash>`` covers
the sources and the flags. A library that is already there is loaded as is.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a nonzero value through :func:`check`.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ENV_VAR = "REPRO_TORCH_BUILD_DIR"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: every multiply and add rounds on its own, as the plain
# versions' separate tensor operations do, so kernel and plain version
# agree to the last bits wherever their order of summation agrees.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "--fmad=false", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class _Slot(threading.local):
    slot = None
    racing = False
    round_shape = None


_SLOT = _Slot()
# Launches made while a thread scores a mesh slot's piece of a round, by
# (slot position, kernel name): the same launches LAUNCHES counts, seen per
# slot (repro_torch.distributed.sharding.split_round sets the slot).
SLOT_LAUNCHES: collections.Counter = collections.Counter()


# Launches made by the launch-parameter tuner's races (repro_torch.kernels.
# autotune), by kernel name: kept apart so that LAUNCHES counts the work.
RACE_LAUNCHES: collections.Counter = collections.Counter()


class _Launches(collections.Counter):
    def __setitem__(self, name, n):
        if _SLOT.racing:
            RACE_LAUNCHES[name] += n - self[name]
            return
        slot = _SLOT.slot
        if slot is not None:
            SLOT_LAUNCHES[(slot, name)] += n - self[name]
        super().__setitem__(name, n)


# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; a run sets them to 0 and reads them afterwards.
LAUNCHES: collections.Counter = _Launches()


def enter_slot(slot, round_shape=None):
    """Attribute this thread's launches to mesh slot ``slot``, a piece of
    a round of ``round_shape`` (K, m), until :func:`leave_slot`; returns
    what it replaces."""
    prev = (_SLOT.slot, _SLOT.round_shape)
    _SLOT.slot, _SLOT.round_shape = slot, round_shape
    return prev


def leave_slot(prev) -> None:
    _SLOT.slot, _SLOT.round_shape = prev


def round_shape():
    """(K, m) of the whole round whose piece this thread's mesh slot
    scores, or None outside a slot: a kernel whose launch parameters follow
    the grid chooses them for the whole round, so that a piece's bits are
    the whole launch's."""
    return _SLOT.round_shape


class racing:
    """``with racing():`` counts this thread's launches under
    :data:`RACE_LAUNCHES` in place of :data:`LAUNCHES`."""

    def __enter__(self):
        self._prev, _SLOT.racing = _SLOT.racing, True
        return self

    def __exit__(self, *exc):
        _SLOT.racing = self._prev
build_log: dict[str, str] = {}  # nvcc/ptxas output per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    root = os.environ.get(BUILD_ENV_VAR)
    base = Path(root) if root else Path(__file__).resolve().parents[3] / "build"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return base / "repro_torch_kernels" / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that is not built yet, all in parallel."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    with _lock:
        if stem not in _libs:
            path = build_all() / f"lib{stem}.so"
            _libs[stem] = ctypes.CDLL(str(path))
        return _libs[stem]


def launch(fn, device, *args) -> int:
    """``fn(*args)``, a kernel's C entry point, with ``device``'s card
    current. The runtime launches into the calling thread's current card,
    so where that is another card (tensors of cuda:1 from a thread on
    cuda:0) the tensors' card is made current for the call and the thread's
    own restored after it; otherwise the check is one device query."""
    import torch

    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def reset_launches() -> None:
    LAUNCHES.clear()
    SLOT_LAUNCHES.clear()


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
FL = ctypes.c_float


def ptr(t) -> P:
    return P(None if t is None else t.data_ptr())


def stream_of(t) -> P:
    import torch

    return P(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, device, dtypes, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of one of
    ``dtypes`` with ``shape`` (None entries match any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.ndim != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
