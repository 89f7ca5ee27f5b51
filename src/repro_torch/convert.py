"""Carry the JAX package's state across into the port.

The counterpart of loading weights: the BayesLR data pool, a batch of chain
positions theta (K, D), the stochastic-volatility data (obs, h_true) and
theta ``{phi, sigma2, h}``, the joint DP mixture's data and state, an LM's parameter tree, its
decode cache and an Adam state over it, the ``ce`` family's data (hidden states and next tokens), and the samplers' state (the
stream's ``pos``; the Fisher–Yates ``idx``/``pos``/``size``; one state per component of a
composite cycle) and a serving resident's checkpointed state, each handed
over as numpy arrays and built into the port's types on a given device. Taking numpy keeps this module free of JAX:
call ``np.asarray`` on the reference's arrays first (``jax.tree.map`` for a
tree).
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.ensemble import EnsembleState
from .core.samplers import FisherYatesState, StreamSliceState
from .experiments.bayeslr import LRData
from .experiments.jointdpm import JDPMData, JDPMState, augment
from .experiments.stochvol import SVData
from .inference.niw import ClusterStats


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)  # a copy: the port owns it


def _i32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=dev)


_BIT_TYPES = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _float_leaf(a, dev) -> torch.Tensor:
    """A float array as a tensor of the same float type: bfloat16 and
    float8_e4m3fn (numpy's ``ml_dtypes`` types, recognised by name) keep
    their bits, float32 and float16 convert as they are."""
    a = np.asarray(a)
    if a.dtype.name in _BIT_TYPES:
        int_type, torch_type = _BIT_TYPES[a.dtype.name]
        bits = np.ascontiguousarray(a).view(int_type)
        return torch.from_numpy(bits.copy()).view(torch_type).to(dev)
    return torch.tensor(a, device=dev)


def lr_data(x_train, y_train, x_test=None, y_test=None, w_true=None, *, device=None) -> LRData:
    """An :class:`LRData` from numpy arrays (test split and w_true optional)."""
    dev = resolve_device(device)
    x, y = _f32(x_train, dev), _f32(y_train, dev)
    xt = x[:0] if x_test is None else _f32(x_test, dev)
    yt = y[:0] if y_test is None else _f32(y_test, dev)
    w = torch.zeros(x.shape[1], device=dev) if w_true is None else _f32(w_true, dev)
    return LRData(x, y, xt, yt, w)


def sampler_state(kind: str, n: int, *, pos, idx=None, size=None, device=None):
    """A sampler state from the reference's arrays: ``kind="stream"`` takes
    ``pos``; ``kind="fy"`` takes ``idx``, ``pos`` and ``size``. Leading
    chain axes are kept as given."""
    dev = resolve_device(device)
    if kind == "stream":
        return StreamSliceState(_i32(pos, dev), int(n))
    if kind == "fy":
        if idx is None:
            raise ValueError("the Fisher–Yates state needs its idx buffer")
        return FisherYatesState(_i32(idx, dev), _i32(pos, dev),
                                _i32(n if size is None else size, dev))
    raise ValueError(f"unknown sampler kind: {kind!r}")


def ensemble_state(theta, kind: str, n: int, *, pos, idx=None, size=None,
                   device=None) -> EnsembleState:
    """An :class:`EnsembleState` from theta (K, ...) and the batched sampler
    arrays (leading (K,) axis)."""
    dev = resolve_device(device)
    return EnsembleState(_f32(theta, dev),
                         sampler_state(kind, n, pos=pos, idx=idx, size=size, device=dev))


def sv_data(obs, h_true, *, device=None) -> SVData:
    """An :class:`SVData` from the (S, T) observations and latent paths."""
    dev = resolve_device(device)
    return SVData(_f32(obs, dev), _f32(h_true, dev))


def sv_theta(theta, *, device=None) -> dict:
    """Stochvol theta ``{phi, sigma2, h}`` (with or without a leading (K,)
    chain axis on every leaf) as float32 tensors."""
    dev = resolve_device(device)
    return {name: _f32(theta[name], dev) for name in ("phi", "sigma2", "h")}


def jdpm_data(x, y, x_test, y_test, *, device=None) -> JDPMData:
    """A :class:`JDPMData` from the (N, D) points, (N,) labels in {-1, +1}
    and the test split, with the w move's pool [x, 1] built once."""
    dev = resolve_device(device)
    x_t = _f32(x, dev)
    return JDPMData(x_t, _f32(y, dev), _f32(x_test, dev), _f32(y_test, dev), augment(x_t))


def jdpm_state(z, w, alpha, n, sum_x, sum_xxt, *, device=None) -> JDPMState:
    """A :class:`JDPMState` from the reference's state (``state.z``,
    ``state.w``, ``state.alpha`` and the three leaves of ``state.stats``),
    with or without a leading (K,) replica axis on every leaf: z int32, the
    rest float32."""
    dev = resolve_device(device)
    return JDPMState(z=_i32(z, dev), w=_f32(w, dev), alpha=_f32(alpha, dev),
                     stats=ClusterStats(_f32(n, dev), _f32(sum_x, dev), _f32(sum_xxt, dev)))


def cycle_samplers(states, *, device=None) -> tuple:
    """Per-component sampler states of a composite cycle, as the reference's
    ``init_cycle_samplers`` lays them out (leading chain axes kept): a
    Fisher–Yates state is a triple ``(idx, pos, size)``, a stream state a
    pair ``(pos, n)``, a sweep's placeholder a bare int array."""
    dev = resolve_device(device)
    out = []
    for st in states:
        if isinstance(st, tuple) and len(st) == 3:
            idx, pos, size = st
            out.append(sampler_state("fy", np.asarray(idx).shape[-1], pos=pos, idx=idx,
                                     size=size, device=dev))
        elif isinstance(st, tuple) and len(st) == 2:
            pos, n = st
            out.append(sampler_state("stream", int(np.asarray(n).reshape(-1)[0]), pos=pos,
                                     device=dev))
        else:
            out.append(_i32(st, dev))
    return tuple(out)


def lm_params(tree, *, device=None) -> dict:
    """An LM parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as the port's tree of
    tensors, each leaf in its own float type (bf16 or float32)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params(v, device=dev) for k, v in tree.items()}
    return _float_leaf(tree, dev)


def adam_state(state, *, device=None):
    """The reference's ``AdamState`` (``mu`` and ``nu`` trees, ``count``; as
    numpy: ``jax.tree.map(np.asarray, state)``) as the port's
    :class:`repro_torch.optim.AdamState`: float32 moments, an int32 count."""
    from .optim import AdamState

    dev = resolve_device(device)

    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        return _f32(tree, dev)

    return AdamState(mu=moments(state.mu), nu=moments(state.nu),
                     count=_i32(np.asarray(state.count).reshape(()), dev))


def lm_cache(tree, *, device=None):
    """The reference's decode cache (``prefill``'s or ``init_cache``'s, as
    numpy: ``jax.tree.map(np.asarray, cache)``) as the port's, every bit
    kept: a dense cache's k/v in bf16 or fp8 and ``pos``/``len`` as int32;
    an ssm cache's ``m`` and ``s`` tuples of float32 states."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_cache(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(lm_cache(v, device=dev) for v in tree)
    a = np.asarray(tree)
    return _i32(a, dev) if a.dtype.kind in "iu" else _float_leaf(a, dev)


def ce_data(h, targets, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``ce`` family's data: hidden states h (N, D) in their float type
    (bf16 or float32) and next tokens (N,) as int32."""
    dev = resolve_device(device)
    h_t = h if isinstance(h, torch.Tensor) else _float_leaf(h, dev)
    t_t = targets if isinstance(targets, torch.Tensor) else _i32(targets, dev)
    return h_t.to(dev).reshape(-1, h_t.shape[-1]), t_t.to(dev, torch.int32).reshape(-1)


def resident_state(flat: dict, *, seed: int = 0, device=None) -> dict:
    """A serving resident's state from the reference's: ``flat`` holds the
    leaves of a reference ``ResidentEnsemble.state_dict()`` as numpy, keyed
    as the reference's checkpoint names them (``theta``, ``sampler__0``,
    ``controller__...``, ``draws...``, ``steps_done``, ``key_data``), e.g.
    one resident's subtree of a reference checkpoint. Returns the leaves
    :meth:`repro_torch.serving.ResidentEnsemble.load_flat` takes: the same
    names and arrays, with ``gen_state`` in place of ``key_data``. A JAX key
    cannot become a generator's state, so the chains go on from a fresh
    generator seeded with ``seed`` on ``device`` (the device the resident
    runs on): theta, sampler state, controller and window carry over, the
    random stream does not."""
    dev = resolve_device(device)
    out = {name: np.asarray(leaf) for name, leaf in flat.items() if name != "key_data"}
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out["gen_state"] = gen.get_state().numpy().copy()
    return out
