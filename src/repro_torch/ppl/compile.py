"""Lower a (trace, variable) pair to the tensorized ``core.PartitionedTarget``.

The port of ``repro.ppl.compile``: the bridge between the PET graph (Defs.
1–8) and the tensor interface the MH kernels consume. The scaffold is
computed symbolically on the graph, partitioned at the border node, and the
local sections, stored structure-of-arrays inside a ``Plate``, are scored by
one vectorized log-density evaluation per mini-batch.

Emission goes through :func:`repro_torch.core.target_builder.build_target`:
when the plate's local score matches a registered kernel family, the
``logit`` observation factor (a ``BernoulliLogits`` node fed by an inner
product of a plate-constant feature matrix with the target variable) or the
``gaussian_ar1`` state-space plate (Normal transition factors
``x_t ~ N(phi * x_{t-1}, sigma)`` with the target variable as the AR
coefficient), the compiled target carries the family's
``log_local_ensemble``, so a K-chain ensemble's rounds run the family's
CUDA kernel; otherwise the generic graph-evaluated target is emitted. Every
match is double-gated: a structural check on the scaffold plus a numeric
probe of the opaque deterministic node, so a near-miss (a clipped inner
product, a saturating AR mean) compiles to the generic path instead of
silently changing the model. The probes draw from ``torch.Generator`` s
seeded 0, 1, 2 on the trace's device, so their values differ from the
reference's; the gates' decisions are the reference's.

As in the reference, the graph-evaluated ``log_local`` is kept on a family
match, so one chain's rounds (and the exact pass) evaluate the graph; the
family's kernel route is the K-chain ``log_local_ensemble``.

``log_global`` and ``log_density`` take one chain's theta, shaped like the
variable's value, or a batch of chains with leading axes: the chain axes
are theta's beyond the value's, and each node's log density is summed over
its own axes only, so K chains give (K,) (the ensemble's contract), never
one sum over all chains.

Restrictions enforced here mirror the paper's Sec. 3.1 assumptions:
T(rho, v) = ∅ and all local sections attach through a single border node.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.target import PartitionedTarget
from ..core.target_builder import build_target
from . import dists
from .trace import Node, Plate, Trace, border_node, partition, scaffold


def _topo(nodes) -> list[Node]:
    return sorted(nodes, key=lambda n: n.nid)  # eager build ⇒ nid order is topological


def _event_sum(logp, batch_shape) -> torch.Tensor:
    """Sum a log density over its own axes, keeping the leading chain axes
    ``batch_shape`` where it carries them."""
    logp = torch.as_tensor(logp)
    nb = len(batch_shape)
    if nb and tuple(logp.shape[:nb]) == tuple(batch_shape):
        return logp.reshape(tuple(batch_shape) + (-1,)).sum(-1)
    return logp.sum()


class _Evaluator:
    """Re-evaluates scaffold nodes under a substituted value for v.

    env maps nid -> overridden value. Plate-member values carry a leading
    section axis; evaluating with ``idx`` gathers rows of stacked values, so
    deterministic recomputation and scoring are vectorized over the batch.
    """

    def __init__(self, trace: Trace, v: Node, plate: Plate | None, sc):
        self.trace, self.v, self.plate = trace, v, plate
        self.det_global = _topo(
            n for n in sc.D if n.kind == "deterministic" and n.plate is None
        )
        self.det_local = _topo(
            n for n in sc.nodes if n.kind == "deterministic" and n.plate is not None
        )
        # scoring nodes: stochastic members of the scaffold (v's prior + absorbers)
        self.score_global = _topo(
            n
            for n in sc.nodes
            if n.kind == "stochastic" and n.plate is None and n is not v
        )
        self.score_local = _topo(
            n for n in sc.nodes if n.kind == "stochastic" and n.plate is not None
        )

    def _val(self, node: Node, env: dict, idx):
        val = env.get(node.nid, node.value)
        if idx is not None and node.plate is not None and node.nid not in env:
            val = val[idx]
        return val

    def batch_shape(self, theta) -> tuple:
        """theta's chain axes: its leading axes beyond v's value."""
        return tuple(theta.shape[: theta.ndim - self.v.value.ndim])

    def global_score(self, theta) -> Any:
        batch = self.batch_shape(theta)
        env = {self.v.nid: theta}
        for n in self.det_global:
            env[n.nid] = n.fn(*[self._val(p, env, None) for p in n.parents])
        v = self.v
        out = _event_sum(v.dist.logpdf(theta, *[self._val(p, env, None) for p in v.parents]),
                         batch)
        for n in self.score_global:
            params = [self._val(p, env, None) for p in n.parents]
            out = out + _event_sum(n.dist.logpdf(self._val(n, env, None), *params), batch)
        return out

    def local_score(self, theta, idx) -> Any:
        env = {self.v.nid: theta}
        for n in self.det_global:
            env[n.nid] = n.fn(*[self._val(p, env, None) for p in n.parents])
        for n in self.det_local:
            env[n.nid] = n.fn(*[self._val(p, env, idx) for p in n.parents])
        out = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        for n in self.score_local:
            params = [self._val(p, env, idx) for p in n.parents]
            out = out + n.dist.logpdf(self._val(n, env, idx), *params)
        return out


def _probe(shape, dtype, device, seed: int, scale: float) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return scale * torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _close(got, want, scale: float) -> bool:
    got, want = np.asarray(got.detach().cpu()), np.asarray(want.detach().cpu())
    return got.shape == want.shape and np.allclose(got, want, rtol=1e-5,
                                                   atol=1e-6 * max(scale, 1.0))


# Two unit-scale probes plus a large-magnitude one: the latter pushes the
# logits (or AR means) far outside typical ranges, so saturating or clipped
# variants of the linear form fail the gate instead of being misclassified.
_PROBES = ((0, 1.0), (1, 1.0), (2, 1e3))


def _match_logit_family(ev: _Evaluator, v: Node):
    """Does the plate's local score match the ``logit`` kernel family?

    Structural check: exactly one local scoring node with a
    ``BernoulliLogits`` distribution over {-1, +1} labels, fed by exactly one
    plate-local deterministic node whose parents are a plate-constant feature
    matrix and the target variable v. The deterministic function itself is
    opaque (an arbitrary Python callable), so its inner-product form is
    verified *numerically* on random probe weights — a wrong match here would
    silently change the model, so both gates must pass.

    Returns the family data ``(x, y)`` or None.
    """
    if len(ev.score_local) != 1 or len(ev.det_local) != 1 or ev.det_global:
        return None
    y_node = ev.score_local[0]
    if not isinstance(y_node.dist, dists.BernoulliLogits):
        return None
    if len(y_node.parents) != 1 or y_node.parents[0] is not ev.det_local[0]:
        return None
    z = ev.det_local[0]
    if len(z.parents) != 2:
        return None
    pa, pb = z.parents
    candidates = []
    if pa.kind == "constant" and pa.plate is not None and pb is v:
        candidates.append((pa, lambda xx, ww: z.fn(xx, ww)))
    if pb.kind == "constant" and pb.plate is not None and pa is v:
        candidates.append((pb, lambda xx, ww: z.fn(ww, xx)))
    for x_node, apply_fn in candidates:
        x, y, w0 = x_node.value, y_node.value, v.value
        if x.ndim != 2 or y.ndim != 1 or tuple(w0.shape) != (x.shape[1],):
            continue
        if not bool(torch.all((y == 1.0) | (y == -1.0))):
            continue
        probe_rows = x[: min(32, x.shape[0])]
        if all(_close(apply_fn(probe_rows, w), probe_rows @ w, scale)
               for w, scale in ((_probe(w0.shape, w0.dtype, w0.device, seed, scale), scale)
                                for seed, scale in _PROBES)):
            return x.contiguous(), y.contiguous()
    return None


def _match_gaussian_ar1_family(ev: _Evaluator, v: Node):
    """Does the plate's local score match the ``gaussian_ar1`` state-space
    family?  The target shape is an AR(1) transition plate

        x_t ~ Normal(phi * x_{t-1}, sigma),   t in plate,

    with v the (scalar) AR coefficient phi: exactly one local scoring node
    with a ``Normal`` distribution whose scale is a plate-less positive
    constant, fed by exactly one plate-local deterministic node whose parents
    are a plate-constant lag series and v. As with the logit gate, the
    deterministic function is opaque, so its ``phi * x_prev`` form is
    verified numerically on random probe coefficients (including a
    large-magnitude probe that rules out saturating/clipped means).

    Returns ``(data, params_fn)`` for
    :func:`repro_torch.core.target_builder.build_target` — ``data = (x_t,
    x_prev)`` and ``params_fn`` mapping theta to the family's
    ``(phi, sigma^2)`` — or None.
    """
    if len(ev.score_local) != 1 or len(ev.det_local) != 1 or ev.det_global:
        return None
    x_node = ev.score_local[0]
    if not isinstance(x_node.dist, dists.Normal):
        return None
    if len(x_node.parents) != 2 or x_node.parents[0] is not ev.det_local[0]:
        return None
    scale_node = x_node.parents[1]
    if scale_node.kind != "constant" or scale_node.plate is not None:
        return None
    sigma = scale_node.value
    if sigma.ndim != 0 or not bool(sigma > 0):
        return None
    z = ev.det_local[0]
    if len(z.parents) != 2:
        return None
    pa, pb = z.parents
    candidates = []
    if pa.kind == "constant" and pa.plate is not None and pb is v:
        candidates.append((pa, lambda xx, ph: z.fn(xx, ph)))
    if pb.kind == "constant" and pb.plate is not None and pa is v:
        candidates.append((pb, lambda xx, ph: z.fn(ph, xx)))
    for xp_node, apply_fn in candidates:
        xp, xt, phi0 = xp_node.value, x_node.value, v.value
        if xp.ndim != 1 or xt.shape != xp.shape or phi0.shape != ():
            continue
        probe_rows = xp[: min(32, xp.shape[0])]
        if all(_close(apply_fn(probe_rows, ph), probe_rows * ph, scale)
               for ph, scale in ((_probe((), phi0.dtype, phi0.device, seed, scale), scale)
                                 for seed, scale in _PROBES)):
            s2 = torch.tensor(float(sigma) ** 2, dtype=torch.float32, device=xt.device)

            def params_fn(theta):
                # The kernels take per-chain (phi, s2) of matching shape, as
                # contiguous tensors: the constant variance at theta's
                # (possibly (K,)-batched) shape.
                return theta, s2.expand(theta.shape).contiguous()

            return (xt.contiguous(), xp.contiguous()), params_fn
    return None


def compile_partitioned_target(trace: Trace, v: Node) -> PartitionedTarget:
    """Scaffold → border-node partition → kernel-family detection →
    :func:`repro_torch.core.target_builder.build_target`."""
    sc = scaffold(trace, v)
    global_nodes, plate = partition(trace, sc)
    del global_nodes  # evaluator re-derives roles from the scaffold
    if plate is None:
        raise ValueError(
            f"scaffold of {v} has no plate-shaped local sections; use exact MH"
        )
    b = border_node(trace, sc)
    del b
    ev = _Evaluator(trace, v, plate, sc)
    n_sections = plate.size

    def log_global(theta, theta_p):
        return ev.global_score(theta_p) - ev.global_score(theta)

    def log_local(theta, theta_p, idx):
        return ev.local_score(theta_p, idx) - ev.local_score(theta, idx)

    def log_density(theta):
        batch = ev.batch_shape(theta)
        if batch:  # the graph scores one chain: stack the chains' densities
            flat = theta.reshape((-1,) + tuple(theta.shape[len(batch):]))
            return torch.stack([log_density(t) for t in flat]).reshape(batch)
        idx = torch.arange(n_sections, dtype=torch.int32, device=trace.device)
        return ev.global_score(theta) + ev.local_score(theta, idx).sum()

    family, family_data, params_fn = None, None, None
    logit_data = _match_logit_family(ev, v)
    if logit_data is not None:
        family, family_data = "logit", logit_data
    else:
        ar1 = _match_gaussian_ar1_family(ev, v)
        if ar1 is not None:
            family, (family_data, params_fn) = "gaussian_ar1", ar1
    return build_target(
        family,
        family_data,
        n_sections,
        log_global=log_global,
        # The graph-evaluated log_local is kept even on a family match (it
        # agrees with the family's delta and exercises the scaffold
        # machinery); the family contributes the (K, m) log_local_ensemble.
        log_local=log_local,
        log_density=log_density,
        params_fn=params_fn,
    )
