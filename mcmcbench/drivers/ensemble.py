"""Driver of the chain-ensemble cells: ``repro_torch.core.ChainEnsemble`` on
the BayesLR posterior, advanced by ``run`` in calls of the configuration's
``num_steps`` transitions a chain (a user's job is one such call) on one
device generator.

Set-up takes the cell's data set (fixed, its rows in an order drawn from
the seed) and draws the chains' starting points (the posterior's Laplace
approximation) from the seed, builds
the target (``experiments.bayeslr.make_target``) and the ensemble, and runs
``burn_in_steps`` transitions a chain through the window's own entry (the
kernels are built and the tuner's races run there). The window runs whole
calls and ends at the synchronize after the call whose end lies nearest
``--seconds`` (at least one call); every transition of the window is an
answer.

The check holds every transition of the window to the reference: log u and
theta' from the chain generator's draws in the ensemble's order (each step,
u for all K chains, then their (K, D) noise), the new state (theta' if the
program accepted, else theta), and mu0 from the prior's log ratio in
float64. A sample of transitions drawn from the seed is held whole: its
deltas over every row in float64 (``reference/logistic.py``) and the
sequential test on them (``reference/seqtest.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from mcmcbench.lib import inputs
from mcmcbench.reference import logistic, seqtest


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    ens: object = None
    state: object = None
    gen: torch.Generator | None = None
    theta_start: torch.Tensor | None = None  # the window's first state (K, D)
    samples: list = dataclasses.field(default_factory=list)  # (K, num_steps, D) a call
    infos: list = dataclasses.field(default_factory=list)


def _data(cell, seed, device):
    """The cell's data set, fixed as the paper's is (drawn from the
    configuration's ``data.seed``), its training rows in the order of
    ``--seed``: the stream sampler reads them in that order."""
    d = cell.config["data"]
    x, y, xt, yt = inputs.synth_mnist_like(d["seed"], d["n_train"], d["n_test"], d["d"], device)
    perm = torch.randperm(d["n_train"], generator=inputs.generator(device, seed, "rows"),
                          device=device)
    return x[perm], y[perm], xt, yt


def setup(cell, seed, device) -> State:
    from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig
    from repro_torch.experiments.bayeslr import make_target

    tr, post = cell.traffic, cell.config["posterior"]
    x, y, _, _ = _data(cell, seed, device)
    target = make_target(x, y, prior_var=post["prior_var"])
    cfg = SubsampledMHConfig(batch_size=tr["round_batch"], epsilon=post["epsilon"],
                             sampler=tr["sampler"])
    st = State(cell, seed, device)
    st.ens = ChainEnsemble(target, RandomWalk(post["sigma"]), tr["chains"], config=cfg,
                           stepping=tr["stepping"], device=device)
    theta0 = inputs.laplace_starts(x, y, post["prior_var"], tr["chains"], tr["start_scale"], seed)
    st.state = st.ens.init(theta0, batched=True)
    st.gen = inputs.generator(device, seed, "chain")
    st.state, _, _ = st.ens.run(st.gen, st.state, tr["burn_in_steps"])
    st.theta_start = st.state.theta
    return st


def _call(st: State):
    st.state, samples, infos = st.ens.run(st.gen, st.state, st.cell.config["num_steps"])
    st.samples.append(samples)
    st.infos.append(infos)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return infos


def _launches() -> int:
    from repro_torch.kernels import ops

    return int(ops.launches["t_test_round"])


def _stats(st: State, infos: list, t0: float, l0: int) -> dict:
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    window = time.perf_counter() - t0
    n_eval = torch.cat([i.n_evaluated for i in infos], dim=1) if infos else torch.zeros(0)
    k, t = n_eval.shape if n_eval.ndim == 2 else (0, 0)
    return {"window_s": window, "attempted": k * t, "failed": 0, "transitions": k * t,
            "supersteps": _launches() - l0, "n_evaluated_sum": float(n_eval.double().sum()),
            "num_sections": st.cell.config["data"]["n_train"],
            "dim": st.cell.config["data"]["d"]}


def window(st: State, seconds: float) -> dict:
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    infos = []
    l0 = _launches()
    t0 = time.perf_counter()
    while True:  # whole calls; stop at the call boundary nearest ``seconds``
        infos.append(_call(st))
        elapsed = time.perf_counter() - t0
        if elapsed + 0.5 * elapsed / len(infos) >= seconds:
            break
    return _stats(st, infos, t0, l0)


def segment(st: State) -> dict:
    """``trace_steps`` transitions a chain, each pair-delta launch's shape
    and distinct rows counted for the roofline: the rows marked in a
    preallocated (N,) mask and summed on the device, three small launches
    beside each pair delta and no allocation."""
    from repro_torch.kernels import ops

    d, tr = st.cell.config["data"], st.cell.traffic
    mark = torch.zeros(d["n_train"], dtype=torch.int32, device=st.device)
    counts = torch.zeros(1 << 16, dtype=torch.int64, device=st.device)
    shapes = []
    orig = ops.gather_and_delta

    def recording(x, y, idx, *args, **kw):
        i = len(shapes) % counts.numel()
        mark.zero_()
        mark.index_fill_(0, idx.reshape(-1).long().clamp(0, mark.numel() - 1), 1)
        torch.sum(mark, dim=0, out=counts[i])
        shapes.append(tuple(idx.shape))
        return orig(x, y, idx, *args, **kw)

    ops.gather_and_delta = recording
    try:
        l0 = _launches()
        t0 = time.perf_counter()
        state, _, infos = st.ens.run(st.gen, st.state, tr["trace_steps"])
        st.state = state
        stats = _stats(st, [infos], t0, l0)
    finally:
        ops.gather_and_delta = orig
    rows = counts[:len(shapes)].tolist()
    stats.update(pair_delta_calls=[(s, r) for s, r in zip(shapes, rows)], dim=d["d"])
    return stats


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def program_outputs(st: State) -> dict:
    """The window's transitions as the program gave them: theta before and
    after (K, T, D), and each info field (K, T)."""
    after = torch.cat(st.samples, dim=1)
    before = torch.cat([st.theta_start[:, None], after[:, :-1]], dim=1)
    infos = {f: torch.cat([getattr(i, f) for i in st.infos], dim=1) for f in st.infos[0]._fields}
    return {"before": before, "after": after, "infos": infos,
            "first_step": st.cell.traffic["burn_in_steps"]}


def check_numbers(cell, seed, device, prog: dict, outputs_of=None) -> dict:
    """The numbers compared. ``outputs_of(before, theta_p, mu0, rows)``, when
    given, replaces the program's outputs of the sampled transitions with
    the control's."""
    tr, post, data = cell.traffic, cell.config["posterior"], cell.config["data"]
    n_total, m, eps = data["n_train"], tr["round_batch"], post["epsilon"]
    before, after, infos, t0 = prog["before"], prog["after"], prog["infos"], prog["first_step"]
    k, t, _ = before.shape
    all_log_u, xi = logistic.replay_draws(inputs.generator(device, seed, "chain"), k,
                                          data["d"], t0 + t)
    log_u = all_log_u[t0:].T  # (K, T)
    theta_p = before + post["sigma"] * xi[t0:].transpose(0, 1)
    acc = infos["accepted"].bool()
    expect = torch.where(acc[..., None], theta_p, before)
    g = logistic.log_prior_ratio(before, theta_p, post["prior_var"])
    mu0 = (log_u.double() - g) / n_total
    out = {"lr.log_u": float((infos["log_u"] - log_u).abs().max()),
           "lr.state": float((after - expect).abs().max())}
    # the sample held whole: every row's delta and the test on them
    gen = inputs.generator(torch.device("cpu"), seed, "check-sample")
    n_sample = min(tr["check_transitions"], k * t)
    pick = torch.randperm(k * t, generator=gen)[:n_sample].to(before.device)
    kk, tt = pick // t, pick % t
    x, y, _, _ = _data(cell, seed, device)
    b, tp, mu0_s = before[kk, tt], theta_p[kk, tt], mu0[kk, tt]
    d_ref = logistic.deltas(x, y, b, tp).cpu().numpy()
    if outputs_of is None:
        sel = {f: v[kk, tt].double().cpu().numpy() for f, v in infos.items()}
    else:
        sel = outputs_of(x, y, b, tp, mu0_s)
    mu0_prog = infos["mu0"].double() if outputs_of is None else \
        torch.as_tensor(np.asarray(sel["mu0"]), dtype=torch.float64, device=mu0.device)
    out["lr.prior"] = float(((mu0_prog - (mu0 if outputs_of is None else mu0_s)).abs()
                             * n_total).max())
    held = seqtest.hold(d_ref, mu0_s.cpu().numpy(), eps, m, n_total, sel["rounds"],
                        sel["n_evaluated"], sel["mu_hat"], sel["accepted"])
    out.update({"lr." + key: float(v) for key, v in held.items()})
    return out


def check(st: State) -> dict:
    prog = program_outputs(st)
    cell, seed, device = st.cell, st.seed, st.device
    st.ens = st.state = st.gen = None
    gc.collect()
    return check_numbers(cell, seed, device, prog)


def control(cell, seed, device, seconds) -> dict:
    """The control: the program's window at the cell's load gives the
    transitions; on the sampled ones the reference in the program's place,
    each stage in the precision below the configuration's float32: the
    products' operands rounded to TF32 (the program's kernel keeps TF32
    off), the prior's sums of squares and the test's running mean and
    standard error in bfloat16; it runs its own test, and the cell's numbers
    hold it to the float64 reference."""
    st = setup(cell, seed, device)
    window(st, seconds)
    prog = program_outputs(st)
    st.ens = st.state = st.gen = None
    gc.collect()
    tr, post, n_total = cell.traffic, cell.config["posterior"], cell.config["data"]["n_train"]

    def outputs_of(x, y, before, theta_p, mu0):
        d = logistic.deltas(x, y, before, theta_p, round_operands=logistic.tf32).cpu().numpy()
        sq = lambda w: seqtest.bf16(w.double().square().sum(-1).cpu().numpy())
        g = -0.5 / post["prior_var"] * (sq(theta_p) - sq(before))
        log_u = mu0.cpu().numpy() * n_total + logistic.log_prior_ratio(
            before, theta_p, post["prior_var"]).cpu().numpy()
        out = {"rounds": [], "n_evaluated": [], "mu_hat": [], "accepted": [],
               "mu0": (log_u - g) / n_total}
        m = tr["round_batch"]
        for row, mu in zip(d, out["mu0"]):
            r, n, mean, acc, _ = seqtest.sequential(lambda i: row[i * m:(i + 1) * m], float(mu),
                                                    post["epsilon"], m, n_total,
                                                    stat_round=seqtest.bf16)
            for key, v in zip(("rounds", "n_evaluated", "mu_hat", "accepted"), (r, n, mean, acc)):
                out[key].append(v)
        return out

    return check_numbers(cell, seed, device, prog, outputs_of)
