"""Driver of the LM posterior cells: ``repro_torch.bayes.make_train_step``'s
subsampled MH step, back to back on a resident pool of sequences.

The model and its pool are the cell's, fixed like a deployed model and its
corpus: drawn on the device from the configuration's ``weights_seed`` and the
traffic's ``pool_seed``. ``--seed`` drives the chain: set-up builds the
step and runs ``burn_in_steps`` steps through the window's own call on the
chain generator of ``--seed`` (the first builds the round op's kernel;
cuBLAS picks its algorithms). The window's steps then draw from the
traffic's ``window_seed``: a step's cost is its test's rounds, 1 to 16 at
0.25 s each, and a window holds only ~17 steps, so a chain of the seed's own
draws would make each seed's window a different amount of work (0.29 to 0.48
steps/s on an H100 over six seeds, each seed within 2% of itself); so every
seed's window does the same work, from a state its own burn-in moved.

The first ``check_steps`` burn-in steps are the steps the reference
follows. What each hands on is recorded at the step's documented factoring
(``bayes.train``: ``propose`` hands theta' and log u to the test): theta',
each round's deltas as the test gets them (``sequential_test``'s
evaluation), each section's log-likelihood under theta and under theta'
(``forward_loglik``, told apart by the theta' that ``propose`` handed on),
the step's info, and a sample of theta, theta' and the new state. The window
runs the same call until ``--seconds`` have passed and ends at the last
step's synchronize. After it the program's state is freed; the parameters
are drawn again, each checked step's theta' is made again by the program's
``propose`` from the generator state the step started from (and held to the
recorded sample), and the reference (``reference/lm_chain.py``) judges the
proposal by its rule, the prior's log ratio in float64, each evaluated
section's log-likelihood by the plain float32 forward (``reference/glm.py``)
and the test on the step's own deltas.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from mcmcbench.lib import inputs
from mcmcbench.reference import glm, seqtest
from mcmcbench.reference.lm_chain import Chain, draw_log_u, flat, move_z, rw_proposal

SAMPLE_PER_LEAF = 4096  # state elements compared a leaf a checked step
PERM_LIMIT = 1 << 24  # leaves up to this size are sampled without replacement


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    sizes: dict
    traffic: dict
    params: object = None
    batch: dict | None = None
    step: object = None
    tc: object = None
    gen: torch.Generator | None = None
    checked: list = dataclasses.field(default_factory=list)  # the checked steps' outputs
    sample_idx: dict = dataclasses.field(default_factory=dict)


def _sample_idx(params, seed, device) -> dict:
    """The state elements compared, a fixed sample a leaf drawn from the seed."""
    g = inputs.generator(torch.device("cpu"), seed, "check-sample")

    def pick(n):
        if n <= PERM_LIMIT:
            return torch.randperm(n, generator=g)[:SAMPLE_PER_LEAF]
        return torch.randint(0, n, (SAMPLE_PER_LEAF,), generator=g)

    return {p: pick(leaf.numel()).to(device) for p, leaf in flat(params).items()}


def _sample(params, idx: dict) -> dict:
    return {p: leaf.reshape(-1)[idx[p]].float().cpu() for p, leaf in flat(params).items()}


def setup(cell, seed, device) -> State:
    from repro_torch.bayes import train as bt
    from repro_torch.models.transformer import ModelConfig

    sizes = inputs.dense_sizes(cell.config)
    tr = cell.traffic
    post = cell.config["posterior"]
    st = State(cell, seed, device, sizes, tr)
    layout = inputs.dense_layout(sizes, cell.config["assumed"]["init_std"])
    st.params = inputs.draw_params(layout, cell.config["assumed"]["weights_seed"], device)
    st.batch = inputs.markov_pool(tr["pool_seed"], tr["pool"], tr["seq_len"], sizes["vocab"],
                                  tr["concentration"], device)
    st.tc = bt.TrainConfig(round_batch=tr["round_batch"], epsilon=post["epsilon"],
                           sigma=post["sigma"], prior_var=post["prior_var"])
    st.step = bt.make_train_step(ModelConfig(**sizes), st.tc)
    st.gen = inputs.generator(device, seed, "chain")
    st.sample_idx = _sample_idx(st.params, seed, device)
    orig = bt.propose, bt.sequential_test, bt.forward_loglik
    rec: dict = {}

    def recording_propose(*args, **kw):
        theta_p, log_u = orig[0](*args, **kw)
        rec["theta_p"] = theta_p
        return theta_p, log_u

    def recording_test(gen, mu0, draw_fn, eval_fn, *args, **kw):
        def ev(idx, *aux):
            out = eval_fn(idx, *aux)
            rec["deltas"].append((out[0] if aux else out).detach().double().cpu())
            return out

        return orig[1](gen, mu0, draw_fn, ev, *args, **kw)

    def recording_ll(params, *args, **kw):
        out = orig[2](params, *args, **kw)
        under_p = params is rec.get("theta_p")
        rec["ll_theta_p" if under_p else "ll_theta"].append(out.detach().double().cpu())
        return out

    for i in range(tr["burn_in_steps"]):
        record = i < tr["check_steps"]
        if record:
            rec.clear()
            rec.update(deltas=[], ll_theta=[], ll_theta_p=[])
            before = _sample(st.params, st.sample_idx)
            gen_state = st.gen.get_state()
            bt.propose, bt.sequential_test, bt.forward_loglik = (
                recording_propose, recording_test, recording_ll)
        try:
            st.params, info = st.step(st.gen, st.params, st.batch)
        finally:
            bt.propose, bt.sequential_test, bt.forward_loglik = orig
        if record:
            out = {k: getattr(info, k).detach().double().cpu().item() for k in info._fields}
            cat = lambda xs: torch.cat(xs).numpy() if xs else np.zeros(0)
            out.update({k: cat(rec[k]) for k in ("deltas", "ll_theta", "ll_theta_p")})
            out["gen_state"], out["before"] = gen_state, before
            out["theta_p"] = (_sample(rec["theta_p"], st.sample_idx) if "theta_p" in rec
                              else None)
            out["state"] = _sample(st.params, st.sample_idx)
            st.checked.append(out)
            rec.clear()
    st.gen = inputs.generator(device, tr["window_seed"], "chain")
    return st


def _steps(st: State, t0: float, more) -> dict:
    """Steps while ``more(elapsed, steps)``; each step's end on the host clock
    (a step ends on the host's read of its decision)."""
    infos, ends = [], []
    while True:
        st.params, info = st.step(st.gen, st.params, st.batch)
        infos.append(torch.stack([info.n_evaluated.float(), info.rounds.float()]))
        ends.append(time.perf_counter())
        if not more(ends[-1] - t0, len(infos)):
            break
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    window = time.perf_counter() - t0
    n_eval, rounds = (torch.stack(infos).cpu().long().T.tolist())
    return {"window_s": window, "attempted": len(n_eval), "failed": 0, "steps": len(n_eval),
            "n_evaluated": n_eval, "rounds": rounds,
            "step_s": [float(x) for x in np.diff([t0] + ends)], "pool": st.traffic["pool"],
            "round_batch": st.traffic["round_batch"], "seq_len": st.traffic["seq_len"],
            "sizes": st.sizes}


def window(st: State, seconds: float) -> dict:
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return _steps(st, time.perf_counter(), lambda elapsed, n: elapsed < seconds)


def segment(st: State) -> dict:
    return _steps(st, time.perf_counter(), lambda elapsed, n: n < st.traffic["trace_steps"])


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def _release(st: State) -> None:
    st.params = st.step = st.gen = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _share_differing(a: dict, b: dict) -> float:
    n_diff = sum(int((a[p] != b[p]).sum()) for p in a)
    return n_diff / sum(v.numel() for v in a.values())


def check_numbers(ref: Chain, program: list, sample_idx: dict, handed_on) -> dict:
    """The numbers compared, each the worst over the checked steps; the
    reference follows the program's theta' (``handed_on(i, theta)`` makes
    step i's again) and decisions from one step to the next."""
    glm.no_tf32()
    n_total, rb = ref.tr["pool"], ref.tr["round_batch"]
    eps, sigma = ref.post["epsilon"], ref.post["sigma"]
    worst = {k: 0.0 for k in ("lm.ll", "lm.delta", "lm.prior", "lm.theta_p", "lm.propose",
                              "lm.count", "lm.mu", "lm.stop", "lm.decision", "lm.state")}
    for i, out in enumerate(program):
        if out["theta_p"] is None:  # no theta' handed on: nothing of the step can be followed
            worst["lm.theta_p"] = 1.0
            break
        theta_p = handed_on(i, ref.theta)
        worst["lm.theta_p"] = max(worst["lm.theta_p"],
                                  _share_differing(_sample(theta_p, sample_idx), out["theta_p"]),
                                  _share_differing(_sample(ref.theta, sample_idx), out["before"]))
        worst["lm.propose"] = max(worst["lm.propose"], move_z(out["before"], out["theta_p"], sigma))
        sq_p, g = ref.prior(theta_p)
        print(f"checked step {i}: rounds {int(out['rounds'])} n_evaluated "
              f"{int(out['n_evaluated'])} accepted {bool(out['accepted'])} mu_hat "
              f"{out['mu_hat']!r} mu0 {out['mu0']!r} prior {g!r}", file=sys.stderr)
        n_eval = int(out["n_evaluated"])
        d_prog = np.asarray(out["deltas"], np.float64)
        lp_ref, lc_ref = ref.logliks(theta_p, max(n_eval, len(d_prog)))
        d_ref = lp_ref - lc_ref
        for mine, theirs in ((out["ll_theta_p"], lp_ref), (out["ll_theta"], lc_ref)):
            if len(mine) != len(theirs):
                worst["lm.count"] = max(worst["lm.count"], abs(len(mine) - len(theirs)) + 1.0)
            k = min(len(mine), len(theirs))
            if k:
                worst["lm.ll"] = max(worst["lm.ll"], float(np.max(np.abs(mine[:k] - theirs[:k]))))
        if len(d_prog) != len(d_ref):
            worst["lm.count"] = max(worst["lm.count"], abs(len(d_prog) - len(d_ref)) + 1.0)
            k = min(len(d_prog), len(d_ref))
            d_prog, d_ref = d_prog[:k], d_ref[:k]
        if len(d_ref):
            worst["lm.delta"] = max(worst["lm.delta"], float(np.max(np.abs(d_prog - d_ref))))
        g_prog = out["log_u"] - out["mu0"] * n_total
        worst["lm.prior"] = max(worst["lm.prior"], abs(g_prog - g))
        full = np.full((1, n_total), np.nan)
        full[0, :len(d_prog)] = d_prog
        held = seqtest.hold(full, np.array([out["mu0"]]), eps, rb, n_total,
                            [int(out["rounds"])], [n_eval], [out["mu_hat"]],
                            [bool(out["accepted"])])
        for k in ("count", "mu", "stop", "decision"):
            worst["lm." + k] = max(worst["lm." + k], float(held[k]))
        ref.advance(bool(out["accepted"]), theta_p, sq_p)
        worst["lm.state"] = max(worst["lm.state"],
                                _share_differing(_sample(ref.theta, sample_idx), out["state"]))
        del theta_p
    return worst


def check(st: State) -> dict:
    from repro_torch.bayes import train as bt

    program, idx, tc = st.checked, st.sample_idx, st.tc
    _release(st)
    device = st.device

    def handed_on(i, theta):  # the program's own theta' of checked step i, made again
        gen = torch.Generator(device=device)
        gen.set_state(program[i]["gen_state"])
        return bt.propose(gen, theta, tc)[0]

    return check_numbers(Chain(st.cell, device), program, idx, handed_on)


def fp8_weights(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at 448), as float32: the control's weights."""
    t = t.to(torch.float32)
    scale = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _control_propose(gen, theta: dict, sigma: float):
    """The control's log u and theta': the random walk, theta' kept in
    float8 (carried in the leaves' bfloat16)."""
    log_u = draw_log_u(gen, next(iter(flat(theta).values())).device)
    theta_p = rw_proposal(gen, theta, sigma)
    for leaf in flat(theta_p).values():
        leaf.copy_(fp8_weights(leaf))
    return log_u, theta_p


def control(cell, seed, device, seconds) -> dict:
    """The control in the program's place: the reference's steps, each stage
    in the precision below the program's: theta' kept in float8 and every
    weight in float8 in the forward (the configuration states bfloat16), the
    prior's totals and the test's running mean and standard error in
    bfloat16 (the program's are float32); its own test on its own deltas,
    held to the reference by the cell's numbers."""
    del seconds  # no window: the control's steps are the checked steps themselves
    glm.no_tf32()
    ctrl = Chain(cell, device, weight_cast=fp8_weights)
    tr, post = ctrl.tr, ctrl.post
    n_total, rb = tr["pool"], tr["round_batch"]
    sample_idx = _sample_idx(ctrl.theta, seed, device)
    gen = inputs.generator(device, seed, "chain")
    outputs = []
    for _ in range(tr["check_steps"]):
        gen_state, before = gen.get_state(), _sample(ctrl.theta, sample_idx)
        log_u, theta_p = _control_propose(gen, ctrl.theta, post["sigma"])
        sq_p, g = ctrl.prior(theta_p, total_round=seqtest.bf16)
        mu0 = (log_u - g) / n_total
        lls = []

        def round_deltas(r):
            lp, lc = ctrl.logliks(theta_p, min((r + 1) * rb, n_total), r * rb)
            lls.append((lp, lc))
            return lp - lc

        rounds, n_eval, mean, acc, seen = seqtest.sequential(
            round_deltas, mu0, post["epsilon"], rb, n_total, stat_round=seqtest.bf16)
        outputs.append({"log_u": log_u, "mu0": mu0, "mu_hat": mean, "rounds": rounds,
                        "n_evaluated": n_eval, "accepted": acc, "deltas": seen,
                        "ll_theta_p": np.concatenate([a for a, _ in lls]),
                        "ll_theta": np.concatenate([b for _, b in lls]),
                        "gen_state": gen_state, "before": before,
                        "theta_p": _sample(theta_p, sample_idx)})
        ctrl.advance(acc, theta_p, sq_p)
        outputs[-1]["state"] = _sample(ctrl.theta, sample_idx)
        del theta_p
    del ctrl
    gc.collect()

    def handed_on(i, theta):
        g = torch.Generator(device=device)
        g.set_state(outputs[i]["gen_state"])
        return _control_propose(g, theta, post["sigma"])[1]

    return check_numbers(Chain(cell, device), outputs, sample_idx, handed_on)
