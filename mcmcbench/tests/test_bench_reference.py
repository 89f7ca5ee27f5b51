"""The plain reference against the port at reduced widths on the CPU: the
GLM's log-likelihoods, the logistic deltas, the sequential test, and the
draws the control and the BayesLR check replay."""
import numpy as np
import torch

from mcmcbench.lib import inputs
from mcmcbench.reference import glm, lm_chain, logistic, seqtest
from mcmcbench.tests import tiny

CPU = torch.device("cpu")


def _tiny_lm(dtype=torch.float32):
    cell = tiny.lm_cell()
    sizes = inputs.dense_sizes(cell.config)
    layout = inputs.dense_layout(sizes, cell.config["assumed"]["init_std"])
    return cell, sizes, layout, inputs.draw_params(layout, 11, CPU, dtype=dtype)


def test_layout_is_the_ports():
    from repro_torch.models.transformer import ModelConfig, param_specs

    _, sizes, layout, _ = _tiny_lm()
    flat = lm_chain.flat(param_specs(ModelConfig(**sizes)))
    assert {p: tuple(s.shape) for p, s in flat.items()} == {p: s for p, (s, _) in layout.items()}


def test_glm_loglik_against_the_port_forward():
    from repro_torch.models.transformer import ModelConfig, forward_loglik

    cell, sizes, _, params = _tiny_lm(torch.float32)
    pool = inputs.markov_pool(4, 6, 12, sizes["vocab"], 0.3, CPU)
    port = forward_loglik(params, pool, ModelConfig(**sizes), ce_chunk=256).double()
    ref = glm.loglik(params, pool["tokens"], sizes).double()
    assert torch.allclose(port, ref, rtol=1e-5, atol=1e-4), (port - ref).abs().max()


def test_proposal_replay_is_the_ports_draws():
    """The order the program draws its random walk in, as the control's
    ``rw_proposal`` writes it: a contract of the control alone; no check of
    a run reads it."""
    from repro_torch.bayes import train as bt

    _, _, _, params = _tiny_lm(torch.bfloat16)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    port = lm_chain.flat(bt._tree_rw_propose(g1, params, 1e-2))
    mine = lm_chain.flat(lm_chain.rw_proposal(g2, params, 1e-2))
    assert all(torch.equal(port[p], mine[p]) for p in port)


def test_move_z_against_the_ports_proposal():
    from repro_torch.bayes import train as bt

    _, _, _, params = _tiny_lm(torch.bfloat16)
    tc = bt.TrainConfig(sigma=1e-3)
    theta_p, _ = bt.propose(torch.Generator().manual_seed(8), params, tc)
    before, after = lm_chain.flat(params), lm_chain.flat(theta_p)
    assert lm_chain.move_z(before, after, 1e-3) < 5.0
    assert lm_chain.move_z(before, after, 5e-4) > 20.0
    assert lm_chain.move_z(before, after, 2e-3) > 20.0
    assert lm_chain.move_z(before, before, 1e-3) > 20.0


def test_logistic_deltas_against_the_port():
    from repro_torch.kernels import ops

    x, y, _, _ = inputs.synth_mnist_like(3, 300, 10, 7, CPU)
    w, w_p = torch.randn(4, 7) * 0.3, torch.randn(4, 7) * 0.3
    idx = torch.randint(0, 300, (4, 20), dtype=torch.int32)
    port = ops.gather_and_delta(x, y, idx, w, w_p, mode="never").double()
    ref = logistic.deltas(x, y, w, w_p)
    assert torch.allclose(port, torch.gather(ref, 1, idx.long()), atol=1e-5)


def test_sequential_test_against_the_port():
    from repro_torch.core import make_sampler, sequential_test

    rng = np.random.default_rng(0)
    n, m = 1000, 50
    for mu0 in (-0.05, 0.0, 0.02, 0.3):
        d = rng.normal(0.03, 0.5, n).astype(np.float32)
        state0, reset, draw = make_sampler("stream", n, device="cpu")
        res = sequential_test(None, torch.tensor(mu0), draw,
                              lambda idx: torch.from_numpy(d)[idx.long()], reset(state0),
                              n, m, 0.05)
        held = seqtest.hold(d[None].astype(np.float64), np.array([mu0]), 0.05, m, n,
                            [int(res.rounds)], [int(res.n_evaluated)], [float(res.mu_hat)],
                            [bool(res.decision)])
        assert held["count"] == 0 and held["decision"] == 0
        assert held["mu"] < 1e-3 and held["stop"] < 0.07
        r, n_eval, mean, acc, _ = seqtest.sequential(lambda i: d[i * m:(i + 1) * m], mu0,
                                                     0.05, m, n)
        assert (r, n_eval, acc) == (int(res.rounds), int(res.n_evaluated), bool(res.decision))
