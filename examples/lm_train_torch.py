"""End-to-end example on the port: train a small LM with Adam, then run
Bayesian inference over one parameter block with subsampled MH (hybrid
inference: an optimizer substrate plus MH, the paper's "interoperates with
other general-purpose inference"). The counterpart of
``examples/lm_train.py``.

Phase 1 — Adam (lr 2e-3) on Markov-chain synthetic data, the loss printed at
          every tenth of the steps; a checkpoint saved.
Phase 2 — subsampled MH over the final-norm block with the trained weights
          as the likelihood backbone, on a held-out pool of sequences, then
          exact MH from the same seed: acceptance, sections evaluated per
          transition and ms per transition. Each runs twice from one seed,
          timed and then collecting statistics; the two passes must agree
          bit for bit.

    PYTHONPATH=src python examples/lm_train_torch.py            # on the card
    PYTHONPATH=src python examples/lm_train_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/lm_train_torch.py --device cpu --steps 20

Randomness: MH step ``i`` draws from a generator seeded ``(7, i)`` by
``repro_torch.runtime.train_loop.step_generator``, where the reference folds
key 7 with ``i``; the port's initial weights and data are its own seeded
draws too. So the numbers match the reference's in distribution, not in bits.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, tree_leaves
from repro_torch.bayes import TrainConfig, make_exact_step, make_train_step
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data import DataConfig, MarkovStream
from repro_torch.kernels import ops
from repro_torch.models import init_params
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import adam_init, adam_step, lm_loss_fn
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.runtime.train_loop import step_generator

PRESETS = {
    "small": ModelConfig(name="lm-small", family="dense", n_layers=4, d_model=256,
                         n_heads=8, n_kv=4, d_ff=1024, vocab=2048, max_seq=256),
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12, d_model=768,
                        n_heads=12, n_kv=12, d_ff=3072, vocab=8192, max_seq=1024),
}
LR = 2e-3
MH_SEED = 7
POOL_STEP = 10_001  # the stream step whose batch is the held-out pool
MH_CONFIGS = (
    ("subsampled", make_train_step,
     TrainConfig(round_batch=4, epsilon=0.05, sigma=5e-3, propose_paths=("final_norm",))),
    ("exact", make_exact_step,
     TrainConfig(round_batch=4, sigma=5e-3, propose_paths=("final_norm",))),
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam_phase(cfg: ModelConfig, params, stream: MarkovStream, steps: int, log=print):
    """Phase 1: ``steps`` Adam steps. Returns (params, state, [(step, loss)])."""
    vg = value_and_grad(lm_loss_fn(cfg))
    opt = adam_init(params)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        loss, grads = vg(params, stream.batch(step))
        params, opt = adam_step(grads, opt, params, lr=LR)
        del grads
        if step % max(steps // 10, 1) == 0 or step == steps - 1:
            losses.append((step, float(loss)))
            log(f"  adam step {step:4d}: loss/token={losses[-1][1]:.4f} "
                f"t={time.perf_counter() - t0:.0f}s")
    return params, opt, losses


def mh_pass(step_fn, params, pool: dict, mh_steps: int, device: torch.device) -> dict:
    """One pass of ``mh_steps`` transitions from ``params``; the infos are
    read on the host only after the pass."""
    launches = dict(ops.launches)
    th, infos = params, []
    t0 = time.perf_counter()
    for i in range(mh_steps):
        th, info = step_fn(step_generator(MH_SEED, i, device), th, pool)
        infos.append(info)
    _sync(device)
    wall = time.perf_counter() - t0
    return {
        "wall_s": wall,
        "accepted": [bool(i.accepted) for i in infos],
        "n_evaluated": [int(i.n_evaluated) for i in infos],
        "rounds": [int(i.rounds) for i in infos],
        "mu_hat": [float(i.mu_hat) for i in infos],
        "params": th,
        "launches": {k: v - launches.get(k, 0) for k, v in ops.launches.items()
                     if v - launches.get(k, 0)},
    }


def same_params(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def mh_phase(cfg: ModelConfig, params, pool: dict, mh_steps: int, batch: int,
             device: torch.device, log=print) -> dict:
    """Phase 2: each MH configuration twice from one seed (timed, then
    collecting statistics), the two passes held to each other bit for bit."""
    out = {}
    for name, maker, tc in MH_CONFIGS:
        step_fn = maker(cfg, tc)
        timed = mh_pass(step_fn, params, pool, mh_steps, device)
        stats = mh_pass(step_fn, params, pool, mh_steps, device)
        same = (timed["accepted"] == stats["accepted"]
                and timed["n_evaluated"] == stats["n_evaluated"]
                and timed["rounds"] == stats["rounds"] and timed["mu_hat"] == stats["mu_hat"]
                and same_params(timed["params"], stats["params"]))
        r = {
            "acceptance": float(np.mean(stats["accepted"])),
            "sections_per_transition": float(np.mean(stats["n_evaluated"])),
            "rounds_per_transition": float(np.mean(stats["rounds"])),
            "wall_s": timed["wall_s"],
            "ms_per_transition": 1e3 * timed["wall_s"] / max(mh_steps, 1),
            "passes_equal": same,
            "launches": timed["launches"],
            "accepted": stats["accepted"], "n_evaluated": stats["n_evaluated"],
            "params_finite": all(bool(torch.isfinite(t).all())
                                 for t in tree_leaves(stats["params"])),
        }
        out[name] = r
        log(f"  {name:10s}: acceptance={r['acceptance']:.2f} "
            f"sections/transition={r['sections_per_transition']:.1f}/{batch} "
            f"wall={r['wall_s']:.1f}s ({r['ms_per_transition']:.0f} ms/transition)")
    return out


def run(cfg: ModelConfig, *, steps: int, mh_steps: int, batch: int, seq: int, device=None,
        ckpt_dir: str | None = None, log=print) -> dict:
    """Both phases; returns the losses, the trained parameters, the Adam
    state and phase 2's summary per configuration. ``ckpt_dir=None`` saves
    no checkpoint."""
    dev = resolve_device(device)
    log(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on {dev}")
    params = init_params(0, cfg, device=dev)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    stream = MarkovStream(data, concentration=0.2, device=dev)
    t0 = time.perf_counter()
    params, opt, losses = adam_phase(cfg, params, stream, steps, log)
    _sync(dev)
    adam_s = time.perf_counter() - t0
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, steps, params)
        log(f"checkpoint saved to {ckpt_dir}")
    log("\nBayesian block inference (subsampled MH over 'final_norm'):")
    pool = stream.batch(POOL_STEP)  # held-out pool of sequences
    mh = mh_phase(cfg, params, pool, mh_steps, batch, dev, log)
    return {"losses": losses, "adam_s": adam_s, "params": params, "opt": opt, "stream": stream,
            "mh": mh}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--mh-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="artifacts/lm_train_torch_ckpt")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    print(ops.dispatch_summary())
    run(PRESETS[args.preset], steps=args.steps, mh_steps=args.mh_steps, batch=args.batch,
        seq=args.seq, device=args.device, ckpt_dir=args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
