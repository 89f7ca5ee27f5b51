"""Train launcher: a subsampled-MH chain over all of an architecture's
parameters with checkpoints, preemption handling and deterministic resume
(the port of ``repro.launch.train``).

On the card, at full size (chatglm3-6b is the default architecture):

    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --ckpt-dir /tmp/chain

On the CPU, at the reduced size the tests use:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 5

``--arch`` takes every architecture of ``repro_torch.configs.ARCHS``.
whisper-base is refused at its first step with a ValueError that names the
missing frame embeddings: the token stream carries none, and the
reference's launcher fails there too.

``--device`` defaults to the card and raises without one.

``--model-parallel N`` runs the chain on the reference's mesh,
``make_mesh_for_devices(model_parallel=N)`` under ``logical_axis_rules``:
(slots / N) x N ``("data", "model")`` over the visible slots (within
``repro_torch.distributed.force_devices(n)``, n slots that cycle over the
cards; ``--devices n`` forces them from the command line). On a mesh of
more than one slot each leaf is drawn whole on the
card from its ``leaf_seed``, split into its owners' pieces by the
reference's rules and freed; compute stays on the card, so every step, the
summary line and the checkpoint are the unsharded run's, bit for bit.

``--trace-dir DIR`` records the step spans (``lm.step`` and its
``lm.propose``, ``lm.prior``, ``test.round`` and ``lm.forward``; see
``repro_torch.obs.trace``) of every step into ``DIR/spans.jsonl``, as
``launch/serve.py --trace-dir`` does the request spans; export with
``python -m repro_torch.obs.trace --export DIR``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..bayes import TrainConfig, make_exact_step, make_train_step
from ..configs import ARCHS, reduce_config
from ..data import DataConfig, MarkovStream
from ..distributed import force_devices
from ..distributed.sharding import Mesh, ShardedTensor, logical_axis_rules, named_sharding
from ..models import init_params
from ..models.layers import init_leaf
from ..models.transformer import ModelConfig, _flatten, _rebuild, leaf_seed, param_specs
from ..obs import trace
from ..runtime import LoopConfig, run_loop
from .mesh import make_mesh_for_devices


def init_sharded_params(seed: int, cfg: ModelConfig, mesh: Mesh, rules: dict | None = None, *,
                        device=None) -> dict:
    """``init_params(seed, cfg, device=device)`` split over ``mesh``: each
    leaf drawn whole on the device from its ``leaf_seed`` (sorted path
    order), split into its owners' pieces by the rules and freed, so at most
    one whole leaf lives at a time. Home: the device."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    vals = {}
    for i, (path, spec) in enumerate(sorted(_flatten(specs).items())):
        gen = torch.Generator(device=dev).manual_seed(leaf_seed(seed, i))
        leaf = init_leaf(gen, spec, dev)
        vals[path] = ShardedTensor.from_tensor(
            leaf, named_sharding(mesh, spec.shape, spec.logical, rules))
        del leaf
    return _rebuild(specs, vals)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="chatglm3-6b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--round-batch", type=int, default=4)
    ap.add_argument("--epsilon", type=float, default=0.05)
    ap.add_argument("--sigma", type=float, default=1e-4)
    ap.add_argument("--kernel", default="subsampled", choices=["subsampled", "exact"])
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--preempt-flag", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None,
                    help="make N mesh slots visible while the chain runs, cycling over the "
                         "cards (or the CPU): the counterpart of forced host devices")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--trace-dir", default=None,
                    help="record every step's spans in <dir>/spans.jsonl")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the chain; returns {params, infos, step, wall_s, step_s,
    steps_per_s, peak_bytes} beside the summary line it prints."""
    args = parse_args(argv)
    tracer = None
    if args.trace_dir:
        tracer = trace.Tracer(jsonl_path=os.path.join(args.trace_dir, "spans.jsonl"))
        trace.install(tracer)
        print(f"trace: step spans tee to {args.trace_dir}/spans.jsonl")
    try:
        with force_devices(args.devices) if args.devices else contextlib.nullcontext():
            return _main(args, tracer)
    finally:
        if tracer is not None:
            trace.install(None)
            tracer.close()


def _main(args: argparse.Namespace, tracer: trace.Tracer | None = None) -> dict:
    device = resolve_device(args.device)
    mesh = make_mesh_for_devices(model_parallel=args.model_parallel, device=device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    tc = TrainConfig(round_batch=args.round_batch, epsilon=args.epsilon, sigma=args.sigma)
    maker = make_train_step if args.kernel == "subsampled" else make_exact_step
    stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=args.batch, seed=0), device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step = maker(cfg, tc)
    step_s: list[float] = []

    def timed_step(gen, params, batch):
        """The transition alone, timed (the batch and checkpoints are not)."""
        sync()
        t = time.perf_counter()
        out = step(gen, params, batch)
        sync()
        step_s.append(time.perf_counter() - t)
        if tracer is not None:  # the step's stream times, read after its synchronize
            tracer.flush()
        return out

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    init = (init_params if mesh.size == 1
            else lambda seed, cfg, device: init_sharded_params(seed, cfg, mesh, device=device))
    with logical_axis_rules(mesh):
        # the initial parameters are handed over, not kept: at chatglm3-6b's
        # size they are 12 GB that the loop drops once a proposal is accepted
        out = run_loop(timed_step, init(0, cfg, device=device), stream.batch,
                       LoopConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every, preempt_flag=args.preempt_flag))
    sync()
    out["wall_s"] = time.perf_counter() - t0
    out["step_s"] = step_s
    # the first transition warms up the device libraries; rates over the rest
    steady = step_s[1:] or step_s
    out["steps_per_s"] = len(steady) / sum(steady) if steady else float("nan")
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    infos = out["infos"]
    acc = np.mean([i["accepted"] for i in infos]) if infos else float("nan")
    n_eval = np.mean([i["n_evaluated"] for i in infos]) if infos else float("nan")
    peak = "" if out["peak_bytes"] is None else f" peak_memory={out['peak_bytes'] / 2**30:.2f}GiB"
    print(f"done: step={out['step']} acceptance={acc:.2f} "
          f"mean_sections={n_eval:.1f}/{args.batch} steps_run={len(infos)} "
          f"steps/s={out['steps_per_s']:.3f} wall={out['wall_s']:.2f}s{peak}")
    return out


if __name__ == "__main__":
    main()
