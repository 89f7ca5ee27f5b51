#!/usr/bin/env python3
"""The runs of ``chip_smoke.py`` that four cards add, alone: each mesh phase
with one slot a card (``@4cards``) beside its unsharded counterpart, and
jamba-v0.1-52b whole over the four cards.

    python3 tools/phase_cards.py          # from the repository root

Run on a machine with four NVIDIA cards and ``nvcc``; with fewer it prints
why and exits 2. It builds the kernels, then runs, each held bit for bit
against its unsharded run as ``chip_smoke.py`` holds the one-card layouts:

- X@4cards: BayesLR at phase C's setting (C's first 200 steps and K's 250
  stand for phases C and K), the X runs over four cards, and X-fleet
  (``--devices 4``, which spreads over the cards);
- H, H-mp@4cards; H-mala, H-mala-mp@4cards (chatglm3-6b at full size);
- J (the ce family on H's unembedding table, K=8 tables) and J-mp@4cards;
- T, T-mp@4cards (decoding from H's checkpoint);
- H-adam (b)'s Adam step on chatglm3-6b cut to 2 layers, H-adam-mp@4cards;
- T-hybrid (jamba cut to one period, on cuda:0) and T-hybrid-4cards.

It prints the card's name and power limit and the card count first, each
phase's seconds, and ``PHASE_CARDS_OK`` last, and writes the report to
``chiprun_out/phase_cards.json``; a failed check exits 1. Disk: one 12 GB
checkpoint of H's at a time, and H-mp's beside it while they are compared.
"""
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def adam_b(report, cs):
    """H-adam (b)'s one Adam step on chatglm3-6b cut to 2 layers (from
    fresh moments), timed once after a first call: (config, parameters,
    batch, the step's output, lr)."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(HERE, "examples"))
    import lm_train_torch as ex

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, MarkovStream
    from repro_torch.models import init_params
    from repro_torch.optim import adam_init, adam_step, lm_loss_fn
    from repro_torch.optim.optimizers import value_and_grad

    wide = dataclasses.replace(ARCHS[cs.LM_ARCH], n_layers=cs.ADAM_WIDE_LAYERS)
    params = init_params(0, wide)
    batch = MarkovStream(DataConfig(wide.vocab, cs.ADAM_SEQ, cs.ADAM_BATCH, seed=0)).batch(0)
    vg = value_and_grad(lm_loss_fn(wide))

    def step():
        _, grads = vg(params, batch)
        return adam_step(grads, adam_init(params), params, lr=ex.LR)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    report["phases"]["H-adam"]["b"] = {"mean_ms": 1e3 * (time.perf_counter() - t0)}
    return wide, params, batch, out, ex.LR


def run(report, physical) -> None:
    """Every run of the module docstring with the four slots over
    ``physical`` cards (4; 1 rehearses the same code on one card, without
    jamba whole). A mesh run whose check fails is recorded under
    ``report["failed"]`` and the next runs go on; a failed check of an
    unsharded run raises ``chip_smoke.CheckFailed``."""
    import torch

    import chip_smoke as cs
    from repro_torch.experiments import bayeslr

    cards = [(f"@{physical}cards" if physical > 1 else "", physical)]
    seconds = report.setdefault("seconds", {})
    root = tempfile.mkdtemp(prefix="phase_cards_")

    def timed(name, fn, mesh=False):
        t0 = time.perf_counter()
        try:
            out = fn()
        except cs.CheckFailed as e:
            if not mesh:
                raise
            print(f"  {name}: FAILED: {e}")
            report.setdefault("failed", {})[name] = str(e)
            out = None
        seconds[name] = time.perf_counter() - t0
        print(f"  {name}: {seconds[name]:.1f} s")
        torch.cuda.empty_cache()
        return out

    try:
        data = bayeslr.synth_mnist_like(0)
        stand_ins = []
        for steps, kw in ((200, {}), (cs.K_STEPS, {"stepping": "masked"})):
            t0 = time.perf_counter()
            samples, _, _, infos = cs.bayeslr_ensemble(3, data, 32, steps, shard=False, **kw)
            torch.cuda.synchronize()
            stand_ins.append((samples, infos, 32 * steps / (time.perf_counter() - t0)))
        timed("X", lambda: cs.phase_x(report, data, *stand_ins, layouts=cards), mesh=True)
        del stand_ins

        params, cfg, h_infos = timed("H", lambda: cs.phase_h(report, root))
        timed("H-mp", lambda: cs.phase_h_mp(report, root, params, h_infos, physical), mesh=True)
        mala = timed("H-mala", lambda: cs.phase_h_mala(report, params, cfg))
        timed("H-mala-mp", lambda: cs.phase_h_mala_mp(report, params, cfg, mala, physical),
              mesh=True)
        del mala, h_infos
        _, target = cs.lm_ce_setup(params, cfg)
        theta = params["embed"]["table"].float()
        del params
        torch.cuda.empty_cache()
        j = timed("J", lambda: cs.phase_j(report, target, theta))
        del theta
        timed("J-mp", lambda: cs.phase_j_mp(report, target, j, physical), mesh=True)
        del j, target
        sub = os.path.join(root, "sub")
        t_out = timed("T", lambda: cs.phase_t(report, sub))
        timed("T-mp", lambda: cs.phase_t_mp(report, sub, t_out, physical), mesh=True)
        del t_out
        shutil.rmtree(root, ignore_errors=True)

        wide, params, batch, want, lr = timed("H-adam (b)", lambda: adam_b(report, cs))
        timed("H-adam-mp", lambda: cs.phase_h_adam_mp(report, wide, params, batch, want, lr,
                                                      physical), mesh=True)
        del params, want
        hybrid = cs.FAMILY_CUTS[cs.HYBRID_ARCH][0]
        cut = timed("T-hybrid", lambda: cs.phase_t_cut(report, "T-hybrid", cs.HYBRID_ARCH,
                                                       hybrid))
        timed("T-hybrid-4cards", lambda: cs.phase_t_hybrid_cards(report, cut, physical), mesh=True)
        print(f"  seconds taken by the phases: {seconds}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.distributed import force_devices
    from repro_torch.kernels import _build

    n = torch.cuda.device_count()
    print(cs.card_line(), f"x {n}")
    if n < cs.X_SLOTS:
        print(f"phase_cards: {n} card(s) visible; these runs need {cs.X_SLOTS}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s")
    report = {"card": cs.card_line(), "cards": n, "phases": collections.defaultdict(dict),
              "kernels": collections.defaultdict(lambda: {"launches": 0})}
    try:
        with force_devices(1):  # the unsharded runs on one slot, cuda:0; a mesh run forces four
            run(report, cs.X_SLOTS)
        if report.get("failed"):
            raise cs.CheckFailed(f"{sorted(report['failed'])}")
    except cs.CheckFailed as e:
        print(f"phase_cards: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "phase_cards.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("PHASE_CARDS_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
