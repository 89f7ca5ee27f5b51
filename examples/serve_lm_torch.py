"""Posterior-predictive serving on the port: batched prefill and decode from
a parameter sample (fresh, random). The counterpart of
``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch chatglm3-6b      # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Quirks kept from the reference: ``--reduced`` is a ``store_true`` flag whose
default is True, so the model is always the reduced config. ``--smoke`` (not
a flag of the reference) cuts the batch and lengths for a test. Randomness: the
parameters come from seed 0, the prompts from a ``torch.Generator`` seeded
1, the audio family's frames (0.1 N(0, 1) in bf16) from one seeded 2 and
the sampled tokens (Gumbel-max over logits / temperature, as
``jax.random.categorical`` draws) from one seeded 3, where the reference
uses ``jax.random.key(0/1/2/3)``; so the tokens are the reference's in
distribution, not in bits. ``run(params=...)`` decodes given parameters.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch._device import make_generator, resolve_device
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init_params, prefill


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: 2 requests of 8 prompt tokens, 8 generated")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace, *, device=None, params=None, log=print) -> dict:
    """The example's run on parsed ``args``; returns the numbers it prints
    and the generated tokens (``tokens``, (batch, gen_len))."""
    dev = resolve_device(device if device is not None else args.device)
    if args.smoke:
        args = argparse.Namespace(**{**vars(args), "batch": 2, "prompt_len": 8, "gen_len": 8})
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    log(ops.dispatch_summary())
    log(f"serving {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
        f"gen={args.gen_len}")
    if params is None:
        params = init_params(0, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), dtype=torch.int32,
                            generator=make_generator(1, dev), device=dev)
    extra = None
    if cfg.family == "audio":
        extra = {"frames": 0.1 * torch.randn(
            (args.batch, cfg.n_audio_frames, cfg.d_model), generator=make_generator(2, dev),
            dtype=torch.bfloat16, device=dev)}
    max_len = args.prompt_len + args.gen_len + 8

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(params, prompts, cfg, max_len, extra)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    gen = make_generator(3, dev)
    tokens = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(args.gen_len):
        cache, logits = decode_step(params, cache, tok, cfg)
        u = torch.rand(logits.shape, generator=gen, device=dev).clamp_min(1e-20)
        scaled = logits.float() / args.temperature
        tok = torch.argmax(scaled - torch.log(-torch.log(u)), -1)[:, None].to(torch.int32)
        tokens.append(tok[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.stack(tokens, 1).cpu()
    out = {"arch": cfg.name, "prefill_s": t_prefill, "decode_s": t_decode,
           "prefill_tok_s": args.batch * args.prompt_len / t_prefill,
           "decode_tok_s": args.batch * args.gen_len / t_decode,
           "decode_step_ms": 1e3 * t_decode / args.gen_len, "tokens": gen_tokens,
           "logits_finite": bool(torch.isfinite(logits.float()).all())}
    log(f"prefill: {t_prefill:.2f}s  ({out['prefill_tok_s']:.0f} tok/s)")
    log(f"decode : {t_decode:.2f}s  ({out['decode_tok_s']:.0f} tok/s, "
        f"{out['decode_step_ms']:.1f} ms/step)")
    log(f"sample token ids (request 0): {gen_tokens[0][:16].numpy()}")
    return out


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
