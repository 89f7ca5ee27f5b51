"""Deterministic synthetic token streams: the port of
``repro.data.pipeline``.

  - ``TokenStream``: iid uniform tokens keyed by (seed, step).
  - ``MarkovStream``: order-1 Markov chains with a random but fixed,
    peaked transition matrix, giving models a learnable signal.

Every batch comes from ``torch.Generator``s keyed by (seed, step), so a
step's batch is the same whenever it is asked for (resume needs no stream
state). The reference's ``MarkovStream`` holds the whole (V, V) logit
matrix, 16.9 GB in float32 at V = 65024; here row ``r`` of it is drawn when
a sequence needs it, from a generator keyed by (seed, r): the same
distribution (every logit N(0, 1) / concentration, fixed for the stream),
never the whole matrix. The bits differ from JAX's.

``shard_batch`` splits a batch over a mesh of slots by its rows.

Batches double as the subsampled-MH pool: the stream order is random by
construction, so contiguous slices per round are draws without replacement.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


def _generator(device: torch.device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(*parts))


class TokenStream:
    def __init__(self, cfg: DataConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        c = self.cfg
        gen = _generator(self.device, c.seed, step)
        tokens = torch.randint(0, c.vocab, (c.global_batch, c.seq_len), generator=gen,
                               dtype=torch.int32, device=self.device)
        return {"tokens": tokens, "mask": torch.ones_like(tokens)}


class MarkovStream:
    """Sequences from a fixed random Markov chain (peaked transitions)."""

    _MATRIX_SALT = 7_777  # the reference keys its matrix by seed + 7777

    def __init__(self, cfg: DataConfig, concentration: float = 0.3, *, device=None):
        self.cfg = cfg
        self.concentration = concentration
        self.device = resolve_device(device)

    def row_logits(self, rows: torch.Tensor) -> torch.Tensor:
        """Transition logits out of each token in ``rows`` (R,) -> (R, V)."""
        c = self.cfg
        out = torch.empty((rows.shape[0], c.vocab), dtype=torch.float32, device=self.device)
        for i, r in enumerate(rows.tolist()):
            gen = _generator(self.device, c.seed + self._MATRIX_SALT, r)
            torch.randn(c.vocab, generator=gen, out=out[i], device=self.device)
        return out / self.concentration

    def batch(self, step: int) -> dict:
        c = self.cfg
        gen = _generator(self.device, c.seed, step)
        prev = torch.randint(0, c.vocab, (c.global_batch,), generator=gen, dtype=torch.int64,
                             device=self.device)
        cols = [prev]
        for _ in range(c.seq_len - 1):
            uniq, inv = torch.unique(prev, return_inverse=True)
            logits = self.row_logits(uniq)[inv]
            u = torch.rand(logits.shape, generator=gen, device=self.device).clamp_min_(1e-20)
            prev = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)  # Gumbel-max
            cols.append(prev)
        tokens = torch.stack(cols, dim=1).to(torch.int32)
        return {"tokens": tokens, "mask": torch.ones_like(tokens)}


def shard_batch(batch: dict, mesh, logical=("batch", None)) -> dict:
    """A batch split over ``mesh`` by its rows (``logical`` names the dims,
    cut to each leaf's rank): each leaf a ``ShardedTensor`` whose home is
    the leaf's device, read back by rows there (``bayes.train._rows_of``)."""
    from ..distributed.sharding import ShardedTensor, named_sharding

    return {k: ShardedTensor.from_tensor(v, named_sharding(mesh, v.shape, logical[:v.ndim]))
            for k, v in batch.items()}
