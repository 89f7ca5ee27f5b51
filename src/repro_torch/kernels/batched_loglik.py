"""Ensemble-batched logit pair delta: the port of the Pallas kernel
``repro.kernels.batched_loglik.batched_logit_delta`` and its gather.

Every lock-step round of the ``logit`` family scores one (K, m) block: K
chains, each with its own mini-batch and its own (w, w') pair. Both wrappers
launch the kernel of ``csrc/logit_delta.cu`` and count under
``"batched_logit_delta"``:

  * :func:`batched_logit_delta` on pre-gathered rows xg (K, m, D);
  * :func:`gather_and_delta` on the shared (N, D) pool with the row indices
    idx (K, m): the kernel reads the rows in place, the counterpart of the
    gather XLA fuses in front of the Pallas call.

The plain versions are :func:`repro_torch.kernels.ref.batched_logit_delta_ref`
and :func:`repro_torch.kernels.ref.gather_and_delta_ref`.
"""
from __future__ import annotations

import torch

from .logit_loglik import launch_pair_delta
from .ref import batched_logit_delta_ref, gather_and_delta_ref

__all__ = ["batched_logit_delta", "gather_and_delta",
           "batched_logit_delta_ref", "gather_and_delta_ref"]

NAME = "batched_logit_delta"


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} has no kernel for device {t.device}")
    return True


def batched_logit_delta(xg: torch.Tensor, yg: torch.Tensor, w_cur: torch.Tensor,
                        w_prop: torch.Tensor, *, round_bf16: bool = False,
                        warps: int = 0) -> torch.Tensor:
    """l[k, i] = log sig(y x.w'_k) - log sig(y x.w_k): xg (K, m, D) f32 or
    bf16, yg (K, m), w_* (K, D) f32 -> (K, m) f32. ``round_bf16`` (kernel
    only) rounds w, w' and fp32 rows to bf16; ``warps`` overrides the launch
    (:func:`repro_torch.kernels.logit_loglik.launch_pair_delta`)."""
    if not _on_cuda(xg, "batched_logit_delta"):
        return batched_logit_delta_ref(xg, yg, w_cur, w_prop)
    if xg.ndim != 3:
        raise ValueError(f"xg must be (K, m, D), got {tuple(xg.shape)}")
    k, m, _ = xg.shape
    return launch_pair_delta(xg, yg, None, w_cur, w_prop, k, m, NAME, round_bf16=round_bf16,
                             warps=warps)


def gather_and_delta(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                     w_cur: torch.Tensor, w_prop: torch.Tensor, *,
                     round_bf16: bool = False, warps: int = 0) -> torch.Tensor:
    """The same delta on rows ``idx`` (K, m) int32 of the pool x (N, D),
    y (N,) -> (K, m) f32. Indices must lie in [0, N): the samplers clamp
    them. ``round_bf16``, ``warps`` as in :func:`batched_logit_delta`."""
    if not _on_cuda(x, "gather_and_delta"):
        return gather_and_delta_ref(x, y, idx, w_cur, w_prop)
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, m), got {tuple(idx.shape)}")
    k, m = idx.shape
    return launch_pair_delta(x, y, idx, w_cur, w_prop, k, m, NAME, round_bf16=round_bf16,
                             warps=warps)
