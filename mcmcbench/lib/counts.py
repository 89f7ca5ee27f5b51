"""The yardstick's arithmetic: the table of the card's peaks, the operations
of the dense LM's forward, and the bytes a pair-delta launch must move.
Counted from shapes, never read from the program.
"""
from __future__ import annotations


# NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity, at the full
# 700 W power limit: the data sheet's numbers.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The peaks of the card named ``kind``, or None for a card not in the table."""
    return PEAKS.get(kind)


def dense_forward_flops(sizes: dict, batch: int, seq: int) -> float:
    """Multiply-add operations x 2 of one forward of the dense LM over
    ``batch`` sequences of ``seq`` positions, as the forward computes them:
    the q, k, v and output projections, the SwiGLU MLP, the attention's
    scores and weighted sum over every (query, key) pair of the (S, S) block
    (the causal mask is applied to a full product), and the tied
    unembedding over the whole vocabulary. Norms, rotary, softmax and
    elementwise work are not counted."""
    L, d, nh, nk = sizes["n_layers"], sizes["d_model"], sizes["n_heads"], sizes["n_kv"]
    h, f, v = sizes["head_dim"], sizes["d_ff"], sizes["vocab"]
    t = batch * seq
    proj = d * (nh * h + 2 * nk * h) + nh * h * d
    mlp = 3 * d * f
    attn = 2 * batch * nh * seq * seq * h  # QK^T and PV, multiply-adds
    per_layer = t * (proj + mlp) + attn
    unembed = t * d * v
    return 2.0 * (L * per_layer + unembed)


def pair_delta_bytes(shape: tuple, rows: int, d: int, x_bytes: int = 4) -> int:
    """The bytes a (K, m) pair-delta launch that reads ``rows`` distinct rows
    of an (N, D) pool must move, each counted once: those rows of x and
    their labels, the (K, m) indices, both (K, D) thetas, and the (K, m)
    output."""
    k, m = shape
    return rows * (d * x_bytes + 4) + k * m * 4 + 2 * k * d * 4 + k * m * 4
