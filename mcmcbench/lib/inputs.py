"""The benchmark's inputs, made from ``--seed`` on the device in a few large
calls: the LM's parameters in the port's layout, the LM's resident pool of
sequences, and the BayesLR data set. The same seed gives the same inputs,
and the program and the reference are handed the same tensors (the
reference makes them again with these functions after the program is gone).

Every generator is a ``torch.Generator`` on the device, seeded from the run's
seed and a tag (:func:`sub_seed`), so the parameters, the pool, the data and
the chains' draws are independent streams.
"""
from __future__ import annotations

import hashlib

import torch

F32 = torch.float32
DRAW_CHUNK = 1 << 28  # elements drawn a call (1 GiB of float32 noise)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device: torch.device, seed: int, tag: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


# ---------------------------------------------------------------------------
# The dense LM's parameters
# ---------------------------------------------------------------------------


def dense_sizes(config: dict) -> dict:
    """The port's sizes of a dense configuration file, by the port's names
    (the file's ``port`` map: port field -> the file's key)."""
    out = dict(config["port"]["fixed"])
    out.update({field: config[key] for field, key in config["port"]["keys"].items()})
    return out


def dense_layout(sizes: dict, init: dict) -> dict:
    """``{path: (shape, std)}`` of the dense family's parameters in the port's
    layout (stacked layer axis first), paths joined by '/'. Matrices are drawn
    at 1/sqrt(fan in) over their contracted axes, the two that write into the
    residual stream scaled again by 1/sqrt(2 L), so the random model's
    residual stream stays of order one at full depth."""
    L, d, nh, nk = sizes["n_layers"], sizes["d_model"], sizes["n_heads"], sizes["n_kv"]
    h, f, v = sizes["head_dim"], sizes["d_ff"], sizes["vocab"]
    res = (2 * L) ** -0.5
    out = {
        "embed/table": ((v, d), init["embed"]),
        "final_norm": ((d,), init["norm"]),
        "layers/ln1": ((L, d), init["norm"]),
        "layers/ln2": ((L, d), init["norm"]),
        "layers/attn/wq": ((L, d, nh, h), d ** -0.5),
        "layers/attn/wk": ((L, d, nk, h), d ** -0.5),
        "layers/attn/wv": ((L, d, nk, h), d ** -0.5),
        "layers/attn/wo": ((L, nh, h, d), (nh * h) ** -0.5 * res),
        "layers/mlp/wi_gate": ((L, d, f), d ** -0.5),
        "layers/mlp/wi_up": ((L, d, f), d ** -0.5),
        "layers/mlp/wo": ((L, f, d), f ** -0.5 * res),
    }
    if sizes.get("qkv_bias"):
        out["layers/attn/bq"] = ((L, nh, h), init["bias"])
        out["layers/attn/bk"] = ((L, nk, h), init["bias"])
        out["layers/attn/bv"] = ((L, nk, h), init["bias"])
    return out


def nest(flat: dict) -> dict:
    """``{'a/b': x}`` -> ``{'a': {'b': x}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def draw_params(layout: dict, seed: int, device: torch.device,
                dtype=torch.bfloat16) -> dict:
    """The parameters, leaf by leaf in sorted path order: N(0, 1) float32
    noise in chunks of ``DRAW_CHUNK`` elements times the leaf's std, cast to
    ``dtype``. Returns the nested tree."""
    gen = generator(device, seed, "weights")
    flat = {}
    for path in sorted(layout):
        shape, std = layout[path]
        leaf = torch.empty(shape, dtype=dtype, device=device)
        view = leaf.view(-1)
        for a in range(0, view.numel(), DRAW_CHUNK):
            b = min(a + DRAW_CHUNK, view.numel())
            view[a:b] = torch.randn(b - a, generator=gen, dtype=F32, device=device).mul_(std)
        flat[path] = leaf
    return nest(flat)


# ---------------------------------------------------------------------------
# The LM's pool: a first-order Markov chain over the vocabulary
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (murmur3's finalizer) of int64 ``x``, in int64."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _row_logits(prev: torch.Tensor, vocab: int, key: int) -> torch.Tensor:
    """The transition logits out of each token of ``prev`` (R,): N(0, 1) a
    (token, next token) pair, a pure function of the pair and ``key`` (a
    counter-based draw, so a row is the same wherever it is needed)."""
    nxt = torch.arange(vocab, device=prev.device, dtype=torch.int64)
    row = _hash32(prev.to(torch.int64) * 2 + key)
    pair = _hash32(row[:, None] ^ nxt[None, :]) * 2
    u1 = (_hash32(pair).to(F32) + 0.5) / 4294967296.0
    u2 = (_hash32(pair + 1).to(F32) + 0.5) / 4294967296.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def markov_pool(seed: int, n_seq: int, seq_len: int, vocab: int, concentration: float,
                device: torch.device) -> dict:
    """``{"tokens": (n_seq, seq_len) int32, "mask": ones}``: sequences of a
    fixed random first-order Markov chain with peaked transitions, the rule
    of the port's ``data.MarkovStream``: the first token uniform, each next
    token drawn from softmax(row logits / concentration) by Gumbel-max."""
    gen = generator(device, seed, "pool")
    key = sub_seed(seed, "pool-matrix") & 0x7FFFFFFF
    prev = torch.randint(0, vocab, (n_seq,), generator=gen, device=device, dtype=torch.int64)
    cols = [prev]
    for _ in range(seq_len - 1):
        logits = _row_logits(prev, vocab, key) / concentration
        u = torch.rand(logits.shape, generator=gen, device=device).clamp_min_(1e-20)
        prev = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        cols.append(prev)
    tokens = torch.stack(cols, dim=1).to(torch.int32)
    return {"tokens": tokens, "mask": torch.ones_like(tokens)}


# ---------------------------------------------------------------------------
# BayesLR: the MNIST 7-vs-9 PCA stand-in
# ---------------------------------------------------------------------------


def synth_mnist_like(seed: int, n_train: int, n_test: int, d: int, device: torch.device):
    """Two-class feature clouds with PCA-like decaying variance per
    dimension (1/sqrt(1 + j)) at the scale of the paper's MNIST 7-vs-9 PCA
    features; labels in {-1, +1} from a logistic model of a random w_true.
    A frozen copy of the port's ``experiments.bayeslr.synth_mnist_like``
    rule. Returns (x_train, y_train, x_test, y_test), float32."""
    gen = generator(device, seed, "data")
    scales = 1.0 / torch.sqrt(1.0 + torch.arange(d, dtype=F32, device=device))
    w_true = torch.randn(d, generator=gen, device=device) * scales * 2.0
    x_train = torch.randn(n_train, d, generator=gen, device=device) * scales
    x_test = torch.randn(n_test, d, generator=gen, device=device) * scales
    u = torch.rand(n_train + n_test, generator=gen, device=device)
    y_train = torch.where(u[:n_train] < torch.sigmoid(x_train @ w_true), 1.0, -1.0)
    y_test = torch.where(u[n_train:] < torch.sigmoid(x_test @ w_true), 1.0, -1.0)
    return x_train, y_train, x_test, y_test


def laplace_starts(x: torch.Tensor, y: torch.Tensor, prior_var: float, chains: int, scale: float,
                   seed: int, iters: int = 25) -> torch.Tensor:
    """Starting points near the posterior of Bayesian logistic regression:
    its mode by Newton's method in float64, plus ``scale`` times draws of
    the Laplace approximation N(0, (-Hessian)^-1) there, (chains, D) float32.
    Chains that start at stationarity run at the rate they keep."""
    xd, yd = x.double(), y.double()
    d = x.shape[1]
    w = torch.zeros(d, dtype=torch.float64, device=x.device)
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    for _ in range(iters):
        z = yd * (xd @ w)
        p = torch.sigmoid(-z)
        grad = xd.T @ (yd * p) - w / prior_var
        hess = (xd * (p * (1 - p))[:, None]).T @ xd + eye / prior_var
        w = w + torch.linalg.solve(hess, grad)
    chol = torch.linalg.cholesky(torch.linalg.inv(hess))
    gen = generator(x.device, seed, "theta0")
    noise = torch.randn(chains, d, generator=gen, dtype=torch.float64, device=x.device)
    return (w + scale * noise @ chol.T).to(F32)
