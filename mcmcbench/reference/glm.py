"""The plain reference of the dense GLM (chatglm3-6b's architecture):
per-sequence log-likelihoods in float32, with TF32 off, one layer's
weights upcast at a time and the sequences in blocks.

The architecture as published (arXiv:2406.12793; THUDM/chatglm3-6b), in the
port's parameter layout: pre-norm RMSNorm blocks, grouped-query attention
(32 query heads over 2 key/value heads of 128) with biases on q, k and v,
rotary embeddings on the first half of each head's dimensions (pairs of
adjacent dimensions, base 10 000), a causal softmax in float32, a SwiGLU MLP,
a final RMSNorm, and next-token log-probabilities over the vocabulary.
Departures, each the port's layout: a norm's scale is stored as ``1 +
gamma``; the output layer is the embedding table (tied).

``weight_cast`` rounds each weight before use: the identity for the
reference, and a lower precision for the control.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rms(x, gamma, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + gamma)


def _rope(x, positions, rot, base):
    """Rotate the first ``rot`` dims of x (B, S, N, h) in adjacent pairs."""
    inv = base ** (-torch.arange(0, rot, 2, dtype=F32, device=x.device) / rot)
    ang = positions.to(F32)[:, None] * inv  # (S, rot/2)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def _layer_weights(params: dict, i: int, cast) -> dict:
    def get(tree):
        return {k: get(v) if isinstance(v, dict) else cast(v[i]).to(F32) for k, v in tree.items()}

    return get(params["layers"])


def _block(h, w, sizes, positions):
    nh, nk, hd = sizes["n_heads"], sizes["n_kv"], sizes["head_dim"]
    eps = sizes["norm_eps"]
    b, s, _ = h.shape
    a = _rms(h, w["ln1"], eps)
    att = w["attn"]
    q = torch.einsum("bsd,dnh->bsnh", a, att["wq"])
    k = torch.einsum("bsd,dnh->bsnh", a, att["wk"])
    v = torch.einsum("bsd,dnh->bsnh", a, att["wv"])
    if "bq" in att:
        q, k, v = q + att["bq"], k + att["bk"], v + att["bv"]
    rot = int(hd * sizes["rotary_frac"])
    rot -= rot % 2
    q, k = _rope(q, positions, rot, sizes["rope_base"]), _rope(k, positions, rot, sizes["rope_base"])
    group = nh // nk
    kq = k.repeat_interleave(group, dim=2)  # query head j reads kv head j // group
    vq = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q, kq) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, -math.inf)
    o = torch.einsum("bnst,btnh->bsnh", torch.softmax(scores, dim=-1), vq)
    h = h + torch.einsum("bsnh,nhd->bsd", o, att["wo"])
    m = _rms(h, w["ln2"], eps)
    mlp = w["mlp"]
    g = torch.nn.functional.silu(m @ mlp["wi_gate"]) * (m @ mlp["wi_up"])
    return h + g @ mlp["wo"]


def loglik(params: dict, tokens: torch.Tensor, sizes: dict, *, weight_cast=None,
           block: int = 16) -> torch.Tensor:
    """log p(tokens[b, 1:] | tokens[b, :-1]) summed over positions, (B,)
    float32, in blocks of ``block`` sequences."""
    cast = weight_cast or (lambda t: t)
    tokens = tokens.long()
    table = cast(params["embed"]["table"]).to(F32)
    final = cast(params["final_norm"]).to(F32)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inp.shape[1], device=tokens.device)
    hs = [table[inp[a:a + block]] for a in range(0, inp.shape[0], block)]
    for i in range(sizes["n_layers"]):
        w = _layer_weights(params, i, cast)
        hs = [_block(h, w, sizes, positions) for h in hs]
        del w
    out = []
    for a, h in zip(range(0, inp.shape[0], block), hs):
        logits = _rms(h, final, sizes["norm_eps"]) @ table.T
        logp = torch.log_softmax(logits, dim=-1)
        out.append(logp.gather(-1, tgt[a:a + block, :, None])[..., 0].sum(-1))
    return torch.cat(out)
