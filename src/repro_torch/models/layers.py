"""Transformer building blocks: the port of ``repro.models.layers``.

Parameters are plain nested dicts of tensors. Shapes, layouts and the
dtype at each step are the reference's: weights in bf16 by default, norms,
rotary tables, attention logits and the softmax in float32, activations
back in the weights' dtype. The reference's logical sharding constraints
(``lc``) have no counterpart on one device.

Conventions: B batch, S sequence, D d_model, H q-heads, K kv-heads, h
head_dim, F d_ff, E experts, V vocab, T = B*S flattened tokens.

Attention has the reference's three paths under one mask rule: dense
(the (S, T) logits whole), flash (online softmax over chunks of q and kv,
above ``FLASH_THRESHOLD`` query rows) and cached (a ring-buffer KV cache
whose slots carry their absolute positions, -1 while empty). All three are
plain PyTorch, as the reference's are plain ``jnp``: no TPU kernel lies
behind them.

``moe_mlp`` is the reference's capacity-bounded top-k dispatch, plain
PyTorch as the reference's is plain ``jnp``; ``record_moe_drops`` counts the
assignments it drops past capacity.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from .._device import row_chunks

Params = dict[str, Any]
F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple  # logical axis name (or None) per dim
    dtype: Any = torch.bfloat16
    init_scale: str = "fan_in"  # "fan_in" | "one" | "zero" | "normal" | "embed"

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n


def _init_std(spec: ParamSpec) -> float:
    if spec.init_scale == "embed":
        return 0.02  # keeps tied-unembedding logits O(1) at init
    if spec.init_scale == "normal":
        return 1.0
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return float(fan_in) ** -0.5


# Leaves are drawn in chunks of leading-axis rows of at most this many
# elements, so the float32 temporary stays one chunk (the stacked MLP leaf of
# chatglm3-6b is 1.57 G elements: 6.3 GB in float32 at once).
CHUNK = 1 << 26


def init_leaf(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    """A leaf drawn as the reference draws it: N(0, 1) in float32 times the
    spec's scale, cast to its dtype (ones / zeros for those inits). The bits
    differ from JAX's (Philox, not threefry); the distribution is the same."""
    if spec.init_scale == "one":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init_scale == "zero":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    std = _init_std(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for rows in row_chunks(out, CHUNK):
        noise = torch.randn(rows.shape, generator=gen, dtype=F32, device=device)
        rows.copy_(noise.mul_(std))
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma), in float32, back in x's dtype."""
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + gamma.to(F32))).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * gamma + beta, in float32, back in x's dtype."""
    dt = x.dtype
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(F32) + beta.to(F32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int, base: float, rotary_frac: float = 1.0):
    """cos/sin tables (S, rot/2). ``rotary_frac`` < 1 rotates only the first
    rot = head_dim * frac dims (ChatGLM's partial RoPE)."""
    rot = int(head_dim * rotary_frac)
    rot -= rot % 2
    exps = -torch.arange(0, rot, 2, dtype=F32, device=positions.device) / rot
    freqs = torch.pow(torch.tensor(base, dtype=F32, device=positions.device), exps)
    angles = positions.to(F32)[..., None] * freqs  # (S, rot/2)
    return torch.cos(angles), torch.sin(angles), rot


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rot: int) -> torch.Tensor:
    """x: (B, S, N, h); cos/sin: (S, rot/2) or (B, S, rot/2). Pairs are the
    interleaved (even, odd) dims, as in the reference."""
    dt = x.dtype
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(F32)
    sin = sin[:, :, None, :].to(F32)
    xr = x[..., :rot].to(F32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(dt)
    return torch.cat([yr, x[..., rot:]], dim=-1) if rot < x.shape[-1] else yr


# ---------------------------------------------------------------------------
# Attention (GQA, sliding window and rope base as data, optional qk-norm and
# qkv bias). The dense path materializes (S, T) logits; the flash path runs
# an online softmax over chunks, so (S, T) never exists at once.
# ---------------------------------------------------------------------------

FLASH_THRESHOLD = 2048  # chunked attention above this many query rows
_NEG = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int, causal: bool) -> torch.Tensor:
    """(S, T) True where query i may attend key j: causal, inside the window,
    and a filled slot (an empty ring-buffer slot carries pos = -1)."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = diff < window
    if causal:
        m &= diff >= 0
    m &= k_pos[None, :] >= 0
    return m


def _attend_dense(qg, k_all, v_all, q_pos, k_pos, window, causal, scale):
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k_all).to(F32) * scale
    mask = _mask(q_pos, k_pos, window, causal)[None, None, None]
    logits = torch.where(mask, logits, torch.tensor(_NEG, dtype=F32, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(qg.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v_all)


def _attend_flash(qg, k_all, v_all, q_pos, k_pos, window, causal, scale,
                  chunk_q: int = 256, chunk_kv: int = 512):
    """Online-softmax chunked attention, the reference's operation for
    operation: a loop over q chunks, an inner loop over kv chunks, float32
    running max, sum and accumulator. Memory is O(chunk_q * chunk_kv) a head
    instead of O(S * T). q is padded with position -(1 << 29) and kv with
    position -1 (masked), to whole chunks, as there."""
    b, s, n_kv, group, hd = qg.shape
    t = k_all.shape[1]
    cq, ckv = min(chunk_q, s), min(chunk_kv, t)
    nq, nkv = -(-s // cq), -(-t // ckv)
    pad_q, pad_kv = nq * cq - s, nkv * ckv - t
    pad = torch.nn.functional.pad
    qg_p = pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_q))
    qpos_p = pad(q_pos, (0, pad_q), value=-(1 << 29))
    k_p = pad(k_all, (0, 0, 0, 0, 0, pad_kv))
    v_p = pad(v_all, (0, 0, 0, 0, 0, pad_kv))
    kpos_p = pad(k_pos, (0, pad_kv), value=-1)
    neg = torch.tensor(_NEG, dtype=F32, device=qg.device)
    outs = []
    for i in range(nq):
        q_c, qp = qg_p[:, i * cq:(i + 1) * cq], qpos_p[i * cq:(i + 1) * cq]
        m_run = torch.full((b, n_kv, group, cq), _NEG, dtype=F32, device=qg.device)
        l_run = torch.zeros((b, n_kv, group, cq), dtype=F32, device=qg.device)
        acc = torch.zeros((b, n_kv, group, cq, hd), dtype=F32, device=qg.device)
        for j in range(nkv):
            kv = slice(j * ckv, (j + 1) * ckv)
            k_c, v_c = k_p[:, kv], v_p[:, kv]
            logits = torch.einsum("bskgh,btkh->bkgst", q_c, k_c).to(F32) * scale
            mask = _mask(qp, kpos_p[kv], window, causal)[None, None, None]
            logits = torch.where(mask, logits, neg)
            m_new = torch.maximum(m_run, logits.amax(-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkh->bkgsh", p.to(q_c.dtype), v_c).to(F32)
            m_run = m_new
        outs.append((acc / torch.clamp_min(l_run, 1e-30)[..., None]).to(q_c.dtype))
    out = torch.stack(outs)  # (nq, B, K, g, cq, h) -> (B, S, K, g, h)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * cq, n_kv, group, hd)
    return out[:, :s]


def _ring_insert(buf: torch.Tensor, new: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``new`` (B, S, ...) written along axis 1 from slot
    ``length % C``, the start clamped so the rows fit (the reference's
    ``dynamic_update_slice_in_dim``); the index stays on the device."""
    c, s = buf.shape[1], new.shape[1]
    start = torch.clamp(length % c, max=c - s)
    idx = start + torch.arange(s, device=buf.device)
    new = new.to(buf.dtype)
    if buf.element_size() == 1:  # fp8: copied as its bytes (no fp8 index_copy)
        return buf.view(torch.uint8).index_copy(1, idx, new.view(torch.uint8)).view(buf.dtype)
    return buf.index_copy(1, idx, new)


def attention(
    x: torch.Tensor,  # (B, S, D)
    p: Params,  # wq (D, H, h), wk/wv (D, K, h), wo (H, h, D), optional bq/bk/bv, qnorm/knorm
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor,  # (S,) or (B, S)
    window: int,  # sliding-window size (>= S means full)
    rope_base: float,
    rotary_frac: float = 1.0,
    causal: bool = True,
    kv_cache: tuple | None = None,  # (k_buf (B, C, K, h), v_buf, length, slot_pos (C,))
    q_scale: float | None = None,
    use_rope: bool = True,
) -> tuple[torch.Tensor, tuple | None]:
    """Self-attention; returns ``(y, new_cache)`` as the reference's does,
    ``new_cache`` being ``(k_buf, v_buf)`` with this step's keys and values
    written, or None without a cache. ``slot_pos`` must already be advanced
    for this step (the caller's ``_advance_slot_pos``)."""
    b, s, _ = x.shape
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "qnorm" in p:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    pos = positions if positions.ndim == 1 else positions[0]
    if use_rope:
        cos, sin, rot = rope_table(pos, head_dim, rope_base, rotary_frac)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)

    new_cache = None
    k_all, v_all, k_pos = k, v, pos
    if kv_cache is not None:
        k_buf, v_buf, length, slot_pos = kv_cache
        cache_len = k_buf.shape[1]
        if s >= cache_len:
            # prefilling a window-sized ring: attend in-sequence, keep the
            # tail at its ring slots (absolute position p at slot p % C, so
            # later decode inserts at len % C overwrite the oldest entry)
            shift = (s - cache_len) % cache_len
            k_buf = torch.roll(k[:, -cache_len:].to(k_buf.dtype), shift, dims=1)
            v_buf = torch.roll(v[:, -cache_len:].to(v_buf.dtype), shift, dims=1)
        else:
            k_buf = _ring_insert(k_buf, k, length)
            v_buf = _ring_insert(v_buf, v, length)
            k_all, v_all, k_pos = k_buf, v_buf, slot_pos
        new_cache = (k_buf, v_buf)
        if k_all.dtype != q.dtype:  # a quantized (fp8) cache: dequantized on read
            k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)

    group = n_heads // n_kv
    qg = q.reshape(b, s, n_kv, group, head_dim)
    scale = q_scale if q_scale is not None else head_dim ** -0.5
    if s > FLASH_THRESHOLD or (k_all.shape[1] > 4 * FLASH_THRESHOLD and s > 1):
        out5 = _attend_flash(qg, k_all, v_all, pos, k_pos, window, causal, scale)
    else:
        out5 = _attend_dense(qg, k_all, v_all, pos, k_pos, window, causal, scale)
    out = out5.reshape(b, s, n_heads, head_dim)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """p: wi_gate (D, F), wi_up (D, F), wo (F, D)."""
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    h = torch.nn.functional.silu(g.to(F32)).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


def gelu_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """p: wi (D, F), bi (F,), wo (F, D), bo (D,) (Whisper's). The GELU is the
    tanh form, ``jax.nn.gelu``'s default."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"]) + p["bi"]
    h = torch.nn.functional.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["wo"]) + p["bo"]


# ---------------------------------------------------------------------------
# Mixture of experts (top-k, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

_moe_drops: list | None = None  # set by record_moe_drops: (assignments, dropped) a call


@contextlib.contextmanager
def record_moe_drops():
    """Within the block, every ``moe_mlp`` call appends ``(assignments,
    dropped)`` to the yielded list: its number of (token, expert)
    assignments and a device tensor counting those past capacity. Nothing is
    read back to the host until the caller sums them."""
    global _moe_drops
    prev, _moe_drops = _moe_drops, []
    try:
        yield _moe_drops
    finally:
        _moe_drops = prev


def moe_mlp(
    x: torch.Tensor,  # (B, S, D)
    p: Params,  # router (D, E), wi_gate / wi_up (E, D, F), wo (E, F, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    n_groups: int | None = None,
) -> torch.Tensor:
    """Top-k MoE with the reference's grouped, capacity-bounded dispatch.

    Tokens split into ``n_groups`` groups (B when S > 1 and B >= 16, else
    one), each routed alone: the router's logits upcast to float32, softmax,
    the top k gates (ties to the lower expert index, as ``lax.top_k``: a
    stable descending sort), renormalised with a 1e-9 floor. A group runs in
    chunks of ``min(group, 8192)`` tokens, which must divide it, as the
    reference's reshape requires. In a chunk each expert holds ``capacity =
    max(int(cf * chunk * k / E), min(chunk * k, 32))`` rows; an assignment's
    row is its expert's running count in flattened (token, k) order, and
    assignments past capacity are dropped (the reference's trash row). The
    combine gathers each token's k weighted rows and adds them in k order,
    the order of the reference's ``.at[token].add``, with no atomics, so a
    call gives the same bits every time."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    gn = n_groups if n_groups is not None else (b if (s > 1 and b >= 16) else 1)
    g_sz = t // gn
    xt = x.reshape(gn, g_sz, d)
    logits = torch.einsum("gtd,de->gte", xt, p["router"]).to(F32)
    gate_all = torch.softmax(logits, dim=-1)
    gate_sorted, order = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gate, sel = gate_sorted[..., :top_k], order[..., :top_k]  # (G, T/G, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    chunk = min(g_sz, 8192)
    n_c = g_sz // chunk
    if n_c * chunk != g_sz:
        raise ValueError(f"moe_mlp: a group of {g_sz} tokens is not a whole number of "
                         f"{chunk}-token chunks (the reference's reshape needs it)")
    capacity = max(int(capacity_factor * chunk * top_k / e), min(chunk * top_k, 32))
    token_id = torch.arange(chunk, device=x.device).repeat_interleave(top_k)
    ys = []
    for c in range(n_c):
        rows = slice(c * chunk, (c + 1) * chunk)
        xc, gate_c, sel_c = xt[:, rows], gate[:, rows], sel[:, rows]
        sel_flat = sel_c.reshape(gn, chunk * top_k)
        onehot = torch.nn.functional.one_hot(sel_flat, e)
        pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
        keep = pos < capacity
        slot = torch.where(keep, sel_flat * capacity + pos, e * capacity)  # (G, chunk * k)
        if _moe_drops is not None:
            _moe_drops.append((gn * chunk * top_k, (~keep).sum()))
        # scatter each kept assignment's token into its expert row; every
        # dropped one goes to the trash row e * capacity, cut off after
        buf = torch.zeros((gn, e * capacity + 1, d), dtype=x.dtype, device=x.device)
        buf.scatter_(1, slot[..., None].expand(-1, -1, d), xc[:, token_id])
        buf = buf[:, :-1].reshape(gn, e, capacity, d)
        g = torch.einsum("gecd,edf->gecf", buf, p["wi_gate"])
        u = torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
        h = torch.nn.functional.silu(g.to(F32)).to(x.dtype) * u
        out_buf = torch.einsum("gecf,efd->gecd", h, p["wo"]).reshape(gn, e * capacity, d)
        out_buf = torch.cat([out_buf, torch.zeros((gn, 1, d), dtype=x.dtype, device=x.device)],
                            dim=1)
        wgt = (gate_c.reshape(gn, -1, 1) * keep[..., None]).to(x.dtype)
        per_assign = (torch.gather(out_buf, 1, slot[..., None].expand(-1, -1, d)) * wgt)
        per_assign = per_assign.reshape(gn, chunk, top_k, d)
        y = per_assign[:, :, 0]
        for j in range(1, top_k):
            y = y + per_assign[:, :, j]
        ys.append(y)
    y = ys[0] if n_c == 1 else torch.cat(ys, dim=1)
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Embedding, unembedding
# ---------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    h = table[tokens.long()]
    if scale:
        h = h * torch.tensor(table.shape[-1] ** 0.5, dtype=h.dtype, device=h.device)
    return h


def unembed_loglik(
    h: torch.Tensor,  # (B, S, D)
    table: torch.Tensor,  # (V, D) (tied): logits = h @ table.T
    targets: torch.Tensor,  # (B, S)
    mask: torch.Tensor,  # (B, S)
    chunk: int = 512,
) -> torch.Tensor:
    """Per-sequence log-likelihood, a loop over sequence chunks so the
    (B, S, V) logits never exist at once. The plain path, as in the
    reference: the logits are computed in the operands' dtype and then
    upcast; the fused CE kernel is not on this route (the reference does not
    route it there either). The reference pads S to a multiple of ``chunk``;
    the padded positions carry mask 0, so a shorter last chunk gives the same
    sum."""
    b, s, _ = h.shape
    total = torch.zeros((b,), dtype=F32, device=h.device)
    mh = mask.to(h.dtype)
    for c0 in range(0, s, chunk):
        hc, tc, mc = h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], mh[:, c0:c0 + chunk]
        logits = torch.einsum("bcd,vd->bcv", hc, table).to(F32)
        logz = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tc.long()[..., None])[..., 0]
        total = total + ((tgt - logz) * mc).sum(-1)
    return total
