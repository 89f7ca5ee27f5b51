"""Recurrent sequence blocks: Mamba (selective SSM), xLSTM (mLSTM, matrix
memory, and sLSTM, scalar memory with recurrent gates). The port of
``repro.models.ssm``.

Both blocks share the reference's calling convention

    y, new_state = block(x, params, state=None)

with ``x: (B, S, D)``; ``state`` carries the recurrent summary for decoding
(one-token steps with S = 1 continue from it). The recurrence is a Python
loop over time steps in float32, with the reference's order of operations
inside each step (its ``lax.scan`` body).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

Params = dict[str, Any]
F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, kernel - 1, di) trailing inputs of the causal conv
    ssm: torch.Tensor  # (B, di, ds) float32


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, di); w: (k, di); prefix: (B, k-1, di).
    The taps are added in the reference's order, each rounded to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + w[j] * xp[:, j:j + s]
    return out + b


def mamba_block(x: torch.Tensor, p: Params,
                state: MambaState | None = None) -> tuple[torch.Tensor, MambaState]:
    """The selective scan over time steps in float32. The conv state comes
    back in the activations' dtype (the cache's conv prefix is cast to it, as
    the reference's concatenation promotes it), the SSM state in float32."""
    b, s, _ = x.shape
    di, ds = p["a_log"].shape
    kernel = p["conv_w"].shape[0]
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    x_in, z = torch.split(xz, di, dim=-1)  # (B, S, di) each

    if state is not None:
        prefix = state.conv.to(x_in.dtype)
    else:
        prefix = torch.zeros((b, kernel - 1, di), dtype=x.dtype, device=x.device)
    x_c = _causal_conv(x_in, p["conv_w"], p["conv_b"], prefix)
    new_conv = torch.cat([prefix, x_in], dim=1)[:, -(kernel - 1):, :]
    x_c = F.silu(x_c.to(F32)).to(x.dtype)

    proj = torch.einsum("bse,ef->bsf", x_c, p["x_proj"])
    dt_rank = p["dt_proj"].shape[0]
    dt_r = proj[..., :dt_rank]
    b_mat = proj[..., dt_rank:dt_rank + ds].to(F32)
    c_mat = proj[..., dt_rank + ds:].to(F32)
    dt_pre = torch.einsum("bsr,re->bse", dt_r, p["dt_proj"]).to(F32) + p["dt_bias"]
    dt = torch.logaddexp(dt_pre, torch.zeros((), dtype=F32, device=x.device))  # softplus
    a = -torch.exp(p["a_log"].to(F32))  # (di, ds)

    h = state.ssm.to(F32) if state is not None else \
        torch.zeros((b, di, ds), dtype=F32, device=x.device)
    xcf = x_c.to(F32)
    ys = []
    for t in range(s):
        dt_t, b_t, c_t, x_t = dt[:, t], b_mat[:, t], c_mat[:, t], xcf[:, t]
        decay = torch.exp(dt_t[..., None] * a)  # (B, di, ds)
        h = h * decay + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bes,bs->be", h, c_t))
    y = torch.stack(ys, dim=1) + p["d_skip"].to(F32) * xcf
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, MambaState(conv=new_conv, ssm=h)


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh, dh)
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H)


def mlstm_block(x: torch.Tensor, p: Params,
                state: MLSTMState | None = None) -> tuple[torch.Tensor, MLSTMState]:
    b, s, _ = x.shape
    n_heads, dh = p["wq"].shape[1], p["wq"].shape[2]
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"]).to(F32)
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"]).to(F32) * dh ** -0.5
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"]).to(F32)
    i_log = torch.einsum("bsd,dn->bsn", x, p["wi"]).to(F32)
    f_log = F.logsigmoid(torch.einsum("bsd,dn->bsn", x, p["wf"]).to(F32))
    o_gate = torch.sigmoid(torch.einsum("bsd,dn->bsn", x, p["wo_gate"]).to(F32))

    if state is None:
        c = torch.zeros((b, n_heads, dh, dh), dtype=F32, device=x.device)
        n = torch.zeros((b, n_heads, dh), dtype=F32, device=x.device)
        m = torch.full((b, n_heads), -1e30, dtype=F32, device=x.device)
    else:
        c, n, m = state
    hs = []
    for t in range(s):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]
        i_t, f_t, o_t = i_log[:, t], f_log[:, t], o_gate[:, t]
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * torch.einsum(
            "bnh,bng->bnhg", v_t, k_t)
        n = f_p[..., None] * n + i_p[..., None] * k_t
        num = torch.einsum("bnhg,bng->bnh", c, q_t)
        den = torch.clamp_min(torch.abs(torch.einsum("bng,bng->bn", n, q_t)), 1.0)
        hs.append(o_t[..., None] * num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(b, s, n_heads * dh).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", h, p["out_proj"])
    return out, MLSTMState(c=c, n=n, m=m)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gates)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    h: torch.Tensor  # (B, H, dh)
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H, dh)


def slstm_block(x: torch.Tensor, p: Params,
                state: SLSTMState | None = None) -> tuple[torch.Tensor, SLSTMState]:
    b, s, _ = x.shape
    n_heads, dh = p["r"].shape[0], p["r"].shape[1]
    wx = torch.einsum("bsd,dnf->bsnf", x, p["w"]).to(F32)  # (B, S, H, 4dh)

    if state is None:
        zeros = torch.zeros((b, n_heads, dh), dtype=F32, device=x.device)
        h, c, n = zeros, zeros, zeros
        m = torch.full((b, n_heads, dh), -1e30, dtype=F32, device=x.device)
    else:
        h, c, n, m = state
    r = p["r"].to(F32)  # (H, dh, 4dh): a block-diagonal recurrence
    bias = p["b"].to(F32)  # (H, 4dh)
    hs = []
    for t in range(s):
        pre = wx[:, t] + torch.einsum("bnh,nhf->bnf", h, r) + bias  # (B, H, 4dh)
        z_t, i_t, f_t, o_t = torch.split(pre, dh, dim=-1)
        z_t = torch.tanh(z_t)
        o_t = torch.sigmoid(o_t)
        f_log = F.logsigmoid(f_t)
        m_new = torch.maximum(f_log + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_log + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, n_heads * dh).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, SLSTMState(h, c, n, m)
