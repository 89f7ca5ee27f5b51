"""Recurrent sequence blocks of the xLSTM family: mLSTM (matrix memory) and
sLSTM (scalar memory, recurrent gates). The port of the xLSTM half of
``repro.models.ssm``.

Both blocks share the reference's calling convention

    y, new_state = block(x, params, state=None)

with ``x: (B, S, D)``; ``state`` carries the recurrent summary for decoding
(one-token steps with S = 1 continue from it). The recurrence is a Python
loop over time steps in float32, with the reference's order of operations
inside each step (its ``lax.scan`` body).

Deferred: ``MambaState`` and ``mamba_block`` come with the hybrid family.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

Params = dict[str, Any]
F32 = torch.float32


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
