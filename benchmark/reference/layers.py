"""Plain PyTorch building blocks of the benchmark's references.

Everything here is float32 and functional: a layer reads its weights from a
flat ``{name: tensor}`` dict under a name prefix. ``rnd`` is the rounding
applied to both operands of every product that the configuration runs in
its reduced precision: ``exact`` (nothing) for the reference, a lower
precision for the control (``precision.py``). Parts the configuration
keeps in float32 take no ``rnd``.

Masks are boolean, True = attend; a masked score is -1e9, so a row with
every key masked averages the values.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def sinusoid_table(seq_len: int, d: int, device) -> torch.Tensor:
    """(seq_len, d) positional table: even columns sin, odd columns cos, each
    column's own index in the frequency exponent."""
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    tab = np.zeros((seq_len, d), dtype=np.float64)
    even, odd = np.arange(0, d, 2), np.arange(1, d, 2)
    tab[:, even] = np.sin(pos / (10000.0 ** (even / d)))
    tab[:, odd] = np.cos(pos / (10000.0 ** (odd / d)))
    return torch.from_numpy(tab.astype(np.float32)).to(device)


def linear(p, name: str, x: torch.Tensor, rnd=exact) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return rnd(x) @ rnd(w).t() + b


def layer_norm(p, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def mha(p, name: str, Q, K, V, mask, H: int, rnd=exact) -> torch.Tensor:
    """Multi-headed attention with projections Q2d/K2d/V2d/d2Q. ``mask``:
    (B, 1, Sk) key padding, (B, Sq, Sk) or None."""
    q = linear(p, f"{name}.linear_Q2d", Q, rnd)
    k = linear(p, f"{name}.linear_K2d", K, rnd)
    v = linear(p, f"{name}.linear_V2d", V, rnd)
    B, Sq, d = q.shape
    dk = d // H

    def heads(x):
        return x.reshape(B, x.shape[1], H, dk).transpose(1, 2)

    s = rnd(heads(q)) @ rnd(heads(k)).transpose(-1, -2) / math.sqrt(dk)
    if mask is not None:
        s = s.masked_fill(~mask[:, None], NEG_INF)
    ctx = rnd(torch.softmax(s, dim=-1)) @ rnd(heads(v))
    return linear(p, f"{name}.linear_d2Q",
                  ctx.transpose(1, 2).reshape(B, Sq, d), rnd)


def feed_forward(p, name: str, x, rnd=exact):
    return linear(p, f"{name}.fc2",
                  torch.relu(linear(p, f"{name}.fc1", x, rnd)), rnd)


def bimodal_encoder(p, name: str, n_layers: int, M1, M2, m1_mask, m2_mask,
                    H: int, rnd=exact):
    """Prenorm layers: self-attention per modality, cross-modal attention
    both ways, a feed-forward per modality. Returns (M1 side, M2 side)."""
    for i in range(n_layers):
        L = f"{name}.layer_{i}"

        def ln(j, m, x):
            return layer_norm(p, f"{L}.res_M{m}_{j}.norm", x, 1e-5)

        h = ln(0, 1, M1)
        M1 = M1 + mha(p, f"{L}.self_att_M1", h, h, h, m1_mask, H, rnd)
        h = ln(0, 2, M2)
        M2 = M2 + mha(p, f"{L}.self_att_M2", h, h, h, m2_mask, H, rnd)
        M1m2 = M1 + mha(p, f"{L}.bi_modal_att_M1", ln(1, 1, M1), M2, M2,
                        m2_mask, H, rnd)
        M2m1 = M2 + mha(p, f"{L}.bi_modal_att_M2", ln(1, 2, M2), M1, M1,
                        m1_mask, H, rnd)
        M1 = M1m2 + feed_forward(p, f"{L}.ff_M1", ln(2, 1, M1m2), rnd)
        M2 = M2m1 + feed_forward(p, f"{L}.ff_M2", ln(2, 2, M2m1), rnd)
    return M1, M2


def lstm(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """torch.nn.LSTM semantics (gates i, f, g, o) from a zero state, f32:
    (B, L, K) -> (B, L, H)."""
    w_ih, w_hh = p[f"{name}.weight_ih"], p[f"{name}.weight_hh"]
    xg = x @ w_ih.t() + p[f"{name}.bias_ih"]
    h = c = x.new_zeros(x.shape[0], w_hh.shape[1])
    out = []
    for t in range(x.shape[1]):
        i, f, g, o = (xg[:, t] + h @ w_hh.t()
                      + p[f"{name}.bias_hh"]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def gru(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """torch.nn.GRU semantics (gates r, z, n) from a zero state, f32."""
    w_ih, w_hh = p[f"{name}.weight_ih"], p[f"{name}.weight_hh"]
    xg = x @ w_ih.t() + p[f"{name}.bias_ih"]
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    out = []
    for t in range(x.shape[1]):
        xr, xz, xn = xg[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh.t() + p[f"{name}.bias_hh"]).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        out.append(h)
    return torch.stack(out, dim=1)


def arelu(p, name: str, x: torch.Tensor) -> torch.Tensor:
    a = p[f"{name}.alpha"].clamp(0.01, 0.99)
    b = 1.0 + torch.sigmoid(p[f"{name}.beta"])
    return torch.relu(x) * b - torch.relu(-x) * a


def conv_same(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """'SAME' 1-d convolution over (B, L, C): (k-1)//2 before, k//2 after."""
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    x = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(x, w, p[f"{name}.bias"]).transpose(1, 2)


# ---- parameter specs: name -> (shape, init). ``weights.make_params`` reads
# the init kinds.

def spec_linear(spec, name, d_in, d_out, init="lecun"):
    spec[f"{name}.weight"] = ((d_out, d_in), init)
    spec[f"{name}.bias"] = ((d_out,), "bias")


def spec_norm(spec, name, d):
    spec[f"{name}.weight"] = ((d,), "scale")
    spec[f"{name}.bias"] = ((d,), "bias")


def spec_mha(spec, name, dq, dk, dv, d):
    spec_linear(spec, f"{name}.linear_Q2d", dq, d)
    spec_linear(spec, f"{name}.linear_K2d", dk, d)
    spec_linear(spec, f"{name}.linear_V2d", dv, d)
    spec_linear(spec, f"{name}.linear_d2Q", d, dq)


def spec_encoder(spec, name, n_layers, d1, d2, d, ff1, ff2):
    for i in range(n_layers):
        L = f"{name}.layer_{i}"
        spec_mha(spec, f"{L}.self_att_M1", d1, d1, d1, d)
        spec_mha(spec, f"{L}.self_att_M2", d2, d2, d2, d)
        spec_mha(spec, f"{L}.bi_modal_att_M1", d1, d2, d2, d)
        spec_mha(spec, f"{L}.bi_modal_att_M2", d2, d1, d1, d)
        spec_linear(spec, f"{L}.ff_M1.fc1", d1, ff1)
        spec_linear(spec, f"{L}.ff_M1.fc2", ff1, d1)
        spec_linear(spec, f"{L}.ff_M2.fc1", d2, ff2)
        spec_linear(spec, f"{L}.ff_M2.fc2", ff2, d2)
        for j in range(3):
            spec_norm(spec, f"{L}.res_M1_{j}.norm", d1)
            spec_norm(spec, f"{L}.res_M2_{j}.norm", d2)
