"""Fused cell kernels of the frozen SegmentCritic's decode step: one LSTM or
GRU cell per launch, gate product and state update in one kernel
(``csrc/critic_cells.cu``).

The wrappers run the plain version beside them for CPU tensors and launch
the kernel for CUDA tensors (or raise). Exact f32 either way.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bmhrl_tpu_torch.ops import _cuda


def lstm_cell_plain(x, h, c, w_ih, w_hh, b_sum):
    gates = x @ w_ih.t() + h @ w_hh.t() + b_sum
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell_plain(x, h, w_ih, w_hh, b_ih, b_hh):
    xr, xz, xn = (x @ w_ih.t() + b_ih).chunk(3, dim=-1)
    hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _check(what, x, h, w_ih, w_hh, n_gates, biases):
    _cuda.require_cuda(what, x, h, w_ih, w_hh, *biases)
    B, K = x.shape
    H = h.shape[1]
    want = {"x": (x, (B, K)), "h": (h, (B, H)),
            "w_ih": (w_ih, (n_gates * H, K)), "w_hh": (w_hh, (n_gates * H, H))}
    for i, b in enumerate(biases):
        want[f"bias{i}"] = (b, (n_gates * H,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32")
    return B, K, H


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b_sum: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell step (gate order i, f, g, o). x (B, K); h, c (B, H);
    w_ih (4H, K); w_hh (4H, H); b_sum = b_ih + b_hh (4H,). Returns (h', c')."""
    if x.device.type == "cpu":
        return lstm_cell_plain(x, h, c, w_ih, w_hh, b_sum)
    what = "lstm_cell"
    B, K, H = _check(what, x, h, w_ih, w_hh, 4, (b_sum,))
    _cuda.require_cuda(what, x, c)
    if tuple(c.shape) != (B, H) or c.dtype != torch.float32 \
            or not c.is_contiguous():
        raise ValueError(f"{what}: c must be contiguous float32 {(B, H)}")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = _lib()
    err = lib.bmhrl_rnn_cell(1, x.data_ptr(), h.data_ptr(), c.data_ptr(),
                             w_ih.data_ptr(), w_hh.data_ptr(),
                             b_sum.data_ptr(), None, h_out.data_ptr(),
                             c_out.data_ptr(), B, K, H, _cuda.stream_of(x))
    _cuda.check(lib, err, what)
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_out, c_out


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor
             ) -> torch.Tensor:
    """One GRU cell step with torch gate semantics (r, z, n;
    n = tanh(x W_in + b_in + r (h W_hn + b_hn))). x (B, K); h (B, H);
    w_ih (3H, K); w_hh (3H, H); biases (3H,). Returns h'."""
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, w_ih, w_hh, b_ih, b_hh)
    what = "gru_cell"
    B, K, H = _check(what, x, h, w_ih, w_hh, 3, (b_ih, b_hh))
    h_out = torch.empty_like(h)
    lib = _lib()
    err = lib.bmhrl_rnn_cell(0, x.data_ptr(), h.data_ptr(), None,
                             w_ih.data_ptr(), w_hh.data_ptr(),
                             b_ih.data_ptr(), b_hh.data_ptr(),
                             h_out.data_ptr(), None, B, K, H,
                             _cuda.stream_of(x))
    _cuda.check(lib, err, what)
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_out


def _lib():
    lib = _cuda.library("critic_cells")
    fn = lib.bmhrl_rnn_cell
    if fn.argtypes is None:
        P, I = _cuda.P, _cuda.I
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return lib
