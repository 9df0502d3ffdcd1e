"""Fused cell kernels of the frozen SegmentCritic's decode step: one LSTM or
GRU cell per launch, gate product and state update in one kernel
(``csrc/critic_cells.cu``), over weights packed once per decode.

``pack_lstm`` / ``pack_gru`` turn a cell's torch-layout weights into one
K-major buffer over the concatenated ``[x, h]`` axis, columns interleaved
by tiles of ``UNITS`` hidden units, with the biases pre-summed where the
math allows (the layout is spelled out in ``PackedCell``). The critic is
frozen, so a decode packs once (``SegmentCritic.step_weights``) and every
token's cells read the packed form.

Each cell is a ``torch.library`` custom op (``bmhrl::lstm_cell_packed``,
``bmhrl::gru_cell_packed``) over the packed buffers and the widths as plain
tensors and ints, so an exported program carries it: the op runs the plain
version beside it for CPU tensors and launches the kernel on the current
stream for CUDA tensors (or raises). Exact f32 either way. The wrappers
take a ``PackedCell`` and call the op.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from bmhrl_tpu_torch.ops import _cuda

# The packed layout's tiles. csrc/critic_cells.cu has them as BN and BK and
# refuses a buffer whose shape (passed with it) is not its own layout.
UNITS = 8    # hidden units per kernel block (BN in csrc/critic_cells.cu)
KTILE = 32   # contraction tile (BK there): each half of [x, h] is padded
             # to a multiple of it


class PackedCell(NamedTuple):
    """A cell's weights in the kernel's layout, for input width K and
    hidden width H, with T = ceil(H / UNITS) unit tiles, Kp and Hp = K and
    H rounded up to KTILE, and G = 4 (LSTM) or 3 (GRU) gates per unit.

    w: (T, Kp + Hp, UNITS * G) f32. ``w[t, k, u * G + g]`` is the weight of
       gate g of hidden unit t * UNITS + u at contraction row k: rows
       [0, K) are W_ih's columns, rows [Kp, Kp + H) W_hh's, the padding and
       the units past H are zero. LSTM gates are (i, f, g, o); GRU gates are
       (r, z, n) in both halves, so the x-half holds n's x-part and the
       h-half its h-part.
    b: (T * UNITS, 4) f32 per unit: LSTM (b_i, b_f, b_g, b_o) of b_ih +
       b_hh; GRU (b_ir + b_hr, b_iz + b_hz, b_in, b_hn)."""
    w: torch.Tensor
    b: torch.Tensor
    K: int
    H: int


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pack_weights(w_ih: torch.Tensor, w_hh: torch.Tensor,
                  G: int) -> torch.Tensor:
    H = w_hh.shape[1]
    Hu = _ceil_to(H, UNITS)

    def half(w):  # (G*H, n) -> (n padded to KTILE, T, UNITS, G)
        n = w.shape[1]
        w = F.pad(w.reshape(G, H, n), (0, _ceil_to(n, KTILE) - n, 0, Hu - H))
        return w.permute(2, 1, 0).reshape(-1, Hu // UNITS, UNITS, G)

    w = torch.cat([half(w_ih.detach().float()), half(w_hh.detach().float())])
    return w.permute(1, 0, 2, 3).reshape(Hu // UNITS, w.shape[0],
                                         UNITS * G).contiguous()


def _pack_bias(cols, H: int) -> torch.Tensor:
    b = torch.stack([c.detach().float() for c in cols], dim=-1)  # (H, 4)
    return F.pad(b, (0, 0, 0, _ceil_to(H, UNITS) - H)).contiguous()


def pack_lstm(w_ih: torch.Tensor, w_hh: torch.Tensor,
              b_sum: torch.Tensor) -> PackedCell:
    """LSTM weights w_ih (4H, K), w_hh (4H, H) and b_sum = b_ih + b_hh (4H,)
    in the kernel's layout."""
    H = w_hh.shape[1]
    return PackedCell(_pack_weights(w_ih, w_hh, 4),
                      _pack_bias(b_sum.reshape(4, H), H), w_ih.shape[1], H)


def pack_gru(w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor) -> PackedCell:
    """GRU weights w_ih (3H, K), w_hh (3H, H), b_ih, b_hh (3H,) in the
    kernel's layout; r's and z's biases summed, n's kept apart (r scales
    only the h-part of n)."""
    H = w_hh.shape[1]
    bi, bh = b_ih.reshape(3, H), b_hh.reshape(3, H)
    return PackedCell(_pack_weights(w_ih, w_hh, 3),
                      _pack_bias((bi[0] + bh[0], bi[1] + bh[1], bi[2], bh[2]),
                                 H), w_ih.shape[1], H)


def _packed_gates(x, h, p: PackedCell, G: int):
    """Gate sums of the x-half and of the h-half, each (B, H, G)."""
    Kp = _ceil_to(p.K, KTILE)
    ax = F.pad(x, (0, Kp - p.K))
    ah = F.pad(h, (0, p.w.shape[1] - Kp - p.H))
    B, T = x.shape[0], p.w.shape[0]

    def gates(a, w):
        return torch.einsum("bk,tkc->btc", a, w).reshape(
            B, T * UNITS, G)[:, :p.H]

    return gates(ax, p.w[:, :Kp]), gates(ah, p.w[:, Kp:])


def lstm_cell_packed_plain(x, h, c, p: PackedCell):
    """Plain version of ``lstm_cell_packed``: the same sums over the packed
    buffer."""
    gx, gh = _packed_gates(x, h, p, 4)
    i, f, g, o = (gx + gh + p.b[:p.H]).unbind(-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell_packed_plain(x, h, p: PackedCell):
    """Plain version of ``gru_cell_packed``."""
    gx, gh = _packed_gates(x, h, p, 3)
    br, bz, bn_x, bn_h = p.b[:p.H].unbind(-1)
    r = torch.sigmoid(gx[..., 0] + gh[..., 0] + br)
    z = torch.sigmoid(gx[..., 1] + gh[..., 1] + bz)
    n = torch.tanh(gx[..., 2] + bn_x + r * (gh[..., 2] + bn_h))
    return (1.0 - z) * n + z * h


def lstm_cell_plain(x, h, c, w_ih, w_hh, b_sum):
    """The LSTM cell on torch-layout weights (no packing), gate order
    i, f, g, o."""
    gates = x @ w_ih.t() + h @ w_hh.t() + b_sum
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell_plain(x, h, w_ih, w_hh, b_ih, b_hh):
    """The GRU cell on torch-layout weights (no packing), torch
    semantics."""
    xr, xz, xn = (x @ w_ih.t() + b_ih).chunk(3, dim=-1)
    hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _check(what, x, h, p: PackedCell, G: int, extra=()):
    """Raise unless x (B, K), h and ``extra`` (B, H) and the packed buffers
    are contiguous f32 on one CUDA device and match; returns (B, vec4)."""
    _cuda.require_cuda(what, x, h, p.w, p.b, *extra)
    B = x.shape[0]
    T = -(-p.H // UNITS)
    want = [("x", x, (B, p.K)), ("h", h, (B, p.H)),
            ("w", p.w, (T, _ceil_to(p.K, KTILE) + _ceil_to(p.H, KTILE),
                        UNITS * G)),
            ("b", p.b, (T * UNITS, 4))]
    want += [("c", t, (B, p.H)) for t in extra]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32")
    if p.w.data_ptr() % 16 or p.b.data_ptr() % 16:
        raise ValueError(f"{what}: packed buffers must be 16-byte aligned")
    vec4 = (p.K % 4 == 0 and p.H % 4 == 0
            and x.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0)
    return B, int(vec4)


def lstm_cell_packed(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                     p: PackedCell) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell step over packed weights (``pack_lstm``). x (B, K);
    h, c (B, H). Returns (h', c'): the op ``bmhrl::lstm_cell_packed``."""
    return torch.ops.bmhrl.lstm_cell_packed(x, h, c, p.w, p.b, p.K, p.H)


def gru_cell_packed(x: torch.Tensor, h: torch.Tensor,
                    p: PackedCell) -> torch.Tensor:
    """One GRU cell step over packed weights (``pack_gru``), torch gate
    semantics. x (B, K); h (B, H). Returns h': the op
    ``bmhrl::gru_cell_packed``."""
    return torch.ops.bmhrl.gru_cell_packed(x, h, p.w, p.b, p.K, p.H)


def _lstm_cell_op(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, K: int, H: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bmhrl::lstm_cell_packed``: the plain version for CPU tensors, else
    one launch of ``lstm_cell_kernel`` on the current stream."""
    p = PackedCell(w, b, K, H)
    if x.device.type == "cpu":
        return lstm_cell_packed_plain(x, h, c, p)
    what = "lstm_cell"
    B, vec4 = _check(what, x, h, p, 4, (c,))
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = _lib()
    err = lib.bmhrl_lstm_cell(x.data_ptr(), h.data_ptr(), c.data_ptr(),
                              w.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                              c_out.data_ptr(), B, K, H, *w.shape,
                              b.shape[0], vec4, _cuda.stream_of(x))
    _cuda.check(lib, err, what)
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_out, c_out


def _gru_cell_op(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, K: int, H: int) -> torch.Tensor:
    """``bmhrl::gru_cell_packed``: the plain version for CPU tensors, else
    one launch of ``gru_cell_kernel`` on the current stream."""
    p = PackedCell(w, b, K, H)
    if x.device.type == "cpu":
        return gru_cell_packed_plain(x, h, p)
    what = "gru_cell"
    B, vec4 = _check(what, x, h, p, 3)
    h_out = torch.empty_like(h)
    lib = _lib()
    err = lib.bmhrl_gru_cell(x.data_ptr(), h.data_ptr(), w.data_ptr(),
                             b.data_ptr(), h_out.data_ptr(), B, K, H,
                             *w.shape, b.shape[0], vec4, _cuda.stream_of(x))
    _cuda.check(lib, err, what)
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_out


_cuda.register_op(
    "lstm_cell_packed", _lstm_cell_op,
    "(Tensor x, Tensor h, Tensor c, Tensor w, Tensor b, int K, int H) -> "
    "(Tensor, Tensor)",
    lambda x, h, c, w, b, K, H: (torch.empty_like(h), torch.empty_like(c)))
_cuda.register_op(
    "gru_cell_packed", _gru_cell_op,
    "(Tensor x, Tensor h, Tensor w, Tensor b, int K, int H) -> Tensor",
    lambda x, h, w, b, K, H: torch.empty_like(h))


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b_sum: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell step (gate order i, f, g, o) on torch-layout weights:
    x (B, K); h, c (B, H); w_ih (4H, K); w_hh (4H, H); b_sum = b_ih + b_hh
    (4H,). Packs, then ``lstm_cell_packed``; a decode packs once instead."""
    return lstm_cell_packed(x, h, c, pack_lstm(w_ih, w_hh, b_sum))


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor
             ) -> torch.Tensor:
    """One GRU cell step with torch gate semantics (r, z, n;
    n = tanh(x W_in + b_in + r (h W_hn + b_hn))) on torch-layout weights:
    x (B, K); h (B, H); w_ih (3H, K); w_hh (3H, H); biases (3H,). Packs,
    then ``gru_cell_packed``."""
    return gru_cell_packed(x, h, pack_gru(w_ih, w_hh, b_ih, b_hh))


def _lib():
    lib = _cuda.library("critic_cells")
    P, I = _cuda.P, _cuda.I
    if lib.bmhrl_lstm_cell.argtypes is None:
        lib.bmhrl_lstm_cell.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.bmhrl_lstm_cell.restype = I
        lib.bmhrl_gru_cell.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.bmhrl_gru_cell.restype = I
    return lib
