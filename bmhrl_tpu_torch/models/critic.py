"""Frozen SegmentCritic: 4-layer LSTM(D -> 2D) -> AReLU -> 2-layer GRU(2D)
-> AReLU -> Linear(2D -> 1) (the port of bmhrl_tpu/models/critic.py), over
a whole caption (``forward``, the training path) or one token at a time
(``init_state``/``step``, the decode), and ``logits_trainable``, the
forward with a gradient of critic pretraining (``cli.train_critic``).

Parameters keep torch's RNN layout (w_ih (nG*H, in), gate order LSTM i,f,g,o
and GRU r,z,n), which is also the JAX package's. Every cell runs through
``ops.critic_kernels`` (a fused kernel per cell on the card, over weights
packed once per call by ``step_weights``), f32 throughout. The
full-sequence pass is L cell steps per layer, where the JAX package scans
(``lax.scan``) with ``x·W_ihᵀ + b_ih`` taken for all positions first and
``h·W_hhᵀ + b_hh`` added per step; the cells sum both halves and the
pre-summed biases at once, which agrees to ~1 ulp in f32.

``logits_trainable`` scans each layer in plain PyTorch with autograd, on
the card too: the JAX package's trainable scan is plain XLA as well (its
cell kernels serve only the frozen steps and have no backward), and it
follows that scan's order (``x·W_ihᵀ + b_ih`` for all positions, then the
hidden half per step).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from bmhrl_tpu_torch.models.blocks import AReLU, Dense
from bmhrl_tpu_torch.ops import critic_kernels as ck


class _RNNLayer(nn.Module):
    def __init__(self, n_gates: int, d_in: int, d_hidden: int, device=None):
        super().__init__()
        G = n_gates * d_hidden
        self.weight_ih = nn.Parameter(torch.zeros(G, d_in, device=device))
        self.weight_hh = nn.Parameter(torch.zeros(G, d_hidden, device=device))
        self.bias_ih = nn.Parameter(torch.zeros(G, device=device))
        self.bias_hh = nn.Parameter(torch.zeros(G, device=device))


class LSTMLayer(_RNNLayer):
    def __init__(self, d_in: int, d_hidden: int, device=None):
        super().__init__(4, d_in, d_hidden, device)

    def scan(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, K) -> (B, L, H) with a gradient, torch LSTM semantics."""
        xg = x.float() @ self.weight_ih.t() + self.bias_ih
        h = c = xg.new_zeros(x.shape[0], self.weight_hh.shape[1])
        hs = []
        for t in range(x.shape[1]):
            gates = xg[:, t] + h @ self.weight_hh.t() + self.bias_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    def step_weights(self) -> ck.PackedCell:
        return ck.pack_lstm(self.weight_ih, self.weight_hh,
                            self.bias_ih + self.bias_hh)

    def step(self, xt: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
             packed: ck.PackedCell):
        h, c = ck.lstm_cell_packed(xt, state[0], state[1], packed)
        return h, (h, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, K) -> (B, L, H) hidden states from a zero state."""
        packed = self.step_weights()
        z = x.new_zeros(x.shape[0], self.weight_hh.shape[1])
        return _scan(lambda xt, st: self.step(xt, st, packed), x, (z, z))


class GRULayer(_RNNLayer):
    def __init__(self, d_in: int, d_hidden: int, device=None):
        super().__init__(3, d_in, d_hidden, device)

    def scan(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, K) -> (B, L, H) with a gradient, torch GRU semantics."""
        xg = x.float() @ self.weight_ih.t() + self.bias_ih
        h = xg.new_zeros(x.shape[0], self.weight_hh.shape[1])
        hs = []
        for t in range(x.shape[1]):
            hg = h @ self.weight_hh.t() + self.bias_hh
            xr, xz, xn = xg[:, t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            h = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
            hs.append(h)
        return torch.stack(hs, dim=1)

    def step_weights(self) -> ck.PackedCell:
        return ck.pack_gru(self.weight_ih, self.weight_hh, self.bias_ih,
                           self.bias_hh)

    def step(self, xt: torch.Tensor, h: torch.Tensor, packed: ck.PackedCell):
        h = ck.gru_cell_packed(xt, h, packed)
        return h, h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, K) -> (B, L, H) hidden states from a zero state."""
        packed = self.step_weights()
        z = x.new_zeros(x.shape[0], self.weight_hh.shape[1])
        return _scan(lambda xt, st: self.step(xt, st, packed), x, z)


def _scan(step, x: torch.Tensor, state) -> torch.Tensor:
    """Run ``step(x_t, state) -> (h_t, state)`` over the positions of x
    (B, L, K), f32; stack the h_t to (B, L, H)."""
    xs = x.float().transpose(0, 1).contiguous()  # each x_t contiguous
    hs = []
    for xt in xs:
        h, state = step(xt, state)
        hs.append(h)
    return torch.stack(hs, dim=1)


class SegmentCritic(nn.Module):
    """Frozen segment-boundary detector. It never trains: ``forward`` runs
    under ``torch.no_grad()`` and the optimizer masks its parameters."""

    def __init__(self, d_model_caps: int = 300, device=None):
        super().__init__()
        D, H = d_model_caps, 2 * d_model_caps
        self.d_hidden = H
        for l in range(4):
            self.add_module(f"lstm_l{l}",
                            LSTMLayer(D if l == 0 else H, H, device))
        for l in range(2):
            self.add_module(f"gru_l{l}", GRULayer(H, H, device))
        self.relu = AReLU(device=device)
        self.relu2 = AReLU(device=device)
        self.lin = Dense(H, 1, torch.float32, device)

    @torch.no_grad()
    def forward(self, embedded: torch.Tensor) -> torch.Tensor:
        """(B, L, d_caps) scaled caption embeddings -> (B, L, 1) logits."""
        h = embedded
        for l in range(4):
            h = getattr(self, f"lstm_l{l}")(h)
        h = self.relu(h)
        for l in range(2):
            h = getattr(self, f"gru_l{l}")(h)
        return self.lin(self.relu2(h))

    def logits_trainable(self, embedded: torch.Tensor) -> torch.Tensor:
        """``forward`` with a gradient (critic pretraining): (B, L, d_caps)
        -> (B, L, 1) logits through the plain scans."""
        h = embedded.float()
        for l in range(4):
            h = getattr(self, f"lstm_l{l}").scan(h)
        h = self.relu(h)
        for l in range(2):
            h = getattr(self, f"gru_l{l}").scan(h)
        return self.lin(self.relu2(h))

    def init_state(self, B: int) -> Dict[str, List]:
        dev = self.lin.weight.device
        z = torch.zeros(B, self.d_hidden, device=dev)
        return {"lstm": [(z, z) for _ in range(4)], "gru": [z, z]}

    def step_weights(self) -> Dict[str, List[ck.PackedCell]]:
        """Every cell's weights packed for the cell kernels. The critic is
        frozen, so a decode packs once and hands the result to each
        ``step``."""
        return {"lstm": [getattr(self, f"lstm_l{l}").step_weights()
                         for l in range(4)],
                "gru": [getattr(self, f"gru_l{l}").step_weights()
                        for l in range(2)]}

    def step(self, emb_t: torch.Tensor, state: Dict[str, List],
             weights: Optional[Dict[str, List[ck.PackedCell]]] = None):
        """emb_t: (B, d_caps) scaled token embedding -> ((B, 1) logit, new
        state). ``weights``: ``step_weights()``, packed anew when None."""
        if weights is None:
            weights = self.step_weights()
        h = emb_t.float().contiguous()
        new_lstm = []
        for l, st in enumerate(state["lstm"]):
            h, st = getattr(self, f"lstm_l{l}").step(h, st,
                                                     weights["lstm"][l])
            new_lstm.append(st)
        h = self.relu(h)
        new_gru = []
        for l, st in enumerate(state["gru"]):
            h, st = getattr(self, f"gru_l{l}").step(h, st, weights["gru"][l])
            new_gru.append(st)
        h = self.relu2(h)
        return self.lin(h), {"lstm": new_lstm, "gru": new_gru}
