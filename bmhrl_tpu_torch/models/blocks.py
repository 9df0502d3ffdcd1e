"""Transformer building blocks (the port of bmhrl_tpu/models/blocks.py).

Parameters are f32 masters. ``Dense`` keeps flax's ``nn.Dense(dtype=...)``
cast points: input, weight and bias are cast to the compute dtype and the
output stays in it, so bf16 on the card rounds where the TPU rounded.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoid_table(seq_len: int, d_model: int) -> np.ndarray:
    """Positional table: even columns sin, odd columns cos, each column using
    its OWN index in the frequency exponent (the reference's convention)."""
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    tab = np.zeros((seq_len, d_model), dtype=np.float64)
    even = np.arange(0, d_model, 2)
    odd = np.arange(1, d_model, 2)
    tab[:, even] = np.sin(pos / (10000.0 ** (even / d_model)))
    tab[:, odd] = np.cos(pos / (10000.0 ** (odd / d_model)))
    return tab.astype(np.float32)


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and held in f32. A product of two such tensors
    in f32 is JAX's ``preferred_element_type=float32`` product of the
    rounded operands (the products of bf16 values are exact in f32)."""
    return x.to(dtype).float()


class Dense(nn.Linear):
    """flax ``nn.Dense(features, dtype=dtype)``: y = x W + b computed in
    ``dtype`` (input, weight and bias cast), output in ``dtype``. The weight
    is stored (out, in) as in torch; the flax kernel is its transpose."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__(d_in, d_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


# rows of the positional table (the reference's)
MAX_POSITIONS = 3660


class PositionalEncoder(nn.Module):
    """x + sinusoid table (in x's dtype); dropout is off at inference."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        table = torch.from_numpy(sinusoid_table(MAX_POSITIONS, d_model))
        self.register_buffer("table", table.to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.table[: x.shape[1]].to(x.dtype)


class VocabularyEmbedder(nn.Module):
    """Token embedding scaled by sqrt(emb_dim), f32."""

    def __init__(self, voc_size: int, emb_dim: int, device=None):
        super().__init__()
        self.embedding = nn.Embedding(voc_size, emb_dim, device=device)
        self.scale = math.sqrt(emb_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding(tokens) * self.scale


class PositionwiseFeedForward(nn.Module):
    """fc1 -> relu -> fc2 in the compute dtype."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.fc1 = Dense(d_model, d_ff, dtype, device)
        self.fc2 = Dense(d_ff, d_model, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class ResidualConnection(nn.Module):
    """Prenorm residual x + sublayer(LN(x)), split into ``pre`` (f32
    LayerNorm) and ``post`` (the residual add) for the incremental decoder."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(size, eps=1e-5, device=device)

    def pre(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float())

    def post(self, x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
        return x + res


class AReLU(nn.Module):
    """relu(x) * (1 + sigmoid(beta)) - relu(-x) * clip(alpha, .01, .99), f32."""

    def __init__(self, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.90, device=device))
        self.beta = nn.Parameter(torch.full((1,), 2.0, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.clamp(0.01, 0.99)
        b = 1.0 + torch.sigmoid(self.beta)
        x = x.float()
        return torch.relu(x) * b - torch.relu(-x) * a
