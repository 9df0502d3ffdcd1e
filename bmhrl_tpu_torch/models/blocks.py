"""Transformer building blocks (the port of bmhrl_tpu/models/blocks.py).

Parameters are f32 masters. ``Dense`` keeps flax's ``nn.Dense(dtype=...)``
cast points: input, weight and bias are cast to the compute dtype and the
output stays in it, so bf16 on the card rounds where the TPU rounded.

Training forwards take a ``Draws``: every random draw of a step comes from
it, so two forwards with the draws of one seed are identical and a test can
feed chosen draws. ``draws=None`` is the deterministic forward (no
dropout).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Tuple

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


class Draws:
    """The random draws of one training step, one ``torch.Generator`` per
    stream, seeded from ``seed`` (as the JAX step splits its key): synonym
    noise, dropout keep masks, exploration normals, the RL sample. Two
    ``Draws`` of one seed give the same streams, so a step that re-runs a
    forward repeats its dropout and noise. Generators live on ``device``. A
    test subclasses it to feed chosen draws.

    With a data-parallel ``mesh`` a draw whose leading dim is this rank's
    rows (dropout, synonym noise, the sample) is drawn at the global
    batch's shape and this rank's rows are kept, so every rank holds its
    rows of the one-process draw; the Manager's (d_goal,) normal is the
    same on every rank."""

    STREAMS = ("synonym", "dropout", "noise", "sample")

    def __init__(self, seed: int, device, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        seeds = np.random.SeedSequence(seed).generate_state(len(self.STREAMS))
        self._gens = {name: torch.Generator(self.device).manual_seed(int(s))
                      for name, s in zip(self.STREAMS, seeds)}

    def _draw(self, fn, stream: str, *args) -> torch.Tensor:
        """fn(*args) (torch.rand, randn or randint) from ``stream``."""
        return fn(*args, generator=self._gens[stream], device=self.device)

    def _world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world

    def _global(self, shape) -> Tuple[int, ...]:
        """The global batch's shape of a draw of this rank's rows."""
        shape = tuple(shape)
        return (shape[0] * self._world(),) + shape[1:]

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a draw at the global batch's shape."""
        if self._world() == 1:
            return x
        return x[self.mesh.rows(x.shape[0])]

    def keep(self, shape, keep_prob: float) -> torch.Tensor:
        """Dropout keep mask: True with probability ``keep_prob``."""
        u = self._draw(torch.rand, "dropout", self._global(shape))
        return self._local(u) < keep_prob

    def normal(self, shape) -> torch.Tensor:
        """Standard normals (f32) of the Manager's exploration noise."""
        return self._draw(torch.randn, "noise", shape)

    def synonym(self, shape, voc_size: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(u1, u2, words) of ``synonym_noise``: two uniforms in [0, 1) and
        random words in [2, voc_size)."""
        g = self._global(shape)
        u1 = self._draw(torch.rand, "synonym", g)
        u2 = self._draw(torch.rand, "synonym", g)
        words = self._draw(torch.randint, "synonym", 2, voc_size, g)
        return self._local(u1), self._local(u2), self._local(words)

    def categorical(self, logp: torch.Tensor) -> torch.Tensor:
        """One sample per row of log-probabilities (..., V): Gumbel-max, as
        ``jax.random.categorical``."""
        u = self._local(self._draw(torch.rand, "sample",
                                   self._global(logp.shape)))
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


def dropout(x: torch.Tensor, p: float, draws: Optional[Draws]) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: keep with probability 1 - p and divide by it
    in x's dtype (flax's weakly typed division); identity when ``draws``
    is None or p is 0."""
    if draws is None or p == 0.0:
        return x
    keep = draws.keep(x.shape, 1.0 - p)
    kp = torch.tensor(1.0 - p, dtype=x.dtype).item()  # exact in x's dtype
    return torch.where(keep, x / kp, 0.0)


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


class FeatureEmbedder(nn.Module):
    """flax ``FeatureEmbedder``: ``embedder`` (a ``Dense`` in the compute
    dtype) times sqrt(d_model) in that dtype, then ReLU."""

    def __init__(self, d_in: int, d_model: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.embedder = Dense(d_in, d_model, dtype, device)
        self.scale = math.sqrt(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embedder(x)
        return torch.relu(x * torch.tensor(self.scale, dtype=x.dtype).item())


@contextmanager
def _cudnn_without_tf32():
    """cuDNN with TF32 off for the block, the caller's setting restored
    after (``torch.backends.cudnn.allow_tf32`` is True by default)."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


class _ExactConv1d(torch.autograd.Function):
    """``F.conv1d(x, w, b)`` (stride 1, no padding) whose forward AND
    backward run with cuDNN's TF32 off: autograd runs the backward after
    the forward's scope has closed, so a switch around the forward alone
    would leave the gradients in TF32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _cudnn_without_tf32():
            return F.conv1d(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _cudnn_without_tf32():
            return torch.ops.aten.convolution_backward(
                gy.contiguous(), x, w, [w.shape[0]], [1], [0], [1], False,
                [0], 1, list(ctx.needs_input_grad))


class ConvSame(nn.Conv1d):
    """flax ``nn.Conv(kernel_size=(k,), padding="SAME", dtype=dtype)`` on
    (B, L, C): pads (k-1)//2 before and k//2 after (an even kernel pads one
    more on the right), computes in ``dtype``. The weight is torch's
    (out, in, k); the flax kernel (k, in, out) is its full transpose. An
    f32 convolution runs with cuDNN's TF32 off, forward and backward,
    whatever the caller's setting: flax's f32 ``Conv`` is exact f32.
    ``torch_bias_init``: the JAX module initialises the bias as torch does
    (uniform in ±1/sqrt(fan-in); the DETR's projections), not at zero;
    ``weights.random_module_params(flax_init=True)`` reads it."""

    def __init__(self, d_in: int, d_out: int, k: int, dtype, device=None,
                 torch_bias_init: bool = False):
        super().__init__(d_in, d_out, k, device=device)
        self.compute_dtype = dtype
        self.torch_bias_init = torch_bias_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        dt = self.compute_dtype
        x = F.pad(x.to(dt).transpose(1, 2), ((k - 1) // 2, k // 2))
        w, b = self.weight.to(dt), self.bias.to(dt)
        conv = _ExactConv1d.apply if dt == torch.float32 else F.conv1d
        return conv(x, w, b).transpose(1, 2)


# rows of the positional table (the reference's)
MAX_POSITIONS = 3660


class PositionalEncoder(nn.Module):
    """x + sinusoid table (in x's dtype), then dropout."""

    def __init__(self, d_model: int, dout_p: float = 0.0, device=None):
        super().__init__()
        self.dout_p = dout_p
        table = torch.from_numpy(sinusoid_table(MAX_POSITIONS, d_model))
        self.register_buffer("table", table.to(device), persistent=False)

    def forward(self, x: torch.Tensor,
                draws: Optional[Draws] = None) -> torch.Tensor:
        return dropout(x + self.table[: x.shape[1]].to(x.dtype), self.dout_p,
                       draws)


class VocabularyEmbedder(nn.Module):
    """Token embedding scaled by sqrt(emb_dim), f32."""

    def __init__(self, voc_size: int, emb_dim: int, device=None):
        super().__init__()
        self.embedding = nn.Embedding(voc_size, emb_dim, device=device)
        self.scale = math.sqrt(emb_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding(tokens) * self.scale


class PositionwiseFeedForward(nn.Module):
    """fc1 -> relu -> dropout -> fc2 in the compute dtype."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device=None, dout_p: float = 0.0):
        super().__init__()
        self.dout_p = dout_p
        self.fc1 = Dense(d_model, d_ff, dtype, device)
        self.fc2 = Dense(d_ff, d_model, dtype, device)

    def forward(self, x: torch.Tensor,
                draws: Optional[Draws] = None) -> torch.Tensor:
        return self.fc2(dropout(torch.relu(self.fc1(x)), self.dout_p, draws))


class ResidualConnection(nn.Module):
    """Prenorm residual x + dropout(sublayer(LN(x))), split into ``pre``
    (f32 LayerNorm) and ``post`` (dropout and the residual add)."""

    def __init__(self, size: int, device=None, dout_p: float = 0.0):
        super().__init__()
        self.dout_p = dout_p
        self.norm = nn.LayerNorm(size, eps=1e-5, device=device)

    def pre(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float())

    def post(self, x: torch.Tensor, res: torch.Tensor,
             draws: Optional[Draws] = None) -> torch.Tensor:
        return x + dropout(res, self.dout_p, draws)


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
