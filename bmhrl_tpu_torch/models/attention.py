"""Cross-dimensional multi-headed attention (the port of
bmhrl_tpu/models/attention.py: the full forward and the decode steps).

Scores, softmax and accumulation are f32; products take operands rounded to
the compute dtype (``blocks.rounded``), as the JAX package's bf16 einsums
with f32 accumulation do. Masked scores get -1e9, so a fully-masked row
averages its values instead of producing NaN.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from bmhrl_tpu_torch.models.blocks import Dense, Draws, dropout, rounded
from bmhrl_tpu_torch.ops import attention as fused

NEG_INF = -1e9


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         causal: bool = False) -> torch.Tensor:
    """q, k, v: (B, H, S, d_k) in the compute dtype; mask broadcastable to
    (B, 1, 1|Sq, Sk); ``causal`` adds the lower-triangular mask. Returns
    f32 (B, H, Sq, d_k)."""
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        Sq, Sk = scores.shape[-2:]
        tri = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~tri, NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype).float() @ v.float()


class FoldedWeights(NamedTuple):
    """Loop-invariant folded projections, rounded to the compute dtype where
    the JAX package casts them: w_qk (H, Dq, Draw), b_qk (H, Draw) f32,
    w_vo (H, Draw, Dout), b_vo (Dout,) f32."""

    w_qk: torch.Tensor
    b_qk: torch.Tensor
    w_vo: torch.Tensor
    b_vo: torch.Tensor


class MultiheadedAttention(nn.Module):
    def __init__(self, d_model_Q: int, d_model_K: int, d_model_V: int, H: int,
                 d_model: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 device=None, dout_p: float = 0.0):
        super().__init__()
        d = d_model if d_model is not None else d_model_Q
        assert d % H == 0
        self.H, self.d, self.d_k = H, d, d // H
        self.dtype = dtype
        self.use_flash = use_flash
        self.dout_p = dout_p
        self.linear_Q2d = Dense(d_model_Q, d, dtype, device)
        self.linear_K2d = Dense(d_model_K, d, dtype, device)
        self.linear_V2d = Dense(d_model_V, d, dtype, device)
        self.linear_d2Q = Dense(d, d_model_Q, dtype, device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        return x.reshape(B, S, self.H, self.d_k).transpose(1, 2)

    def merged_qkv_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W, b) of the Q/K/V projections stacked on the output axis: one
        matmul gives all three un-headed projections (exact)."""
        lins = (self.linear_Q2d, self.linear_K2d, self.linear_V2d)
        return (torch.cat([l.weight for l in lins]),
                torch.cat([l.bias for l in lins]))

    def _project_qkv(self, Q, K, V):
        """Un-headed (B, S, d) projections in the compute dtype, merged into
        one matmul when the inputs alias (self attention) and into one K/V
        matmul when key and value alias (cross attention)."""
        dt = self.dtype
        if K is not V:
            return self.linear_Q2d(Q), self.linear_K2d(K), self.linear_V2d(V)
        if Q is K:
            w, b = self.merged_qkv_params()
            qkv = torch.nn.functional.linear(Q.to(dt), w.to(dt), b.to(dt))
            return qkv.split(self.d, dim=-1)
        return (self.linear_Q2d(Q), *self.project_kv(K, V))

    def project_kv(self, K: torch.Tensor, V: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Un-headed key/value projections (B, Sk, d) in the compute dtype,
        one merged matmul when key and value alias. ``forward`` takes them
        as ``precomputed_kv``, so a decode projects its static memories
        once per clip."""
        if K is not V:
            return self.linear_K2d(K), self.linear_V2d(V)
        dt = self.dtype
        w = torch.cat([self.linear_K2d.weight, self.linear_V2d.weight])
        b = torch.cat([self.linear_K2d.bias, self.linear_V2d.bias])
        kv = torch.nn.functional.linear(K.to(dt), w.to(dt), b.to(dt))
        return tuple(kv.split(self.d, dim=-1))

    def forward(self, Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                mask: Optional[torch.Tensor],
                draws: Optional[Draws] = None,
                precomputed_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                causal: bool = False) -> torch.Tensor:
        """Attention with a (B, 1, Sk) key pad mask, a (B, Sq, Sk) mask (the
        caption mask) or None, and with ``causal`` the lower-triangular
        mask too, then dropout on the attention output (``draws``; None:
        none). The JAX package's gate: non-causal sites with a key pad mask
        (or none) that pass ``flash_qualifies`` run ``flash_attention_bsd``
        on the un-headed projections. ``precomputed_kv``:
        ``project_kv(K, V)``, which then replaces the key/value projections
        of K and V."""
        B, Sq, _ = Q.shape
        if precomputed_kv is None:
            q3, k3, v3 = self._project_qkv(Q, K, V)
        else:
            q3 = self.linear_Q2d(Q)
            k3, v3 = precomputed_kv
        key_pad = mask is None or mask.shape[1] == 1
        if (key_pad and not causal and self.use_flash
                and fused.flash_qualifies(k3.shape[1], self.d_k)):
            key_mask = None if mask is None else mask[:, 0, :]
            out = fused.flash_attention_bsd(q3, k3, v3, key_mask, self.H)
            out = dropout(out.to(self.dtype), self.dout_p, draws)
            return self.linear_d2Q(out)
        m4 = None if mask is None else mask[:, None, :, :]
        out = scaled_dot_attention(self._heads(q3), self._heads(k3),
                                   self._heads(v3), m4, causal)
        out = dropout(out, self.dout_p, draws)
        return self.linear_d2Q(out.transpose(1, 2).reshape(B, Sq, self.d))

    def attend_step_shared(self, h: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, t: torch.Tensor,
                           key_mask: Optional[torch.Tensor],
                           qkv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
        """Single-position causal self-attention with a KV cache; query, key
        and value all come from ``h`` (B, 1, Dq), projected by the merged
        ``qkv`` = (W, b) in the compute dtype. The caches (B, H, L, d_k) hold
        the compute-dtype keys/values in f32 and are written IN PLACE at
        position t, a 0-d int64 tensor on the caches' device. ``key_mask``
        (B, L): validity of cached positions."""
        dt = self.dtype
        out = torch.nn.functional.linear(h.to(dt), qkv[0], qkv[1])
        q, k_t, v_t = (self._heads(y) for y in out.split(self.d, dim=-1))
        pos = t.reshape(1)
        k_cache.index_copy_(2, pos, k_t.float())
        v_cache.index_copy_(2, pos, v_t.float())
        return self._cached_attend(q, k_cache, v_cache, t, key_mask)

    def attend_step_qkv(self, q_in: torch.Tensor, k_in: torch.Tensor,
                        v_in: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, t: torch.Tensor,
                        key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Single-position causal attention with a KV cache where query, key
        and value come from different inputs (B, 1, D): the DETR decoder
        projects Q and K from the position-encoded stream and V from the raw
        one. Writes the projected key/value of position t (a 0-d int64
        tensor) into the caches (B, H, L, d_k) IN PLACE (f32 storage of
        compute-dtype values) and attends keys <= t that ``key_mask`` (B,
        L) allows."""
        q = self._heads(self.linear_Q2d(q_in))
        pos = t.reshape(1)
        k_cache.index_copy_(2, pos, self._heads(self.linear_K2d(k_in)).float())
        v_cache.index_copy_(2, pos, self._heads(self.linear_V2d(v_in)).float())
        return self._cached_attend(q, k_cache, v_cache, t, key_mask)

    def _cached_attend(self, q, k_cache, v_cache, t: torch.Tensor, key_mask):
        """The headed query (B, H, 1, d_k) against cache positions <= t (and
        ``key_mask``), then the output projection."""
        scores = (q.float() @ k_cache.transpose(-1, -2)) / math.sqrt(self.d_k)
        L = k_cache.shape[2]
        ok = (torch.arange(L, device=q.device) <= t)[None, :]
        if key_mask is not None:
            ok = ok & key_mask
        scores = scores.masked_fill(~ok[:, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx = rounded(probs, self.dtype) @ v_cache
        B = q.shape[0]
        return self.linear_d2Q(ctx.transpose(1, 2).reshape(B, 1, self.d))

    def folded_weights(self) -> FoldedWeights:
        """Fold the K/V projections into the query/output side:
        scores^h = q (W_Q^h W_K^hT) Mᵀ + b_q^h W_K^hT Mᵀ + const(key), and
        out = Σ_h softmax^h M (W_V^h W_O^h) + (b_v W_O + b_o), so attention
        runs against the RAW memory M. Computed in f32, then the matrices
        are rounded to the compute dtype (where the JAX package casts)."""
        H, dk = self.H, self.d_k
        wq = self.linear_Q2d.weight.t().reshape(-1, H, dk)
        wk = self.linear_K2d.weight.t().reshape(-1, H, dk)
        wv = self.linear_V2d.weight.t().reshape(-1, H, dk)
        wo = self.linear_d2Q.weight.t().reshape(H, dk, -1)
        bq = self.linear_Q2d.bias.reshape(H, dk)
        bv = self.linear_V2d.bias.reshape(H, dk)
        dt = self.dtype
        return FoldedWeights(
            w_qk=rounded(torch.einsum("qhd,khd->hqk", wq, wk), dt),
            b_qk=torch.einsum("hd,khd->hk", bq, wk),
            w_vo=rounded(torch.einsum("khd,hdo->hko", wv, wo), dt),
            b_vo=torch.einsum("hd,hdo->o", bv, wo) + self.linear_d2Q.bias)

    def folded_q(self, q_in: torch.Tensor, fw: FoldedWeights) -> torch.Tensor:
        """Effective queries (B, 1|., Dq) -> (B, H, Draw) f32."""
        q = rounded(q_in.reshape(q_in.shape[0], -1), self.dtype)
        return torch.einsum("bq,hqk->bhk", q, fw.w_qk) + fw.b_qk

    def folded_out(self, ctx: torch.Tensor, fw: FoldedWeights) -> torch.Tensor:
        """Folded value+output projection: ctx (B, H, Draw) -> (B, Dout) f32."""
        return (torch.einsum("bhk,hko->bo", rounded(ctx, self.dtype), fw.w_vo)
                + fw.b_vo)
