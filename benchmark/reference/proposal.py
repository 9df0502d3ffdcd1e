"""Plain float32 reference of the bimodal event-proposal generator as this
repository rebuilt it (Berghojo/bmhrl trains the generator but does not
ship its class; ``configs/bmt-proposal.json`` lists where the rebuild
departs from BMT's): feature embedders, positional tables, the bimodal
encoder at the full padded clip lengths, and one convolutional anchor head
per modality, mapped to (start, end, confidence) in seconds.

A cell s of a stream with ``orig_len`` valid positions covers ``duration /
orig_len`` seconds; the prediction of anchor k there has centre (s +
sigmoid(o_c)) * duration / orig_len and length anchor_k * exp(o_l), and
cells past ``orig_len`` get confidence 0. Video cells come first.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.layers import (bimodal_encoder, conv_same, exact,
                                        layer_norm, linear, sinusoid_table,
                                        spec_encoder, spec_linear, spec_norm)


def param_spec(cfg: Dict) -> Dict:
    d, da = cfg["d_model"], cfg["d_model_aud"]
    K = cfg["num_anchors"]
    spec: Dict = {}
    spec_linear(spec, "emb_V.embedder", cfg["d_vid"], d)
    spec_linear(spec, "emb_A.embedder", cfg["d_aud"], da)
    spec_encoder(spec, "encoder", cfg["att_layers"], d, da, d,
                 cfg["d_ff_v"], cfg["d_ff_a"])
    for name, w in (("head_V", d), ("head_A", da)):
        for i in range(2):
            spec[f"{name}.conv_{i}.weight"] = ((w, w, 3), "lecun")
            spec[f"{name}.conv_{i}.bias"] = ((w,), "bias")
            spec_norm(spec, f"{name}.norm_{i}", w)
        spec_linear(spec, f"{name}.head", w, 3 * K)
    return spec


def _head(p, name, x, K):
    for i in range(2):
        x = torch.relu(layer_norm(p, f"{name}.norm_{i}",
                                  conv_same(p, f"{name}.conv_{i}", x), 1e-6))
    out = linear(p, f"{name}.head", x)
    return out.reshape(x.shape[0], x.shape[1], K, 3)


def _to_seconds(raw, anchors, duration, orig_len):
    B, S, K, _ = raw.shape
    cells = torch.arange(S, dtype=torch.float32,
                         device=raw.device)[None, :, None]
    sec = (duration / orig_len.clamp_min(1.0))[:, None, None]
    centre = (cells + torch.sigmoid(raw[..., 0])) * sec
    length = anchors[None, None, :] * torch.exp(raw[..., 1])
    conf = torch.where(cells < orig_len[:, None, None],
                       torch.sigmoid(raw[..., 2]), 0.0)
    return torch.stack([centre - length / 2, centre + length / 2, conf],
                       dim=-1).reshape(B, S * K, 3)


@torch.no_grad()
def predictions(p, cfg, V, A, orig_len_v, orig_len_a, duration, anchors,
                rnd=exact) -> torch.Tensor:
    """(B, Sv*K + Sa*K, 3) predictions of clips V (B, Sv, d_vid) = rgb +
    flow and A (B, Sa, d_aud), zero past their ``orig_len`` (B,) rows.
    ``rnd`` rounds the operands of the embedders' and the encoder's
    products (the heads are float32 in the configuration)."""
    dev = V.device
    d, da = cfg["d_model"], cfg["d_model_aud"]
    m_v = (torch.arange(V.shape[1], device=dev)[None]
           < orig_len_v[:, None])[:, None, :]
    m_a = (torch.arange(A.shape[1], device=dev)[None]
           < orig_len_a[:, None])[:, None, :]
    v = (torch.relu(linear(p, "emb_V.embedder", V, rnd) * math.sqrt(d))
         + sinusoid_table(V.shape[1], d, dev))
    a = (torch.relu(linear(p, "emb_A.embedder", A, rnd) * math.sqrt(da))
         + sinusoid_table(A.shape[1], da, dev))
    v, a = bimodal_encoder(p, "encoder", cfg["att_layers"], v, a, m_v, m_a,
                           cfg["att_heads"], rnd)
    K = cfg["num_anchors"]
    lv, la = orig_len_v.float(), orig_len_a.float()
    return torch.cat([
        _to_seconds(_head(p, "head_V", v, K), anchors, duration, lv),
        _to_seconds(_head(p, "head_A", a, K), anchors, duration, la)], dim=1)
