"""Peaks of one NVIDIA H100 SXM and the work of the measured operations,
counted from shapes and from the configurations' widths.

Peaks are NVIDIA's data sheet for the SXM part, dense: 3.35 TB/s of HBM3,
989 TFLOP/s in bf16 on the tensor cores. An exact float32 product runs at
most at 495 / 3 TFLOP/s (three TF32 passes on the tensor cores, each f32
operand split in two terms), above the CUDA cores' 67, so a float32
operation's share is taken against 165 TFLOP/s and cannot pass 100% however
the kernel computes. The data sheet's rates assume the card's full power
limit of 700 W; each result prints the card's limit beside its shares.

A kernel's roofline time is the larger of its bytes over the bandwidth and
its operations over the peak of its operands' type. Each input byte is
counted read once and each output byte written once. Model FLOPs count 2
per multiply-add of every product of the plain reference at a request's
own lengths, so padding and repeated work count against ``mfu``.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3}


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """The least time of an operation moving ``nbytes`` and doing ``flops``
    in the operand type ``kind``."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ---- the port's custom ops, from the input shapes the profiler records.
# Each returns the roofline time in seconds of one call.

def folded_attend_s(shapes, mem_bytes: int = 2) -> float:
    """``bmhrl::folded_attend``(q_eff (B, G, draw) f32, mem (B, S, draw),
    mask (B, S) int32, scale): scores and context, 4·B·G·S·draw FLOPs; q
    and the memory read, the mask read, (B, G, draw) f32 written."""
    (B, G, draw), (_, S, _) = shapes[0], shapes[1]
    mask = _numel(shapes[2]) * 4 if shapes[2] else 0
    nbytes = B * G * draw * 4 * 2 + B * S * draw * mem_bytes + mask
    return bound_s(nbytes, 4.0 * B * G * S * draw,
                   "bf16" if mem_bytes == 2 else "f32")


def lstm_cell_s(shapes) -> float:
    """``bmhrl::lstm_cell_packed``(x (B, K), h (B, H), c (B, H), w, b, K, H):
    2·B·(K+H)·4H FLOPs in f32; x, h, c, the packed weights and biases read,
    h and c written."""
    (B, K), (_, H) = shapes[0], shapes[1]
    nbytes = 4 * (B * K + 2 * B * H + _numel(shapes[3]) + _numel(shapes[4])
                  + 2 * B * H)
    return bound_s(nbytes, 2.0 * B * (K + H) * 4 * H, "f32")


def gru_cell_s(shapes) -> float:
    """``bmhrl::gru_cell_packed``(x (B, K), h (B, H), w, b, K, H):
    2·B·(K+H)·3H FLOPs in f32; x, h, weights, biases read, h written."""
    (B, K), (_, H) = shapes[0], shapes[1]
    nbytes = 4 * (B * K + B * H + _numel(shapes[2]) + _numel(shapes[3])
                  + B * H)
    return bound_s(nbytes, 2.0 * B * (K + H) * 3 * H, "f32")


def flash_attention_s(shapes, H: int, elem_bytes: int = 2) -> float:
    """``bmhrl::flash_attention_bsd``(q (B, Sq, H·d), k, v (B, Sk, H·d), mask
    (B, Sk), H, causal), not causal: 4·B·Sq·Sk·H·d FLOPs; q, k, v, mask
    read, (B, Sq, H·d) written."""
    (B, Sq, HD), (_, Sk, _) = shapes[0], shapes[1]
    mask = _numel(shapes[3]) * 4 if len(shapes) > 3 and shapes[3] else 0
    nbytes = elem_bytes * (2 * B * Sq * HD + 2 * B * Sk * HD) + mask
    return bound_s(nbytes, 4.0 * B * Sq * Sk * HD,
                   "bf16" if elem_bytes == 2 else "f32")


# ---- model FLOPs of the references, per request

def _linear(n: int, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def _attention(nq: int, nk: int, dq: int, dk: int, d: int) -> float:
    """Projections of nq queries (width dq) and nk keys/values (width dk)
    to d, scores and context over the full nq x nk, output back to dq."""
    return (_linear(nq, dq, d) + 2 * _linear(nk, dk, d)
            + 4.0 * nq * nk * d + _linear(nq, d, dq))


def bimodal_encoder_flops(n_layers: int, s1: int, s2: int, d1: int, d2: int,
                          d: int, ff1: int, ff2: int) -> float:
    layer = (_attention(s1, s1, d1, d1, d) + _attention(s2, s2, d2, d2, d)
             + _attention(s1, s2, d1, d2, d) + _attention(s2, s1, d2, d1, d)
             + 2 * _linear(s1, d1, ff1) + 2 * _linear(s2, d2, ff2))
    return n_layers * layer


def captioner_flops(cfg: Dict, sv: int, sa: int, n_tok: int) -> float:
    """One request of the captioner (``reference.bmhrl.log_probs`` and its
    critic) with sv video rows, sa audio rows and n_tok caption positions."""
    d, dc, dg = cfg["d_model"], cfg["d_model_caps"], cfg["d_goal"]
    dv, da, voc = cfg["d_vid"], cfg["d_aud"], cfg["voc_size"]
    n, hc = n_tok, 2 * dc
    enc = bimodal_encoder_flops(cfg["att_layers"], sv, sa, dv, da, d,
                                cfg["d_ff_v"], cfg["d_ff_a"])
    critic = (_linear(n, dc, 4 * hc) + 7 * _linear(n, hc, 4 * hc)
              + 4 * _linear(n, hc, 3 * hc) + _linear(n, hc, 1))
    fusion_layer = (_attention(n, n, dc, dc, d) + _attention(n, sa, dc, da, d)
                    + _attention(n, sv, dc, dv, d))
    fusion = 2 * cfg["att_layers"] * fusion_layer
    heads = (_linear(n, dc, dg) + _attention(n, n, dg, dc, d)
             + _linear(n, dc + dg, voc))
    return enc + critic + fusion + heads


def proposal_flops(cfg: Dict, sv: int, sa: int) -> float:
    """One clip of the proposal generator (``reference.proposal``) at sv
    video and sa audio rows."""
    d, da, K = cfg["d_model"], cfg["d_model_aud"], cfg["num_anchors"]
    emb = _linear(sv, cfg["d_vid"], d) + _linear(sa, cfg["d_aud"], da)
    enc = bimodal_encoder_flops(cfg["att_layers"], sv, sa, d, da, d,
                                cfg["d_ff_v"], cfg["d_ff_a"])
    heads = (2 * _linear(sv, 3 * d, d) + _linear(sv, d, 3 * K)
             + 2 * _linear(sa, 3 * da, da) + _linear(sa, da, 3 * K))
    return emb + enc + heads
