"""Attention kernels: flash attention on un-headed projections (encoder
and the fusion layers' cross-attention) and folded attention against raw
memories (decode).

Each kernel entry point is a ``torch.library`` custom op of the ``bmhrl``
namespace (``bmhrl::flash_attention_bsd``, ``bmhrl::folded_attend``), so an
exported program (``serve_export``) carries the call: for tensors on the
CPU the op runs the plain PyTorch version beside it (``*_plain``), for
CUDA tensors it launches the hand-written kernel of ``csrc/`` on the
current stream or raises; its fake gives the output's shape, dtype and
device. The public functions are wrappers over the ops. The plain versions
repeat the kernels' arithmetic, so the CPU tests hold them against the JAX
package and ``chip_smoke.py`` holds the kernels against them on the card.

Flash attention is differentiable through one ``torch.autograd.Function``
on both devices: its forward is the op, its backward the JAX package's
recompute (``_flash_bsd_bwd``, XLA there, plain PyTorch here), which
launches no kernel of ``csrc/``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bmhrl_tpu_torch.ops import _cuda

NEG_INF = -1e9
# shortest key range that takes the flash kernel; shorter sites run the
# plain headed path in the model (as in the JAX package)
MIN_SK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that takes flash attention at (dtype, head width d):
    "tc", the tensor-core kernel, for bf16 at d in {128, 256} (the serving
    path); "simt", the CUDA-core kernel, for f32 and for bf16 at d in
    {384, 512}. Raises ValueError for any other pair."""
    if dtype == torch.bfloat16 and d in (128, 256):
        return "tc"
    if dtype in _DTYPE_CODE and d in (128, 256, 384, 512):
        return "simt"
    raise ValueError(f"flash attention takes float32 or bfloat16 at head "
                     f"width 128..512 step 128, got {dtype} at {d}")


def flash_qualifies(Sk: int, d_k: int) -> bool:
    """The JAX package's flash gate: long enough keys, head width a multiple
    of 128 up to 512 (the head widths the kernel is built for)."""
    return Sk >= MIN_SK and d_k % 128 == 0 and d_k <= 512


def flash_attention_bsd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: Optional[torch.Tensor],
                              H: int, causal: bool = False) -> torch.Tensor:
    """Plain version of ``flash_attention_bsd``: one-pass softmax in f32,
    p rounded to the input type before PV, normalised after PV."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    d = HD // H

    def heads(x):
        return x.reshape(B, x.shape[1], H, d).transpose(1, 2).float()

    s = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(d))
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, None, :], NEG_INF)
    if causal:
        tri = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = p.to(q.dtype).float() @ heads(v)
    o = o / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(B, Sq, HD).to(q.dtype)


def flash_attention_bsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], H: int,
                        causal: bool = False) -> torch.Tensor:
    """Fused attention on UN-headed (B, S, H*d) projections with a (B, Sk) key
    mask (nonzero = attend). Returns (B, Sq, H*d) in q's dtype. A
    fully-masked row gives mean(V) over the Sk actual keys.

    The inputs may be views with any batch and row strides (the model passes
    column slices of one merged QKV projection) but unit stride along the
    last axis. Under autograd (grad on and an input that requires grad)
    the call goes through ``FlashAttentionBSD``; otherwise it is the op
    ``bmhrl::flash_attention_bsd`` alone, which is what an exported
    program holds."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionBSD.apply(q, k, v, mask, H, causal)
    return torch.ops.bmhrl.flash_attention_bsd(q, k, v, mask, H, causal)


def _flash_attention_bsd_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: Optional[torch.Tensor],
                            H: int, causal: bool) -> torch.Tensor:
    """``bmhrl::flash_attention_bsd``: the plain version for CPU tensors,
    else one launch of the route's kernel on the current stream."""
    if q.device.type == "cpu":
        return flash_attention_bsd_plain(q, k, v, mask, H, causal)
    what = "flash_attention_bsd"
    _cuda.require_cuda(what, q, k, v)
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, HD) or v.shape != (B, Sk, HD):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if k.dtype != q.dtype or v.dtype != q.dtype or HD % H:
        raise ValueError(f"{what}: q/k/v types {q.dtype}, {k.dtype}, "
                         f"{v.dtype} or width {HD} over {H} heads")
    d = HD // H
    route = flash_route(q.dtype, d)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the last axis must have unit stride")
    if route == "tc" and any(t.data_ptr() % 16 or t.stride(0) % 8
                             or t.stride(1) % 8 for t in (q, k, v)):
        raise ValueError(f"{what}: the tensor-core kernel copies 16-byte "
                         "rows: q/k/v must be 16-byte aligned with batch "
                         "and row strides that are multiples of 8")
    if mask is None:
        mask = torch.ones(B, Sk, dtype=torch.int32, device=q.device)
    else:
        if mask.shape != (B, Sk):
            raise ValueError(f"{what}: mask {tuple(mask.shape)} != "
                             f"{(B, Sk)}")
        _cuda.require_cuda(what, q, mask)
        mask = mask.to(torch.int32).contiguous()
    out = torch.empty(B, Sq, HD, dtype=q.dtype, device=q.device)
    lib = _flash_lib()
    fn = (lib.bmhrl_flash_attention_tc if route == "tc"
          else lib.bmhrl_flash_attention_simt)
    err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             mask.data_ptr(), out.data_ptr(), B, Sq, Sk, H, d, q.stride(0),
             q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             1.0 / math.sqrt(d), int(causal), _cuda.stream_of(q))
    _cuda.check(lib, err, f"{what} ({route}, B={B}, Sq={Sq}, Sk={Sk}, d={d})")
    _cuda.LAUNCHES[f"flash_attention_{route}"] += 1
    return out


_cuda.register_op(
    "flash_attention_bsd", _flash_attention_bsd_op,
    "(Tensor q, Tensor k, Tensor v, Tensor? mask, int H, bool causal) -> "
    "Tensor",
    lambda q, k, v, mask, H, causal: q.new_empty(q.shape))


def flash_attention_bsd_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: Optional[torch.Tensor],
                            g: torch.Tensor, H: int, causal: bool = False):
    """Gradients (dq, dk, dv) of ``flash_attention_bsd`` for the output
    cotangent g: the JAX package's recompute (``_flash_bsd_bwd``) step by
    step. Probabilities in f32 from the input-type q and k (the forward's
    -1e9 fill, so a fully-masked row has uniform p, as in the forward);
    p, g and ds enter their products rounded to the input type, sums in
    f32; ds = p (dp - sum(dp p)); the scale applied to dq and dk. Plain
    PyTorch on both devices."""
    dt = q.dtype
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    d = HD // H

    def heads(x):  # values of the input type, held in f32
        return x.to(dt).reshape(B, x.shape[1], H, d).transpose(1, 2).float()

    def unheads(x):
        return x.transpose(1, 2).reshape(B, x.shape[2], HD).to(dt)

    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        tri = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = p.to(dt).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsm = ds.to(dt).float()
    scale = 1.0 / math.sqrt(d)
    dq = (dsm @ kh) * scale
    dk = (dsm.transpose(-1, -2) @ qh) * scale
    return unheads(dq), unheads(dk), unheads(dv)


class FlashAttentionBSD(torch.autograd.Function):
    """``flash_attention_bsd`` under autograd. Forward: the op
    ``bmhrl::flash_attention_bsd`` (the plain version for CPU tensors, else
    one launch of the route's kernel). Backward:
    ``flash_attention_bsd_bwd``, which launches no kernel. The gradients of
    q, k and v are returned whole; where they are column views of one merged
    projection, autograd sums them into its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, H, causal):
        ctx.H, ctx.causal = H, causal
        ctx.save_for_backward(q, k, v, mask)
        return torch.ops.bmhrl.flash_attention_bsd(q, k, v, mask, H, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bsd_bwd(q, k, v, mask, g, ctx.H,
                                             ctx.causal)
        return dq, dk, dv, None, None, None


# streaming multiprocessors of one H100 SXM: folded_split aims to give each
# at least one block
FOLDED_SMS = 132


def folded_route(dtype: torch.dtype, draw: int) -> str:
    """The CUDA kernel that takes folded attention over a (dtype, draw)
    memory: "tc", the tensor-core kernel, for bf16 at draw 128..1024 step
    128 (both memories of the serving path); "simt", the CUDA-core kernel,
    for f32 and every other width. Raises ValueError for another dtype."""
    if dtype == torch.bfloat16 and draw % 128 == 0 and 128 <= draw <= 1024:
        return "tc"
    if dtype in _DTYPE_CODE and draw > 0:
        return "simt"
    raise ValueError(f"folded attention takes a float32 or bfloat16 memory, "
                     f"got {dtype} at width {draw}")


def folded_split(B: int, S: int) -> int:
    """Blocks of the thread-block cluster that share one clip's keys on the
    "tc" route: the fewest of 1, 2, 4, 8 that give every SM a block
    (B * c >= FOLDED_SMS), but never more than half the clip's 16-key
    tiles: a block's fixed costs (its queries, the first load, the cluster
    combine) need two tiles to hide behind. chip_smoke.py timed the B=32
    video call (S 128) at 0.0195 ms over 4 blocks and 0.0284 ms over 8,
    one tile each (H100 80GB HBM3, 700 W)."""
    tiles = -(-S // 16)
    c = 1
    while c < 8 and B * c < FOLDED_SMS and 4 * c <= tiles:
        c *= 2
    return c


def folded_tile(draw: int) -> int:
    """Keys per stage of the "tc" kernel's 3-stage ring: about 32 KB of bf16
    rows, a multiple of 16 (the mma's m) from 16 to 64."""
    return max(16, min(64, 16384 // draw // 16 * 16))


# the largest dynamic shared memory of one block on Hopper (csrc/common.cuh
# kMaxSmem)
MAX_SMEM = 232448


def folded_simt_smem(G: int, draw: int) -> int:
    """Shared-memory bytes of one "simt" block serving G queries at the
    memory width ``draw`` (csrc/folded_attention.cu smem_bytes): the
    queries and accumulators, a tile of BS f32 key rows (BS = 16384 // draw
    clamped to 1..64), its scores, the softmax state and the tile's mask."""
    bs = max(1, min(64, 16384 // draw))
    return 4 * (2 * G * draw + bs * draw + G * bs + 3 * G) + 4 * bs


def folded_simt_chunk(draw: int) -> int:
    """Queries per block of the "simt" kernel: the largest of 64, 32, ...,
    1 whose block fits ``MAX_SMEM`` (16 at draw 1024, 64 at draw 128); a
    clip's G queries run in ceil(G / chunk) blocks. The C entry point
    refuses any other value. Raises ValueError where not even one query
    fits."""
    for gc in (64, 32, 16, 8, 4, 2, 1):
        if folded_simt_smem(gc, draw) <= MAX_SMEM:
            return gc
    raise ValueError(f"folded attention's simt kernel cannot hold a memory "
                     f"of width {draw}")


def folded_attend_plain(q_eff: torch.Tensor, mem: torch.Tensor,
                        mask: Optional[torch.Tensor],
                        scale: float) -> torch.Tensor:
    """Plain version of ``folded_attend``: f32 throughout, q pre-scaled,
    normalised after the context product."""
    q = q_eff.float() * scale
    m = mem.float()
    s = q @ m.transpose(1, 2)
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p @ m) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def folded_attend(q_eff: torch.Tensor, mem: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Decode-side folded attention: q_eff (B, G, draw) effective queries
    (K-projection folded in), mem (B, S, draw) raw memory, mask (B, S)
    (nonzero = attend) or None. Returns softmax(scale q memᵀ) mem as
    (B, G, draw) f32; a fully-masked row gives mean(mem) over its own S
    keys.

    On the card the route is ``folded_route(mem.dtype, draw)``. The "tc"
    kernel takes q_eff (f32, any strides) and the scale as they are, a
    memory with unit stride along draw, 16-byte aligned, batch and row
    strides multiples of 8, and an int32 mask: one launch, nothing copied.
    The "simt" kernel serves a clip's queries in blocks of
    ``folded_simt_chunk(draw)``, so any G fits its shared memory. The
    call is the op ``bmhrl::folded_attend``.
    """
    return torch.ops.bmhrl.folded_attend(q_eff, mem, mask, scale)


def _folded_attend_op(q_eff: torch.Tensor, mem: torch.Tensor,
                      mask: Optional[torch.Tensor],
                      scale: float) -> torch.Tensor:
    """``bmhrl::folded_attend``: the plain version for CPU tensors, else one
    launch of the route's kernel on the current stream."""
    if q_eff.device.type == "cpu":
        return folded_attend_plain(q_eff, mem, mask, scale)
    what = "folded_attend"
    _cuda.require_cuda(what, q_eff, mem)
    B, G, draw = q_eff.shape
    S = mem.shape[1]
    if mem.shape != (B, S, draw):
        raise ValueError(f"{what}: mem {tuple(mem.shape)} does not match "
                         f"q_eff {tuple(q_eff.shape)}")
    route = folded_route(mem.dtype, draw)
    if mask is not None:
        if mask.shape != (B, S):
            raise ValueError(f"{what}: mask {tuple(mask.shape)} != {(B, S)}")
        _cuda.require_cuda(what, mem, mask)
        mask = mask.to(torch.int32).contiguous()
    out = torch.empty(B, G, draw, dtype=torch.float32, device=mem.device)
    lib = _folded_lib()
    if route == "tc":
        if q_eff.dtype != torch.float32:
            raise ValueError(f"{what}: the tensor-core kernel takes float32 "
                             f"queries, got {q_eff.dtype}")
        if (mem.stride(2) != 1 or mem.data_ptr() % 16 or mem.stride(0) % 8
                or mem.stride(1) % 8):
            raise ValueError(f"{what}: the tensor-core kernel copies 16-byte "
                             "rows: mem must be 16-byte aligned with unit "
                             "stride along draw and batch and row strides "
                             "that are multiples of 8")
        split = folded_split(B, S)
        err = lib.bmhrl_folded_attend_tc(
            q_eff.data_ptr(), mem.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), B, G,
            S, draw, split, folded_tile(draw), *q_eff.stride(), mem.stride(0),
            mem.stride(1), scale, _cuda.stream_of(mem))
        _cuda.check(lib, err, f"{what} (tc, B={B}, G={G}, S={S}, "
                              f"draw={draw}, split={split})")
    else:
        if mask is None:
            mask = torch.ones(B, S, dtype=torch.int32, device=mem.device)
        q = (q_eff.float() * scale).contiguous()
        mem = mem.contiguous()
        chunk = folded_simt_chunk(draw)
        err = lib.bmhrl_folded_attend(
            _DTYPE_CODE[mem.dtype], q.data_ptr(), mem.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, G, S, draw, chunk,
            _cuda.stream_of(mem))
        _cuda.check(lib, err, f"{what} (simt, B={B}, G={G}, S={S}, "
                              f"draw={draw}, chunk={chunk})")
    _cuda.LAUNCHES[f"folded_attend_{route}"] += 1
    return out


_cuda.register_op(
    "folded_attend", _folded_attend_op,
    "(Tensor q_eff, Tensor mem, Tensor? mask, float scale) -> Tensor",
    lambda q_eff, mem, mask, scale: q_eff.new_empty(q_eff.shape,
                                                    dtype=torch.float32))


def _flash_lib():
    lib = _cuda.library("flash_attention")
    P, I, I64, F = _cuda.P, _cuda.I, _cuda.I64, _cuda.F
    for fn in (lib.bmhrl_flash_attention_tc, lib.bmhrl_flash_attention_simt):
        if fn.argtypes is None:
            fn.argtypes = [I, P, P, P, P, P, I, I, I, I, I,
                           I64, I64, I64, I64, I64, I64, F, I, P]
            fn.restype = I
    return lib


def _folded_lib():
    lib = _cuda.library("folded_attention")
    P, I, I64, F = _cuda.P, _cuda.I, _cuda.I64, _cuda.F
    if lib.bmhrl_folded_attend.argtypes is None:
        lib.bmhrl_folded_attend.argtypes = [I, P, P, P, P, I, I, I, I, I, P]
        lib.bmhrl_folded_attend.restype = I
        lib.bmhrl_folded_attend_tc.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I64, I64, I64, I64, I64, F, P]
        lib.bmhrl_folded_attend_tc.restype = I
    return lib
