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
# the largest dynamic shared memory of one block on Hopper (csrc/common.cuh
# kMaxSmem)
MAX_SMEM = 232448
# streaming multiprocessors of one H100 SXM: folded_split,
# folded_simt_split and flash_simt_warps aim to give each a block
SMS = 132


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel that takes flash attention at (dtype, head width d):
    "tc", the bf16 tensor-core kernel, for bf16 at d in {128, 256} (the
    serving path); "simt", for f32 and for bf16 at d in {384, 512}. Both
    run on the tensor cores: "simt" (the name is the launch counter's) as
    3xTF32, each f32 operand split into two tf32 terms (about 22 bits of
    mantissa, f32 accuracy); a bf16 operand is exact in tf32. Raises
    ValueError for any other pair."""
    if dtype == torch.bfloat16 and d in (128, 256):
        return "tc"
    if dtype in _DTYPE_CODE and d in (128, 256, 384, 512):
        return "simt"
    raise ValueError(f"flash attention takes float32 or bfloat16 at head "
                     f"width 128..512 step 128, got {dtype} at {d}")


# keys per K/V tile of the "simt" flash kernel (csrc/flash_attention.cu BKV)
FLASH_SIMT_KEYS = 16


def flash_simt_smem(dtype: torch.dtype, d: int, warps: int) -> int:
    """Shared-memory bytes of one "simt" flash block of ``warps`` warps
    (csrc/flash_attention.cu simt::smem_bytes): its 16 * warps / wpq query
    rows (wpq = 1 at d <= 256, else 2 warps share 16 queries, each owning
    half of O's columns), two stages of FLASH_SIMT_KEYS K and V rows, rows
    padded by 16 bytes, and two stages of the mask."""
    esz = 4 if dtype == torch.float32 else 2
    wpq = 1 if d <= 256 else 2
    rows = 16 * warps // wpq + 4 * FLASH_SIMT_KEYS
    return esz * (d + 16 // esz) * rows + 4 * 2 * FLASH_SIMT_KEYS


def flash_simt_warps(dtype: torch.dtype, d: int, B: int, H: int,
                     Sq: int) -> int:
    """Warps of one "simt" flash block: 8 (4 at f32 d=512, where 8 do not
    fit ``MAX_SMEM``), and 4 at d <= 256 where 8-warp blocks (128 queries)
    would give under half the SMs a block (B * H * ceil(Sq / 128) <
    SMS / 2). chip_smoke.py's kernels phase times both at the f32
    flagship's encoder sites for B=16 and 32 (``f32_flagship_geometry``):
    4 warps win at B=16's 64-block sites, 8 at every 128-block site."""
    if flash_simt_smem(dtype, d, 8) > MAX_SMEM:
        return 4
    if d <= 256 and B * H * -(-Sq // 128) < SMS // 2:
        return 4
    return 8


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
    if route == "simt":
        # 16-byte copies: a view that does not start every row on 16 bytes
        # is copied once
        epc = 16 // q.element_size()
        q, k, v = (t if t.data_ptr() % 16 == 0 and t.stride(0) % epc == 0
                   and t.stride(1) % epc == 0 else t.contiguous()
                   for t in (q, k, v))
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
    args = (_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, Sq, Sk, H, d, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            1.0 / math.sqrt(d), int(causal))
    if route == "tc":
        err = lib.bmhrl_flash_attention_tc(*args, _cuda.stream_of(q))
    else:
        err = lib.bmhrl_flash_attention_simt(
            *args, flash_simt_warps(q.dtype, d, B, H, Sq),
            _cuda.stream_of(q))
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


def folded_route(dtype: torch.dtype, draw: int) -> str:
    """The CUDA kernel that takes folded attention over a (dtype, draw)
    memory: "tc", the bf16 tensor-core kernel, for bf16 at draw 128..1024
    step 128 (both memories of the serving path); "simt" for f32 and every
    other width. Both run on the tensor cores: "simt" (the name is the
    launch counter's) as 3xTF32, an f32 memory and q and p each split into
    two tf32 terms (f32 accuracy), a bf16 memory exact in tf32, at any
    width (``folded_simt_slabs``). Raises ValueError for another dtype."""
    if dtype == torch.bfloat16 and draw % 128 == 0 and 128 <= draw <= 1024:
        return "tc"
    if dtype in _DTYPE_CODE and draw > 0:
        return "simt"
    raise ValueError(f"folded attention takes a float32 or bfloat16 memory, "
                     f"got {dtype} at width {draw}")


def folded_split(B: int, S: int) -> int:
    """Blocks of the thread-block cluster that share one clip's keys on the
    "tc" route: the fewest of 1, 2, 4, 8 that give every SM a block
    (B * c >= SMS), but never more than half the clip's 16-key
    tiles: a block's fixed costs (its queries, the first load, the cluster
    combine) need two tiles to hide behind. chip_smoke.py timed the B=32
    video call (S 128) at 0.0195 ms over 4 blocks and 0.0284 ms over 8,
    one tile each (H100 80GB HBM3, 700 W)."""
    tiles = -(-S // 16)
    c = 1
    while c < 8 and B * c < SMS and 4 * c <= tiles:
        c *= 2
    return c


def folded_tile(draw: int) -> int:
    """Keys per stage of the "tc" kernel's 3-stage ring: about 32 KB of bf16
    rows, a multiple of 16 (the mma's m) from 16 to 64."""
    return max(16, min(64, 16384 // draw // 16 * 16))


def folded_simt_split(blocks: int, S: int) -> int:
    """Blocks of the thread-block cluster that share one clip's keys on the
    "simt" route, for a grid of ``blocks`` blocks before the split (clips x
    query blocks a clip): the fewest of 1, 2, 4, 8 that give half the SMs
    a block (blocks * c >= SMS / 2), at least one 16-key tile a
    block. At draw 1024 a block holds an SM (251 registers, 144 KB), so a
    second wave costs what a split would save: the f32 beam's video call
    (64 clips x 2 query blocks) runs unsplit, the f32 reference decode's
    calls (8 blocks) over 8 cluster blocks; chip_smoke.py's kernels phase
    times each against the next split (``split2_ms``, ``reference
    V_split4_ms``)."""
    tiles = -(-S // 16)
    c = 1
    while c < 8 and blocks * c < SMS // 2 and 2 * c <= tiles:
        c *= 2
    return c


def folded_simt_slabs(draw: int) -> int:
    """Column slabs of the "simt" folded kernel (csrc/folded_attention.cu
    simt::geometry): 1 up to draw 1664 (13 16-column tiles a warp, the
    widest ring of f32 rows that fits ``MAX_SMEM``), else
    ceil(ceil(draw / 128) / 13) slabs of equal width, each served by blocks
    of its own that stream the other slabs for the scores. Any width runs,
    as in the JAX function's XLA path."""
    tiles = -(-draw // 128)
    return -(-tiles // 13)


def folded_simt_chunk(draw: int) -> int:
    """Queries per block of the "simt" folded kernel
    (csrc/folded_attention.cu simt::geometry). Each of its 8 warps owns
    nm 16-column tiles of its slab of the memory and keeps its q fragments
    and context accumulators for all the block's queries in registers: 16
    queries up to draw 1024 (nm 8; the f32 beam's G = 32 takes two blocks
    a clip), 8 above (nm 9..13, or several slabs). A clip's G queries run
    in ceil(G / chunk) blocks. The C entry point refuses any other value.
    Raises ValueError for draw <= 0."""
    if draw <= 0:
        raise ValueError(f"folded attention needs a memory of positive "
                         f"width, got {draw}")
    return 16 if draw <= 1024 else 8


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

    On the card the route is ``folded_route(mem.dtype, draw)``. Both
    kernels take q_eff (f32, any strides) and the scale as they are and
    scale q in f32 as they load it. The "tc" kernel takes a memory with
    unit stride along draw, 16-byte aligned, batch and row strides
    multiples of 8: one launch, nothing copied. The "simt" kernel (3xTF32
    on the tensor cores) takes any memory with unit stride along draw
    (copying each row as widely as its alignment allows), at any width in
    ``folded_simt_slabs(draw)`` column slabs, serves a clip's queries in
    blocks of ``folded_simt_chunk(draw)``, so any G runs, and splits a
    clip's keys over ``folded_simt_split(B * blocks a clip, S)`` cluster
    blocks (blocks a clip: query blocks times slabs). The call is the op ``bmhrl::folded_attend``.
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
    mask_ptr = None if mask is None else mask.data_ptr()
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
            q_eff.data_ptr(), mem.data_ptr(), mask_ptr, out.data_ptr(), B, G,
            S, draw, split, folded_tile(draw), *q_eff.stride(), mem.stride(0),
            mem.stride(1), scale, _cuda.stream_of(mem))
        _cuda.check(lib, err, f"{what} (tc, B={B}, G={G}, S={S}, "
                              f"draw={draw}, split={split})")
    else:
        q = q_eff.float()
        if mem.stride(2) != 1:
            mem = mem.contiguous()
        chunk = folded_simt_chunk(draw)
        split = folded_simt_split(
            B * -(-G // chunk) * folded_simt_slabs(draw), S)
        err = lib.bmhrl_folded_attend(
            _DTYPE_CODE[mem.dtype], q.data_ptr(), mem.data_ptr(), mask_ptr,
            out.data_ptr(), B, G, S, draw, chunk, split, *q.stride(),
            mem.stride(0), mem.stride(1), scale, _cuda.stream_of(mem))
        _cuda.check(lib, err, f"{what} (simt, B={B}, G={G}, S={S}, "
                              f"draw={draw}, chunk={chunk}, split={split})")
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
    if lib.bmhrl_flash_attention_tc.argtypes is None:
        args = [I, P, P, P, P, P, I, I, I, I, I, I64, I64, I64, I64, I64, I64,
                F, I]
        lib.bmhrl_flash_attention_tc.argtypes = args + [P]
        lib.bmhrl_flash_attention_simt.argtypes = args + [I, P]
        lib.bmhrl_flash_attention_tc.restype = I
        lib.bmhrl_flash_attention_simt.restype = I
    return lib


def _folded_lib():
    lib = _cuda.library("folded_attention")
    P, I, I64, F = _cuda.P, _cuda.I, _cuda.I64, _cuda.F
    if lib.bmhrl_folded_attend.argtypes is None:
        lib.bmhrl_folded_attend.argtypes = [
            I, P, P, P, P, I, I, I, I, I, I, I64, I64, I64, I64, I64, F, P]
        lib.bmhrl_folded_attend.restype = I
        lib.bmhrl_folded_attend_tc.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I64, I64, I64, I64, I64, F, P]
        lib.bmhrl_folded_attend_tc.restype = I
    return lib
