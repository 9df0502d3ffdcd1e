"""The rules and the numerical premise of the tensor-core folded-attention
kernel (``csrc/folded_attention.cu``, ``folded_tc_kernel``), on the CPU.

The kernel cannot run here, so its arithmetic is emulated in torch: q and p
enter the bf16 tensor-core products as two bf16 terms (hi = bf16(x), lo =
bf16(x - hi)) against the exact bf16 memory with f32 accumulation, the
online softmax runs in f32 over ring tiles of ``folded_tile(draw)`` keys,
and a clip's keys are split over ``c`` cluster blocks whose partial
(m, l, acc) are combined at the end. Held against ``folded_attend_plain``
(which the CPU tests hold against the JAX package) within 1e-5: the two-term
split keeps about 16 bits of mantissa, the split combine is exact in real
arithmetic, so only f32 rounding in another order remains.
"""
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch.ops import attention as att

TOL = 1e-5


def _two_terms(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_tc(q_eff, mem, mask, scale, c, tile):
    """folded_tc_kernel's arithmetic: block r of the cluster takes keys
    [r*per, (r+1)*per) with per = ceil(ceil(S/16)/c)*16, in ring tiles of
    ``tile`` keys; the partials meet as in the kernel's combine."""
    q = q_eff.float() * scale
    qh, ql = _two_terms(q)
    m = mem.float()
    B, G, draw = q.shape
    S = m.shape[1]
    per = -(-(-(-S // 16)) // c) * 16
    parts = []
    for r in range(c):
        k_begin = min(S, r * per)
        k_end = min(S, k_begin + per)
        m_run = torch.full((B, G), -torch.inf)
        l_run = torch.zeros(B, G)
        acc = torch.zeros(B, G, draw)
        for k0 in range(k_begin, k_end, tile):
            mt = m[:, k0:min(k0 + tile, k_end)]
            s = qh @ mt.transpose(1, 2) + ql @ mt.transpose(1, 2)
            if mask is not None:
                keep = mask[:, None, k0:k0 + mt.shape[1]] > 0
                s = s.masked_fill(~keep, att.NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            corr = torch.where(m_run == -torch.inf, torch.zeros(()),
                               torch.exp(m_run - m_new))
            p = torch.exp(s - m_new[..., None])
            ph, pl = _two_terms(p)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + ph @ mt + pl @ mt
            m_run = m_new
        parts.append((m_run, l_run, acc))
    M = torch.stack([p[0] for p in parts]).amax(0)
    L = torch.zeros(B, G)
    out = torch.zeros(B, G, draw)
    for m_r, l_r, a_r in parts:
        w = torch.where(m_r == -torch.inf, torch.zeros(()), torch.exp(m_r - M))
        L = L + w * l_r
        out = out + w[..., None] * a_r
    return out / L.clamp_min(1e-30)[..., None]


def _inputs(seed, B, G, S, draw, masked_row=1, with_mask=True):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(B, G, draw) * 0.3).astype(np.float32))
    mem = torch.from_numpy(rng.randn(B, S, draw).astype(np.float32)).to(
        torch.bfloat16)
    if not with_mask:
        return q, mem, None
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, : rng.randint(1, S + 1)] = 1
    if masked_row is not None:
        mask[masked_row] = 0
    return q, mem, torch.from_numpy(mask)


@pytest.mark.parametrize("c", [1, 2, 8])
@pytest.mark.parametrize("S,draw", [(128, 1024), (256, 128)])
def test_tc_arithmetic_matches_plain(S, draw, c):
    """The serving memories (video 128 x 1024, audio 256 x 128) at splits
    1 (B=256), 2 and 8 (B=32, audio); row 1 fully masked."""
    q, mem, mask = _inputs(S + draw + c, 3, 8, S, draw)
    scale = 1.0 / np.sqrt(256.0)
    got = _emulate_tc(q, mem, mask, scale, c, att.folded_tile(draw))
    want = att.folded_attend_plain(q, mem, mask, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    torch.testing.assert_close(
        got[1], mem[1].float().mean(0).expand(8, -1), rtol=0, atol=TOL)


@pytest.mark.parametrize("B,G,S,draw,c,with_mask", [
    (1, 8, 1, 1024, 1, True),     # one key
    (1, 4, 20, 128, 2, True),     # the second block has 4 keys
    (2, 8, 129, 384, 8, True),    # three blocks have no keys
    (2, 32, 300, 1024, 8, False),  # no mask, G = 32 (four query chunks)
    (4, 8, 80, 256, 4, True),     # one block has no keys
    (2, 8, 260, 128, 8, True),    # the split folded_split gives: 2 empty
])
def test_tc_arithmetic_matches_plain_at_the_edges(B, G, S, draw, c,
                                                  with_mask):
    q, mem, mask = _inputs(S * G + B, B, G, S, draw,
                           masked_row=B - 1, with_mask=with_mask)
    scale = 0.0625
    got = _emulate_tc(q, mem, mask, scale, c, att.folded_tile(draw))
    torch.testing.assert_close(got, att.folded_attend_plain(q, mem, mask,
                                                            scale),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype,draw,route", [
    (torch.bfloat16, 1024, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 384, "tc"), (torch.bfloat16, 1152, "simt"),
    (torch.bfloat16, 300, "simt"), (torch.bfloat16, 64, "simt"),
    (torch.float32, 1024, "simt"), (torch.float32, 128, "simt"),
])
def test_folded_route(dtype, draw, route):
    assert att.folded_route(dtype, draw) == route


def test_folded_route_refuses_other_types():
    with pytest.raises(ValueError):
        att.folded_route(torch.float16, 128)


@pytest.mark.parametrize("B,S,c", [
    (32, 128, 4), (32, 256, 8), (256, 128, 1), (256, 256, 1), (64, 128, 4),
    (128, 256, 2), (1, 1, 1), (1, 20, 1), (2, 129, 4), (4, 80, 2),
    (2, 260, 8), (1024, 800, 1), (32, 300, 8), (32, 800, 8),
])
def test_folded_split(B, S, c):
    assert att.folded_split(B, S) == c


def test_folded_split_bounds():
    """A power of two, at most 8, and at most the clip's 16-key tiles (half
    of them, or 1); the fewest that give every SM a block where those
    bounds allow."""
    for B in range(1, 300):
        for S in (1, 15, 16, 17, 33, 64, 100, 128, 129, 256, 300, 800):
            c = att.folded_split(B, S)
            tiles = -(-S // 16)
            assert c in (1, 2, 4, 8) and c <= tiles, (B, S, c)
            assert c == 1 or 2 * c <= tiles, (B, S, c)
            assert (B * c >= att.SMS or c == 8
                    or 4 * c > tiles), (B, S, c)
            assert c == 1 or B * (c // 2) < att.SMS, (B, S, c)


@pytest.mark.parametrize("blocks,S,c", [
    (128, 128, 1), (256, 256, 1), (66, 128, 1), (65, 128, 2), (8, 128, 8),
    (8, 160, 8), (8, 20, 2), (8, 1, 1), (32, 128, 4), (3, 129, 8),
    (16, 48, 2),
])
def test_folded_simt_split(blocks, S, c):
    assert att.folded_simt_split(blocks, S) == c


def test_folded_simt_split_bounds():
    """A power of two, at most 8, with at least one 16-key tile a block;
    the fewest that give half the SMs a block where those bounds allow."""
    for blocks in range(1, 300):
        for S in (1, 15, 16, 17, 33, 64, 100, 128, 129, 160, 256, 800):
            c = att.folded_simt_split(blocks, S)
            tiles = -(-S // 16)
            assert c in (1, 2, 4, 8) and c <= tiles, (blocks, S, c)
            assert (blocks * c >= att.SMS // 2 or c == 8
                    or 2 * c > tiles), (blocks, S, c)
            assert c == 1 or blocks * (c // 2) < att.SMS // 2


def test_folded_tile():
    assert att.folded_tile(1024) == 16
    assert att.folded_tile(128) == 64
    for draw in range(128, 1025, 128):
        bk = att.folded_tile(draw)
        assert bk % 16 == 0 and 16 <= bk <= 64
        assert bk * (draw + 8) * 2 <= 33 * 1024  # one ring stage
