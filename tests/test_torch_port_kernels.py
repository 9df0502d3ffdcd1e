"""The port's kernel modules against the JAX package's kernels, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors; the
JAX side runs its Pallas kernels in interpret mode. Same numpy inputs.
Tolerance: 1e-5 absolute in f32 (both sides accumulate in f32, in another
order); bf16 cases allow 1 bf16 ulp of the outputs' magnitude (8e-3 below
2.0), since both round p and the output to bf16 at the same points but from
sums taken in another order.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import jax_kernels

from bmhrl_tpu.ops import attention as jfused
from bmhrl_tpu.ops import critic_kernels as jck
from bmhrl_tpu_torch.ops import _cuda
from bmhrl_tpu_torch.ops import attention as att
from bmhrl_tpu_torch.ops import critic_kernels as ck

REPO = pathlib.Path(__file__).resolve().parent.parent
F32_TOL = 1e-5
BF16_TOL = 8e-3


@pytest.fixture(autouse=True, scope="module")
def flash_on():
    with jax_kernels(flash=True, folded=True):
        yield


def _bsd(seed, B, Sq, Sk, HD, dtype=np.float32):
    rng = np.random.RandomState(seed)
    # q scaled so logits stay O(1): near-tied keys would amplify f32 noise
    q = (rng.randn(B, Sq, HD) * 0.2).astype(np.float32)
    k = rng.randn(B, Sk, HD).astype(np.float32)
    v = rng.randn(B, Sk, HD).astype(np.float32)
    return q, k, v


def _ragged_mask(B, Sk, masked_row=None, seed=0):
    rng = np.random.RandomState(seed + 100)
    mask = np.zeros((B, Sk), np.int32)
    for b in range(B):
        mask[b, : rng.randint(Sk // 2, Sk + 1)] = 1
    if masked_row is not None:
        mask[masked_row] = 0
    return mask


def _flash_pair(q, k, v, mask, H, causal, jdtype, tdtype):
    want = jfused.flash_attention_bsd(
        jnp.asarray(q, jdtype), jnp.asarray(k, jdtype), jnp.asarray(v, jdtype),
        None if mask is None else jnp.asarray(mask), H, causal)
    got = att.flash_attention_bsd(
        torch.from_numpy(q).to(tdtype), torch.from_numpy(k).to(tdtype),
        torch.from_numpy(v).to(tdtype),
        None if mask is None else torch.from_numpy(mask), H, causal)
    return (got.float().numpy(),
            np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("Sq,Sk,causal,masked_row", [
    (128, 160, False, None),   # Sk not a multiple of the kernel tiles
    (64, 300, False, 1),       # a fully-masked row: mean(V) over 300 keys
    (130, 130, True, None),    # causal
    (31, 128, False, 0),
])
def test_flash_matches_jax_f32(Sq, Sk, causal, masked_row):
    q, k, v = _bsd(Sq + Sk, 3, Sq, Sk, 256)
    mask = _ragged_mask(3, Sk, masked_row)
    got, want = _flash_pair(q, k, v, mask, 2, causal, jnp.float32,
                            torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    if masked_row is not None:
        mean_v = v[masked_row].mean(0)
        np.testing.assert_allclose(got[masked_row], np.broadcast_to(
            mean_v, got[masked_row].shape), rtol=0, atol=F32_TOL)


def test_flash_matches_jax_no_mask():
    q, k, v = _bsd(7, 2, 40, 200, 256)
    got, want = _flash_pair(q, k, v, None, 2, False, jnp.float32,
                            torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_flash_matches_jax_streaming_kernel():
    """K2 (_flash_stream_kernel, online softmax over key blocks) computes the
    same function; the port's one kernel covers both."""
    q, k, v = _bsd(11, 2, 64, 400, 256)
    mask = _ragged_mask(2, 400, masked_row=1)
    jfused.set_stream_mode("on")
    try:
        got, want = _flash_pair(q, k, v, mask, 2, False, jnp.float32,
                                torch.float32)
    finally:
        jfused.set_stream_mode("auto")
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_bf16(causal):
    q, k, v = _bsd(3, 2, 64, 160, 256)
    mask = _ragged_mask(2, 160, masked_row=1)
    got, want = _flash_pair(q, k, v, mask, 2, causal, jnp.bfloat16,
                            torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def _folded_inputs(seed, B=4, G=4, S=100, draw=128, masked_row=2):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, G, draw) * 0.3).astype(np.float32)
    mem = rng.randn(B, S, draw).astype(np.float32)
    mask = _ragged_mask(B, S, masked_row, seed).astype(bool)
    return q, mem, mask


@pytest.mark.parametrize("S,draw", [(100, 128), (64, 256), (160, 128)])
def test_folded_matches_jax_kernel(S, draw):
    """Rows with at least one key: the port equals the JAX Pallas kernel."""
    q, mem, mask = _folded_inputs(S, S=S, draw=draw, masked_row=None)
    scale = 1.0 / np.sqrt(128.0)
    assert jfused.folded_qualifies(S, draw)
    want = np.asarray(jfused.folded_attend(
        jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mask), scale))
    got = att.folded_attend(torch.from_numpy(q), torch.from_numpy(mem),
                            torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_folded_bf16_memory_matches_jax_kernel():
    q, mem, mask = _folded_inputs(5, masked_row=None)
    scale = 0.125
    want = np.asarray(jfused.folded_attend(
        jnp.asarray(q), jnp.asarray(mem, jnp.bfloat16), jnp.asarray(mask),
        scale))
    got = att.folded_attend(torch.from_numpy(q),
                            torch.from_numpy(mem).to(torch.bfloat16),
                            torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_folded_fully_masked_row_is_own_mean():
    """A fully-masked row must give mean(mem) over ITS OWN S keys. The JAX
    XLA path of the same function (enable_folded_kernel(False)) does; the
    JAX Pallas kernel's block-diagonal batching does not (it averages every
    column of its batch tile, other clips and padding included), so the
    port is held against the XLA path for that row."""
    q, mem, mask = _folded_inputs(9, B=3, G=4, S=70, masked_row=1)
    scale = 1.0 / np.sqrt(128.0)
    got = att.folded_attend(torch.from_numpy(q), torch.from_numpy(mem),
                            torch.from_numpy(mask), scale).numpy()
    with jax_kernels(folded=False):
        xla = np.asarray(jfused.folded_attend(
            jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mask), scale))
    np.testing.assert_allclose(got, xla, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(mem[1].mean(0),
                                                       (4, 128)),
                               rtol=0, atol=F32_TOL)
    kernel = np.asarray(jfused.folded_attend(
        jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mask), scale))
    # the JAX kernel's fault: the masked row is off, the others agree
    assert np.abs(kernel[1] - got[1]).max() > 0.05
    np.testing.assert_allclose(np.delete(kernel, 1, 0), np.delete(got, 1, 0),
                               rtol=0, atol=F32_TOL)


def _cell_inputs(seed, B, K, H, n_gates):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(H)

    def u(*shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    x = rng.randn(B, K).astype(np.float32)
    h = (rng.randn(B, H) * 0.5).astype(np.float32)
    c = (rng.randn(B, H) * 0.5).astype(np.float32)
    return x, h, c, u(n_gates * H, K), u(n_gates * H, H), u(n_gates * H), \
        u(n_gates * H)


@pytest.mark.parametrize("B,K,H", [(5, 32, 64), (3, 64, 64), (9, 150, 300)])
def test_lstm_cell_matches_jax(B, K, H):
    x, h, c, w_ih, w_hh, b_ih, b_hh = _cell_inputs(B + K, B, K, H, 4)
    b_sum = b_ih + b_hh
    jh, jc = jck.lstm_cell(*(jnp.asarray(a) for a in
                             (x, h, c, w_ih, w_hh, b_sum)))
    th, tc = ck.lstm_cell(*(torch.from_numpy(a) for a in
                            (x, h, c, w_ih, w_hh, b_sum)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("B,K,H", [(5, 64, 64), (9, 300, 300)])
def test_gru_cell_matches_jax(B, K, H):
    x, h, _, w_ih, w_hh, b_ih, b_hh = _cell_inputs(B * K, B, K, H, 3)
    jh = jck.gru_cell(*(jnp.asarray(a) for a in (x, h, w_ih, w_hh, b_ih,
                                                 b_hh)))
    th = ck.gru_cell(*(torch.from_numpy(a) for a in (x, h, w_ih, w_hh, b_ih,
                                                     b_hh)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=F32_TOL)


def test_cells_match_torch_nn_cells():
    x, h, c, w_ih, w_hh, b_ih, b_hh = _cell_inputs(0, 4, 32, 64, 4)
    lstm = torch.nn.LSTMCell(32, 64)
    gx, gh, _, gw_ih, gw_hh, gb_ih, gb_hh = _cell_inputs(1, 4, 64, 64, 3)
    gru = torch.nn.GRUCell(64, 64)
    with torch.no_grad():
        for cell, ws in ((lstm, (w_ih, w_hh, b_ih, b_hh)),
                         (gru, (gw_ih, gw_hh, gb_ih, gb_hh))):
            for p, w in zip((cell.weight_ih, cell.weight_hh, cell.bias_ih,
                             cell.bias_hh), ws):
                p.copy_(torch.from_numpy(w))
        t = torch.from_numpy
        want_h, want_c = lstm(t(x), (t(h), t(c)))
        got_h, got_c = ck.lstm_cell(t(x), t(h), t(c), t(w_ih), t(w_hh),
                                    t(b_ih + b_hh))
        torch.testing.assert_close(got_h, want_h, rtol=0, atol=F32_TOL)
        torch.testing.assert_close(got_c, want_c, rtol=0, atol=F32_TOL)
        torch.testing.assert_close(
            ck.gru_cell(t(gx), t(gh), t(gw_ih), t(gw_hh), t(gb_ih), t(gb_hh)),
            gru(t(gx), t(gh)), rtol=0, atol=F32_TOL)


def test_cpu_wrappers_take_plain_versions_and_never_launch():
    _cuda.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _bsd(0, 2, 16, 128, 256))
    out = att.flash_attention_bsd(q, k, v, None, 2)
    torch.testing.assert_close(
        out, att.flash_attention_bsd_plain(q, k, v, None, 2), rtol=0, atol=0)
    qf, mem, mask = (torch.from_numpy(a) for a in _folded_inputs(1))
    torch.testing.assert_close(att.folded_attend(qf, mem, mask, 0.1),
                               att.folded_attend_plain(qf, mem, mask, 0.1),
                               rtol=0, atol=0)
    x, h, c, w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(a) for a in
                                       _cell_inputs(0, 2, 8, 8, 4))
    ck.lstm_cell(x, h, c, w_ih, w_hh, b_ih)
    assert all(n == 0 for n in _cuda.LAUNCHES.values()), _cuda.LAUNCHES
    assert set(_cuda.LAUNCHES) == {"flash_attention_tc",
                                   "flash_attention_simt", "folded_attend_tc",
                                   "folded_attend_simt", "lstm_cell",
                                   "gru_cell"}


def test_flash_gate_matches_jax():
    for Sk, dk in ((127, 128), (128, 128), (800, 256), (300, 100),
                   (300, 640), (300, 512)):
        assert att.flash_qualifies(Sk, dk) == jfused.flash_qualifies(
            1, Sk, dk), (Sk, dk)


def _port_files():
    files = sorted((REPO / "bmhrl_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """The port and chip_smoke.py import neither JAX/flax nor the JAX
    package, not even its JAX-free modules, nor the JAX CLIs (the top-level
    ``cli`` package), nor NLTK (the port stems with its own
    ``eval.porter`` and runs where NLTK is not installed)."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "jaxlib",
                                                   "optax", "bmhrl_tpu",
                                                   "cli", "nltk")]
    assert not bad, f"{path}: imports {bad}"


def test_kernel_sources_ship_with_the_package():
    srcs = {p.name for p in (REPO / "bmhrl_tpu_torch" / "csrc").iterdir()}
    assert {f"{n}.cu" for n in _cuda.SOURCES} | {"common.cuh"} <= srcs


def _simt_folded_widths():
    """(dtype, width) pairs the "simt" folded route takes: every width up to
    4096 (one slab up to 1664, two or three above) and some far wider
    ones, f32 at each, bf16 outside 128..1024 step 128."""
    for draw in list(range(1, 4097)) + [19200, 19370, 1 << 16, 1 << 20]:
        yield torch.float32, draw
        if att.folded_route(torch.bfloat16, draw) == "simt":
            yield torch.bfloat16, draw


def _folded_simt_smem(draw, esz):
    """Shared-memory bytes of one "simt" folded block
    (csrc/folded_attention.cu simt::smem_bytes): the larger of a 2-stage
    ring of 16 key rows (128 nm columns + 16 bytes) and the partial context
    after the loop (chunk rows of 128 nm + 4 f32), then the 8 warps'
    partial scores (chunk x 20 f32 each), p (chunk x 24 f32), the mask ring
    (2 x 16 int) and corr, m and l (chunk f32 each); nm is the slab's
    16-column tiles a warp."""
    qb = att.folded_simt_chunk(draw)
    tiles = -(-draw // 128)
    nm = -(-tiles // att.folded_simt_slabs(draw))
    dp = 128 * nm
    return (max(2 * 16 * (dp + 16 // esz) * esz, 4 * qb * (dp + 4))
            + 4 * (8 * qb * 20 + qb * 24 + 32 + 3 * qb))


def test_folded_simt_chunk_keeps_shared_memory_in_bounds():
    """The "simt" folded kernel's block fits the card's 232,448 bytes of
    shared memory at every (dtype, width) its route takes: one column slab
    of at most 13 16-column tiles a warp (draw 1664), and above that
    ceil(tiles / 13) slabs of 7..13 tiles each that cover the memory. Any
    G up to 64 (the f32 beam's 2 stacks x 4 heads x 8 beams) is served in
    ceil(G / chunk) blocks; a chunk holds the f32 greedy decode's G = 8 in
    one block."""
    assert att.MAX_SMEM == 232448
    for dtype, draw in _simt_folded_widths():
        esz = 4 if dtype == torch.float32 else 2
        chunk = att.folded_simt_chunk(draw)
        assert chunk == (16 if draw <= 1024 else 8), draw
        tiles = -(-draw // 128)
        slabs = att.folded_simt_slabs(draw)
        nm = -(-tiles // slabs)
        assert (slabs == 1) == (draw <= 1664), draw
        assert nm <= 13 and (slabs == 1 or nm >= 7), draw
        assert (slabs - 1) * 128 * nm < draw <= slabs * 128 * nm, draw
        assert _folded_simt_smem(draw, esz) <= att.MAX_SMEM, draw
    for chunk in (8, 16):
        for G in range(1, 65):
            blocks = -(-G // chunk)
            assert blocks * chunk >= G and blocks <= 8, (chunk, G)
    # exact bytes
    for draw, dtype, want in ((1024, torch.float32, 143680),
                              (128, torch.float32, 28992),
                              (1152, torch.float32, 154080),
                              (1664, torch.float32, 219616),
                              (2048, torch.float32, 137696),
                              (19200, torch.float32, 219616),
                              (300, torch.bfloat16, 37184),
                              (1152, torch.bfloat16, 80352),
                              (2048, torch.bfloat16, 72160)):
        esz = 4 if dtype == torch.float32 else 2
        assert _folded_simt_smem(draw, esz) == want, (draw, dtype)
    # one more tile of f32 rows would not fit: 13 is the widest slab
    assert 2 * 16 * (128 * 14 + 4) * 4 + 4 * (8 * 8 * 20 + 8 * 24 + 32 + 24) \
        > att.MAX_SMEM
    assert [att.folded_simt_slabs(d) for d in (1, 1664, 1665, 2048, 3328,
                                               3329, 19200)] \
        == [1, 1, 2, 2, 2, 3, 12]
    with pytest.raises(ValueError, match="positive width"):
        att.folded_simt_chunk(0)


def test_flash_simt_geometry_keeps_shared_memory_in_bounds():
    """The "simt" flash kernel's block fits 232,448 bytes of shared memory
    at every (dtype, d) its route takes and every grid: 8 warps (4 at f32
    d=512, where 8 do not fit), and 4 at d <= 256 where 8-warp blocks would
    give under half the SMs a block."""
    routes = [(torch.float32, d) for d in (128, 256, 384, 512)] + [
        (torch.bfloat16, d) for d in (384, 512)]
    for dtype, d in routes:
        assert att.flash_route(dtype, d) == "simt"
        for B in (1, 2, 4, 8, 16, 33, 64, 256):
            for H in (1, 2, 4, 8):
                for Sq in (1, 16, 37, 128, 160, 300, 800):
                    w = att.flash_simt_warps(dtype, d, B, H, Sq)
                    assert w in (4, 8)
                    assert att.flash_simt_smem(dtype, d, w) <= att.MAX_SMEM
                    if w == 4 and not (dtype == torch.float32 and d == 512):
                        assert d <= 256 and B * H * -(-Sq // 128) < 66
    # exact bytes: Q rows, 2 stages of K and V, 2 of the mask
    assert att.flash_simt_smem(torch.float32, 128, 8) == 101504
    assert att.flash_simt_smem(torch.float32, 128, 4) == 67712
    assert att.flash_simt_smem(torch.float32, 256, 8) == 199808
    assert att.flash_simt_smem(torch.float32, 256, 4) == 133248
    assert att.flash_simt_smem(torch.float32, 384, 8) == 198784
    assert att.flash_simt_smem(torch.float32, 512, 8) == 264320 \
        > att.MAX_SMEM
    assert att.flash_simt_smem(torch.float32, 512, 4) == 198272
    assert att.flash_simt_smem(torch.bfloat16, 384, 8) == 100480
    assert att.flash_simt_smem(torch.bfloat16, 512, 8) == 133248
    # the f32 flagship's encoder sites (B=256; the CLI serve's B=32; f32
    # training's B=16: 64 blocks at Sq 128, 128 at Sq 256), the reference
    # decode's, a long one, bf16 at d 384
    assert att.flash_simt_warps(torch.float32, 256, 256, 4, 128) == 8
    assert att.flash_simt_warps(torch.float32, 256, 32, 4, 128) == 8
    assert att.flash_simt_warps(torch.float32, 256, 16, 4, 128) == 4
    assert att.flash_simt_warps(torch.float32, 256, 16, 4, 256) == 8
    assert att.flash_simt_warps(torch.float32, 128, 8, 2, 160) == 4
    assert att.flash_simt_warps(torch.float32, 256, 256, 4, 800) == 8
    assert att.flash_simt_warps(torch.float32, 512, 256, 4, 128) == 4
    assert att.flash_simt_warps(torch.bfloat16, 384, 2, 2, 65) == 8