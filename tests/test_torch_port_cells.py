"""The port's packed critic cells and flash routing, on the CPU.

The cells: each cell's weights are packed once (``pack_lstm`` /
``pack_gru``), and the packed cell's plain version (the CPU side of the
wrapper) is held against the JAX package's Pallas cells in interpret mode,
at ragged widths (H and K not multiples of the kernel's unit and
contraction tiles) and B = 1, 3, 64. Tolerance 1e-5 absolute in f32: both
sides sum the same products in another order. The packed layout itself is
pinned entry by entry, since the CUDA kernel reads it as documented in
``PackedCell``."""
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import BOS, DIMS, EOS, PAD, features, to_torch

from bmhrl_tpu.models.critic import SegmentCritic as JCritic
from bmhrl_tpu.ops import critic_kernels as jck
from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops import attention as att
from bmhrl_tpu_torch.ops import critic_kernels as ck
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.decode import decode
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

TOL = 1e-5
SHAPES = [(1, 300, 600), (3, 20, 20), (64, 600, 600), (3, 75, 150),
          (64, 37, 20)]


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


@pytest.mark.parametrize("B,K,H", SHAPES)
def test_packed_lstm_matches_jax(B, K, H):
    x, h, c, w_ih, w_hh, b_ih, b_hh = _cell_inputs(B + K + H, B, K, H, 4)
    jh, jc = jck.lstm_cell(*(jnp.asarray(a) for a in
                             (x, h, c, w_ih, w_hh, b_ih + b_hh)))
    t = torch.from_numpy
    packed = ck.pack_lstm(t(w_ih), t(w_hh), t(b_ih) + t(b_hh))
    th, tc = ck.lstm_cell_packed(t(x), t(h), t(c), packed)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)


@pytest.mark.parametrize("B,K,H", SHAPES)
def test_packed_gru_matches_jax(B, K, H):
    x, h, _, w_ih, w_hh, b_ih, b_hh = _cell_inputs(B * K + H, B, K, H, 3)
    jh = jck.gru_cell(*(jnp.asarray(a) for a in (x, h, w_ih, w_hh, b_ih,
                                                 b_hh)))
    t = torch.from_numpy
    packed = ck.pack_gru(t(w_ih), t(w_hh), t(b_ih), t(b_hh))
    th = ck.gru_cell_packed(t(x), t(h), packed)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=TOL)


@pytest.mark.parametrize("n_gates", [4, 3])
def test_packed_layout(n_gates):
    """Every entry of the packed buffers sits where ``PackedCell`` (and the
    kernel) says: w[t, k, u*G + g] is gate g of unit t*UNITS + u at
    contraction row k of [x (padded to Kp), h (padded to Hp)]; padding is
    zero; biases per unit as documented."""
    B, K, H, G = 2, 45, 21, n_gates
    _, _, _, w_ih, w_hh, b_ih, b_hh = _cell_inputs(7, B, K, H, G)
    t = torch.from_numpy
    if G == 4:
        p = ck.pack_lstm(t(w_ih), t(w_hh), t(b_ih + b_hh))
        want_b = (b_ih + b_hh).reshape(4, H).T
    else:
        p = ck.pack_gru(t(w_ih), t(w_hh), t(b_ih), t(b_hh))
        bi, bh = b_ih.reshape(3, H), b_hh.reshape(3, H)
        want_b = np.stack([bi[0] + bh[0], bi[1] + bh[1], bi[2], bh[2]], 1)
    Kp, Hp, T = 64, 32, 3
    assert (p.K, p.H) == (K, H)
    assert tuple(p.w.shape) == (T, Kp + Hp, ck.UNITS * G)
    want = np.zeros((T, Kp + Hp, ck.UNITS * G), np.float32)
    for n in range(H):
        tt, u = divmod(n, ck.UNITS)
        for g in range(G):
            want[tt, :K, u * G + g] = w_ih[g * H + n]
            want[tt, Kp:Kp + H, u * G + g] = w_hh[g * H + n]
    np.testing.assert_array_equal(p.w.numpy(), want)
    np.testing.assert_allclose(p.b[:H].numpy(), want_b, rtol=0, atol=0)
    assert not p.b[H:].any()


def test_packed_tiles_match_kernel_source():
    """The packer's tiles are the ones ``csrc/critic_cells.cu`` reads with
    (its BN and BK): the kernel refuses any other layout at launch, and this
    catches an edit of one side without the card."""
    src = (Path(ck.__file__).parent.parent / "csrc" /
           "critic_cells.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("BN"), const("BK")) == (ck.UNITS, ck.KTILE)


def test_critic_step_with_packed_weights_matches_jax():
    """SegmentCritic.step over weights packed once, against the JAX critic
    step with its Pallas cells in interpret mode, over several tokens."""
    D, Bn, T = 32, 3, 5
    rng = np.random.RandomState(4)
    emb = rng.randn(Bn, T, D).astype(np.float32)
    jc = JCritic(D)
    p = jc.init(jax.random.PRNGKey(5), jnp.asarray(emb))
    tc = load_jax_params(SegmentCritic(D, device="cpu"),
                         jax.tree.map(np.asarray, p))
    with torch.no_grad():
        weights = tc.step_weights()
    jstate = jc.apply(p, Bn, method="init_state")
    tstate = tc.init_state(Bn)
    jck.force_interpret(True)
    try:
        for t in range(T):
            js, jstate = jc.apply(p, jnp.asarray(emb[:, t]), jstate,
                                  method="step")
            with torch.no_grad():
                ts, tstate = tc.step(torch.from_numpy(emb[:, t]), tstate,
                                     weights)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                       atol=TOL)
            for (th, tcc), (jh, jcc) in zip(tstate["lstm"], jstate["lstm"]):
                np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                           rtol=0, atol=TOL)
                np.testing.assert_allclose(tcc.numpy(), np.asarray(jcc),
                                           rtol=0, atol=TOL)
            for th, jh in zip(tstate["gru"], jstate["gru"]):
                np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                           rtol=0, atol=TOL)
    finally:
        jck.force_interpret(False)


def test_decode_packs_the_critic_once():
    """A greedy decode packs the six cells once, whatever its length, and
    every token step runs the packed cells."""
    model = BMHrlAgent(**DIMS, dtype=torch.float32, device="cpu")
    load_jax_params(model, random_jax_layout_params(DIMS, seed=2))
    model.requires_grad_(False)
    tf = to_torch(features(seed=3))
    with mock.patch.object(ck, "pack_lstm", wraps=ck.pack_lstm) as pl, \
            mock.patch.object(ck, "pack_gru", wraps=ck.pack_gru) as pg, \
            mock.patch.object(ck, "lstm_cell_packed",
                              wraps=ck.lstm_cell_packed) as cl:
        tok, _ = decode(model, tf, make_masks(tf), 6, BOS, -1, PAD)
    steps = tok.shape[1] - 1
    assert steps == 6 and EOS != -1
    assert (pl.call_count, pg.call_count) == (4, 2)
    assert cl.call_count == 4 * steps


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 384, "simt"), (torch.bfloat16, 512, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 512, "simt")])
def test_flash_route(dtype, d, route):
    assert att.flash_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d", [(torch.float16, 256),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 640)])
def test_flash_route_rejects(dtype, d):
    with pytest.raises(ValueError):
        att.flash_route(dtype, d)
