"""The DETR captioner (bmhrl_tpu_torch/models/detr.py) against
bmhrl_tpu.models.detr on the CPU, f32, one weight tree per variant: the
weight map, the forward's six outputs on the default and the pre-goal
path, the temporal projections, and the fast decode step against the
full-buffer frontier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401
from torch_port_detr_common import (BOS, D_VIDEO, DIMS, PAD, assert_close,
                                    both_inputs, captions, detr_features,
                                    flat, jax_detr, jax_tree, port_tree,
                                    torch_detr)

VARIANTS = {"default": False, "pre_goal": True}


@pytest.fixture(scope="module")
def setups():
    """Per variant: port model, JAX model and params, inputs, and the JAX
    forward (one trace per variant, flash off)."""
    out = {}
    f, cap = detr_features(), captions()
    (tV, tA, tm), (jV, jA, jm) = both_inputs(f, cap)
    with jax_kernels(flash=False):
        for name, pg in VARIANTS.items():
            tree = port_tree(pg)
            jm_ = jax_detr(pg)
            params = jax_tree(tree)
            fwd = jax.jit(lambda p, m=jm_: m.apply(p, (jV, jA),
                                                   jnp.asarray(cap), jm))
            out[name] = dict(tree=tree, port=torch_detr(tree, pg), jax=jm_,
                             params=params, jout=fwd(params))
    out["inputs"] = (tV, tA, tm, jV, jA, jm, cap)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weight_map_matches_flax_tree(variant):
    """The port's parameters are the flax init tree's keys and shapes
    (jax.eval_shape of init): no dead module on either side (the default
    path's critic, the decoder's goal attention)."""
    pg = VARIANTS[variant]
    f, cap = detr_features(), captions()
    _, (jV, jA, jm) = both_inputs(f, cap)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jax_detr(pg).init,
                            {"params": k, "dropout": k, "noise": k},
                            (jV, jA), jnp.asarray(cap), jm)
    want = flat(jax.tree.map(lambda s: np.zeros(s.shape), shapes)["params"])
    assert flat(port_tree(pg)["params"]) == want
    assert ("critic" in {p[0] for p in want}) == pg


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(setups, variant):
    """All six outputs: log-probs, worker features, memory, the zero goal
    and segment slots, the detector's class logits."""
    s = setups[variant]
    tV, tA, tm, *_, cap = setups["inputs"]
    got = s["port"](tV, tA, torch.from_numpy(cap), tm)
    names = ("pred", "wf", "memory", "goals", "seg", "classes")
    assert len(got) == len(s["jout"]) == 6
    for name, g, w in zip(names, got, s["jout"]):
        assert tuple(g.shape) == tuple(w.shape), name
        assert_close(g.numpy(), w, 1e-5, name)
    assert np.isfinite(got[0].numpy()).all()


def test_temporal_projections_match_flax():
    """ConvSame pads an even kernel as flax's SAME does (2 left, 3 right at
    kernel 6); GroupNorm uses flax's statistics."""
    from bmhrl_tpu_torch.models.detr import ConvSame, GroupNorm

    rng = np.random.RandomState(4)
    x = rng.randn(2, 11, 64).astype(np.float32)
    for k in (3, 6, 9):
        conv = fnn.Conv(64, kernel_size=(k,), padding="SAME",
                        dtype=jnp.float32)
        p = conv.init(jax.random.PRNGKey(k), jnp.asarray(x))
        want = conv.apply(p, jnp.asarray(x))
        port = ConvSame(64, 64, k, torch.float32)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(
                np.asarray(p["params"]["kernel"]).T.copy()))
            port.bias.copy_(torch.from_numpy(np.asarray(
                p["params"]["bias"]) + 0.1))
        assert_close(port(torch.from_numpy(x)).detach().numpy(),
                     np.asarray(want) + 0.1, 1e-5, f"kernel {k}")
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.float32)
    p = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = GroupNorm(32, 64, eps=1e-5)
    assert_close(port(torch.from_numpy(x * 3.0 + 2.0)).detach().numpy(),
                 gn.apply(p, jnp.asarray(x * 3.0 + 2.0)), 1e-5, "groupnorm")


def test_f32_conv_gradients_match_flax_and_keep_the_cudnn_setting():
    """An f32 ConvSame runs forward and backward through its own autograd
    function (cuDNN's TF32 off for both on the card): its input, kernel
    and bias gradients equal flax's within 1e-5, and the caller's
    ``torch.backends.cudnn.allow_tf32`` is what it was before."""
    from bmhrl_tpu_torch.models.detr import ConvSame

    rng = np.random.RandomState(6)
    x = rng.randn(2, 11, 16).astype(np.float32)
    g = rng.randn(2, 11, 8).astype(np.float32)
    before = torch.backends.cudnn.allow_tf32
    for k in (3, 6):
        conv = fnn.Conv(8, kernel_size=(k,), padding="SAME",
                        dtype=jnp.float32)
        p = conv.init(jax.random.PRNGKey(k), jnp.asarray(x))

        def loss(p, x):
            return jnp.sum(conv.apply(p, x) * g)

        jp, jx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
        port = ConvSame(16, 8, k, torch.float32)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(
                np.asarray(p["params"]["kernel"]).T.copy()))
            port.bias.copy_(torch.from_numpy(np.array(p["params"]["bias"])))
        xt = torch.from_numpy(x).requires_grad_(True)
        (port(xt) * torch.from_numpy(g)).sum().backward()
        assert_close(xt.grad.numpy(), jx, 1e-5, f"input grad, kernel {k}")
        assert_close(port.weight.grad.numpy(),
                     np.asarray(jp["params"]["kernel"]).T, 1e-5,
                     f"kernel grad, kernel {k}")
        assert_close(port.bias.grad.numpy(), jp["params"]["bias"], 1e-5,
                     f"bias grad, kernel {k}")
    assert torch.backends.cudnn.allow_tf32 == before


def test_decode_step_matches_jax_decode_frontier(setups):
    """The fast step's log-probs at every position of a teacher-forced
    buffer equal JAX's full-buffer frontier (``decode_frontier`` over the
    precomputed memory and object keys/values); the stub critic gives no
    boundary."""
    from bmhrl_tpu.ops.masking import c_mask as jc_mask

    s = setups["default"]
    model, jm_, params = s["port"], s["jax"], s["params"]
    tV, tA, _, jV, jA, _, cap = setups["inputs"]
    f = detr_features()
    (tV, tA, tms), (jV, jA, jms) = both_inputs(f)
    buf = cap.copy()
    buf[:, 4] = 3  # an EOS mid-buffer: the input quirk makes it PAD
    L = buf.shape[1]
    with torch.no_grad():
        Va, Av = model.encode(tV, tA, tms)
        B_ = buf.shape[0]
        caches = model.init_decode_caches(B_, L)
        kv_mem = model.precompute_decode_mem(Va)
        sw = model.step_weights()
        valid = torch.zeros(B_, L, dtype=torch.bool)
        tb = torch.from_numpy(buf)
        got = []
        for t in range(L):
            valid[:, t] = tb[:, t] != PAD
            valid[:, 0] = True
            got.append(model.decode_step(tb[:, t], torch.tensor(t), caches,
                                         tms["V_mask"], kv_mem, Av, valid,
                                         sw).numpy())
        score, st = model.critic_step(tb[:, 0], model.critic_init_state(B_))
        assert (torch.sigmoid(score) == 0).all()

    with jax_kernels(flash=False):
        jVa, jAv = jm_.apply(params, jV, jA, jms, method="encode")
        kv = jm_.apply(params, jVa, jAv, method="precompute_fusion_kv")
        masks = dict(jms, C_mask=jc_mask(jnp.asarray(buf), PAD))
        frontier = jax.jit(lambda t: jm_.apply(
            params, jnp.asarray(buf), jnp.zeros(buf.shape, jnp.int32), jVa,
            jAv, masks, t, method="decode_frontier", fusion_kv=kv))
        for t in range(L):
            assert_close(got[t], frontier(t), 1e-5, f"position {t}")
    assert buf[0, 0] == BOS and DIMS["num_layers"] == 2 and D_VIDEO == 128
