"""The training slice's model side, port vs JAX package on the CPU: caption
masks, segment ops, the critic scan, flash attention's gradient, the
teacher-forced forward (deterministic, and with dropout and exploration
fed the same draws), the value functions and the parameter groups.

Tolerances: masks, labels, boundaries and goal expansion exact; f32
module outputs 1e-5 absolute (f32 sums in another order); the forward's
log-probs 1e-4 absolute (two encoder and two fusion layers deep); flash
gradients 1e-4 of each gradient's max abs in f32 and 1e-2 in bf16 (both
sides round p, g and ds to bf16 at the same points, from f32 sums taken in
another order: a flipped rounding is one bf16 ulp, 2^-8 of the value)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (DIMS, features, jax_agent, jax_kernels,
                               jax_tree, to_torch, torch_agent)
from torch_port_train_common import (RecordingDraws, caption_batch,
                                     fed_draws, mixed_label_tree)

from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
from bmhrl_tpu.models.critic import SegmentCritic as JCritic
from bmhrl_tpu.ops import attention as jfused
from bmhrl_tpu.ops import masking as jmasking
from bmhrl_tpu.ops import segments as jsegments
from bmhrl_tpu.train.steps import param_groups as jparam_groups
from bmhrl_tpu_torch.models.blocks import Draws, dropout
from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                          BMWorkerValueFunction)
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops import _cuda
from bmhrl_tpu_torch.ops import attention as att
from bmhrl_tpu_torch.ops import masking, segments
from bmhrl_tpu_torch.train.steps import param_groups
from bmhrl_tpu_torch.weights import (_flax_paths, load_jax_params,
                                     random_jax_layout_params,
                                     random_module_params)

L = 8


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def captions():
    return caption_batch(7, 3, L, DIMS["voc_size"])


@pytest.fixture(scope="module")
def tree(captions):
    return mixed_label_tree(random_jax_layout_params(DIMS, seed=2), captions)


@pytest.fixture(scope="module")
def jax_forward(tree):
    """One jitted JAX forward with fed draws, for the module."""
    model = jax_agent()

    def fwd(params, V, A, trg, masks, keeps, normals, exploration,
            deterministic):
        with fed_draws(keeps, normals):
            return model.apply(params, (V, A), trg, masks,
                               exploration=exploration,
                               deterministic=deterministic,
                               rngs={"noise": jax.random.PRNGKey(0),
                                     "dropout": jax.random.PRNGKey(0)})

    fn = jax.jit(fwd, static_argnames=("exploration", "deterministic"))
    with jax_kernels(flash=True):
        yield lambda *a, **k: fn(jax_tree(tree), *a, **k)


# ---- masks and segment ops ----------------------------------------------
def test_c_mask_and_make_masks_match_jax(captions):
    np.testing.assert_array_equal(masking.subsequent_mask(5).numpy(),
                                  np.asarray(jmasking.subsequent_mask(5)))
    trg = captions.copy()
    trg[1, 3] = 1  # a pad mid-caption
    np.testing.assert_array_equal(
        masking.c_mask(torch.from_numpy(trg), 1).numpy(),
        np.asarray(jmasking.c_mask(jnp.asarray(trg), 1)))
    f = features(seed=3)
    want = jmasking.make_masks({k: jnp.asarray(v) for k, v in f.items()},
                               jnp.asarray(trg), "audio_video", 1)
    got = masking.make_masks(to_torch(f), torch.from_numpy(trg), 1)
    assert set(got) == set(want) == {"V_mask", "A_mask", "C_mask"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _random_segment_mask(seed, B=6, Ln=9):
    rng = np.random.RandomState(seed)
    m = (rng.rand(B, Ln) > 0.7).astype(np.int32)
    m[rng.randint(B)] = 0        # a row with no boundary
    if seed % 3 == 0:
        m[0] = 0                 # the row-0 quirk
    if seed % 4 == 1:
        m[:] = 0                 # no boundary anywhere: x unchanged
    if seed % 4 == 2:
        m[:, -1] = 1             # no tails
    return m


@pytest.mark.parametrize("seed", range(8))
def test_segment_ops_match_jax(seed):
    m = _random_segment_mask(seed)
    rng = np.random.RandomState(seed + 50)
    x = rng.randn(*m.shape, 4).astype(np.float32)
    r = rng.randn(*m.shape).astype(np.float32)
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    np.testing.assert_array_equal(segments.next_boundary(tm).numpy(),
                                  np.asarray(jsegments.next_boundary(jm)))
    np.testing.assert_array_equal(
        segments.expand_goals(torch.from_numpy(x), tm).numpy(),
        np.asarray(jsegments.expand_goals(jnp.asarray(x), jm)))
    _close(segments.segment_sum_expand(torch.from_numpy(r), tm).numpy(),
           jsegments.segment_sum_expand(jnp.asarray(r), jm), 1e-6)


def test_expand_goals_finalisation_quirks():
    x = torch.arange(1, 3 * 4 + 1, dtype=torch.float32).reshape(3, 4, 1)
    m = torch.tensor([[0, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0]])
    got = segments.expand_goals(x, m)[..., 0]
    # row 0: boundary at 1 spreads x[0, 1]; its tail is zeroed because a
    # later row (2) has a boundary; row 1: no boundary, not row 0: raw;
    # row 2: the last boundary row keeps its raw tail
    assert got.tolist() == [[2, 2, 0, 0], [5, 6, 7, 8], [9, 10, 11, 12]]
    m0 = torch.tensor([[0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0]])
    got0 = segments.expand_goals(x, m0)[..., 0]
    assert got0[0].tolist() == [0, 0, 0, 0]  # row 0 zeroed
    assert got0[2].tolist() == [9, 10, 11, 12]
    assert torch.equal(segments.expand_goals(x, torch.zeros_like(m)), x)


# ---- critic -------------------------------------------------------------
def test_critic_scan_matches_jax(tree, captions):
    D = DIMS["d_model_caps"]
    cp = {"params": tree["params"]["critic"]}
    tc = load_jax_params(SegmentCritic(D, device="cpu"), cp)
    emb = (tree["params"]["emb_C"]["embedding"]["embedding"][captions]
           * np.float32(np.sqrt(D)))
    want = JCritic(D).apply(jax_tree(cp), jnp.asarray(emb))
    got = tc(torch.from_numpy(emb))
    assert got.shape == (3, L, 1) and got.grad_fn is None
    _close(got.numpy(), want)
    model = torch_agent(tree)
    labels = model.segment_labels_of(model.emb_C(torch.from_numpy(captions)))
    jlabels = jax_agent().apply(jax_tree(tree), jnp.asarray(emb),
                                method="segment_labels_of")
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert 0 < labels.float().mean() < 1  # boundaries and non-boundaries


# ---- flash attention's gradient ----------------------------------------------
def _flash_inputs(seed, B, Sq, Sk, HD, masked_row):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, Sq, HD) * 0.3).astype(np.float32)
    k = rng.randn(B, Sk, HD).astype(np.float32)
    v = rng.randn(B, Sk, HD).astype(np.float32)
    g = rng.randn(B, Sq, HD).astype(np.float32)
    mask = np.ones((B, Sk), np.int32)
    mask[0, Sk // 2:] = 0
    mask[masked_row] = 0  # fully masked
    return q, k, v, g, mask


@pytest.mark.parametrize("dtype,Sq,Sk,causal", [
    ("float32", 31, 128, False), ("float32", 64, 160, False),
    ("float32", 130, 130, True), ("bfloat16", 31, 160, False),
    ("bfloat16", 128, 128, False)])
def test_flash_grads_match_jax(dtype, Sq, Sk, causal):
    H, HD = 2, 256
    q, k, v, g, mask = _flash_inputs(Sq + Sk, 3, Sq, Sk, HD, masked_row=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax_kernels(flash=True):
        def loss(q_, k_, v_):
            out = jfused.flash_attention_bsd(q_, k_, v_, jnp.asarray(mask), H,
                                             causal)
            return jnp.sum(out.astype(jnp.float32) * g)
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = att.flash_attention_bsd(tq, tk, tv, torch.from_numpy(mask), H,
                                  causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBSDBackward"
    (out.float() * torch.from_numpy(g)).sum().backward()
    rel = 1e-4 if dtype == "float32" else 1e-2
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert t.grad.dtype == tdt
        _close(t.grad.float().numpy(), w, rel * np.abs(w).max())
        assert np.abs(w).max() > 0, name


def test_flash_function_through_merged_projection_views():
    """q, k, v as column views of one merged QKV tensor (as the model feeds
    them): the Function's gradient of the merged tensor equals autograd
    through the plain version, and a no-grad call saves nothing."""
    rng = np.random.RandomState(0)
    B, S, H, HD = 2, 128, 2, 256
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[1, 70:] = False
    base = torch.from_numpy(rng.randn(B, S, 3 * HD).astype(np.float32) * .3)
    g = torch.from_numpy(rng.randn(B, S, HD).astype(np.float32))
    grads = []
    for fn in (att.flash_attention_bsd, att.flash_attention_bsd_plain):
        qkv = base.clone().requires_grad_()
        q, k, v = qkv.split(HD, dim=-1)
        (fn(q, k, v, mask, H) * g).sum().backward()
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5)
    _cuda.reset_launches()
    with torch.no_grad():
        out = att.flash_attention_bsd(*base.requires_grad_().split(HD, -1),
                                      mask, H)
    assert out.grad_fn is None
    assert sum(_cuda.LAUNCHES.values()) == 0


# ---- the teacher-forced forward -------------------------------------------------
def _inputs(captions, seed=0):
    f = features(seed=seed)
    tf = to_torch(f)
    trg = torch.from_numpy(captions)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    jmasks = jmasking.make_masks(jf, jnp.asarray(captions), "audio_video", 1)
    return ((tf["rgb"] + tf["flow"], tf["audio"], trg,
             masking.make_masks(tf, trg)),
            (jf["rgb"] + jf["flow"], jf["audio"], jnp.asarray(captions),
             jmasks))


def _check_outputs(got, want):
    names = ("log_probs", "worker_feat", "manager_feat", "goals", "labels")
    for name, a, b in zip(names, got, want):
        a = a.detach().numpy()
        assert a.shape == np.shape(b), name
        if name == "labels":
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            _close(a, b, 1e-4)


def test_forward_matches_jax(tree, captions, jax_forward):
    tin, jin = _inputs(captions)
    got = torch_agent(tree)(*tin)
    want = jax_forward(*jin, [], [], exploration=False, deterministic=True)
    _check_outputs(got, want)
    assert 0 < got[4].float().mean() < 1
    np.testing.assert_allclose(got[0].exp().sum(-1).detach().numpy(), 1.0,
                               atol=1e-5)


def test_forward_with_dropout_and_exploration_matches_jax(tree, captions,
                                                          jax_forward):
    tin, jin = _inputs(captions, seed=1)
    draws = RecordingDraws(seed=4)
    got = torch_agent(tree)(*tin, exploration=True, deterministic=False,
                            draws=draws)
    # every dropout site of the JAX forward, in its order, and one normal
    assert len(draws.keeps) == 53 and len(draws.normals) == 1
    want = jax_forward(*jin, draws.keeps, draws.normals, exploration=True,
                       deterministic=False)
    _check_outputs(got, want)


def test_training_forward_needs_draws(tree, captions):
    tin, _ = _inputs(captions)
    with pytest.raises(ValueError, match="draws"):
        torch_agent(tree)(*tin, deterministic=False)


def test_same_seed_same_forward(tree, captions):
    tin, _ = _inputs(captions)
    model = torch_agent(tree)
    outs = [model(*tin, exploration=True, deterministic=False,
                  draws=Draws(seed, "cpu"))[0] for seed in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_critic_gets_no_gradient(tree, captions):
    tin, _ = _inputs(captions)
    model = torch_agent(tree).requires_grad_(True)
    out = model(*tin, exploration=True, deterministic=False,
                draws=Draws(0, "cpu"))
    out[0].sum().backward()
    crit = dict(model.critic.named_parameters())
    assert all(p.grad is None for p in crit.values())
    enc = [p for n, p in model.named_parameters() if n.startswith("bm_enc")]
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in enc)


def test_dropout_rate_and_scale():
    draws = Draws(0, "cpu")
    x = torch.ones(200, 1000)
    y = dropout(x, 0.1, draws)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    # bf16 divides by 0.9 rounded to bf16, as flax's weakly typed division
    xb = torch.ones(10, 10, dtype=torch.bfloat16)
    yb = dropout(xb, 0.1, Draws(1, "cpu"))
    scale = 1 / torch.tensor(0.9, dtype=torch.bfloat16).float()
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0].float(),
                       torch.full_like(yb[yb != 0].float(),
                                       scale.to(torch.bfloat16).float()))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, draws) is x


# ---- value functions and groups -----------------------------------------------------
@pytest.mark.parametrize("cls,jcls", [(BMWorkerValueFunction, JWV),
                                      (BMManagerValueFunction, JMV)])
def test_value_function_matches_jax(cls, jcls):
    D = DIMS["d_model_caps"]
    x = np.random.RandomState(3).randn(3, L, D).astype(np.float32)
    jm = jcls(D)
    arg = (jnp.asarray(x), None) if jcls is JWV else jnp.asarray(x)
    ref = jm.init(jax.random.PRNGKey(0), arg)
    model = cls(D, device="cpu")
    tree = random_module_params(model, seed=9)
    assert (jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, ref))
    load_jax_params(model, tree)
    _close(model(torch.from_numpy(x)).detach().numpy(),
           jm.apply(jax_tree(tree), arg))


def test_param_groups_match_jax(tree):
    want = jparam_groups(tree)["params"]
    model = torch_agent(tree)
    groups = param_groups(model)
    named = dict(model.named_parameters())
    assert len(groups) == len(named)
    for path, p, _ in _flax_paths(model):
        node = want
        for k in path:
            node = node[k]
        name = next(n for n, q in named.items() if q is p)
        assert groups[name] == node, (name, groups[name], node)
    assert set(groups.values()) == {"frozen", "embedding", "worker",
                                    "manager"}
