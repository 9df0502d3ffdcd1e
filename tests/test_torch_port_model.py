"""The port's host helpers and model modules against the JAX package, on
the CPU: masks, features, blocks, segments, the weight bridge,
MultiheadedAttention, SegmentCritic.step, one BMFusionLayer decode step and
the encoder. Same numpy inputs and one weight tree for both; f32
tolerance 1e-5 absolute (f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (B, DIMS, SA, SV, features, jax_agent,
                               jax_kernels, jax_tree, to_torch, torch_agent)

from bmhrl_tpu.data import features as jF
from bmhrl_tpu.data import vocab as jvocab
from bmhrl_tpu.models import blocks as jblocks
from bmhrl_tpu.models.attention import MultiheadedAttention as JMHA
from bmhrl_tpu.models.bmhrl import BMFusionLayer as JFusionLayer
from bmhrl_tpu.models.critic import SegmentCritic as JCritic
from bmhrl_tpu.ops import attention as jfused
from bmhrl_tpu.ops import masking as jmasking
from bmhrl_tpu.ops import segments as jsegments
from bmhrl_tpu_torch.data import features as F
from bmhrl_tpu_torch.data import vocab
from bmhrl_tpu_torch.models import blocks
from bmhrl_tpu_torch.models.attention import MultiheadedAttention
from bmhrl_tpu_torch.models.bmhrl import BMFusionLayer
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops import masking, segments
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=0)


# ---- host helpers ----------------------------------------------------------
def test_vocab_constants():
    assert vocab.SPECIALS == jvocab.SPECIALS
    assert (vocab.UNK, vocab.PAD, vocab.BOS, vocab.EOS) == (
        jvocab.UNK, jvocab.PAD, jvocab.BOS, jvocab.EOS)


@pytest.mark.parametrize("S,start,end,dur", [
    (100, 0.0, 10.0, 10.0), (100, 3.3, 3.31, 10.0), (100, 10.0, 10.0, 10.0),
    (57, 1.0, 7.5, 9.0), (1, 0.0, 0.2, 5.0)])
def test_crop_matches_jax(S, start, end, dur):
    assert F.crop_span(S, start, end, dur) == jF.crop_span(S, start, end, dur)
    feat = np.arange(S * 2, dtype=np.float32).reshape(S, 2)
    got = F.crop_a_segment(feat, start, end, dur)
    want = jF.crop_a_segment(feat, start, end, dur)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


def test_bucket_and_pad_stack_match_jax():
    buckets = (32, 64, 128)
    for n in (1, 32, 33, 128, 500):
        assert F.pick_bucket(n, buckets) == jF.pick_bucket(n, buckets)
    rng = np.random.RandomState(0)
    arrs = [rng.rand(n, 4).astype(np.float32) for n in (3, 9, 1)]
    np.testing.assert_array_equal(F.pad_stack(arrs, 8),
                                  jF.pad_stack(arrs, 8))
    np.testing.assert_array_equal(F.fill_missing_features(7),
                                  jF.fill_missing_features(7))


def test_load_features_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    for kind in ("rgb", "flow"):
        np.save(tmp_path / f"a_{kind}.npy", rng.rand(40, 16))
    np.save(tmp_path / "a.npy", rng.rand(90, 8))
    for vid in ("a", "missing"):
        got = F.load_features_from_npy(str(tmp_path), str(tmp_path), vid,
                                       2.0, 7.0, 10.0, d_vid=16, d_aud=8)
        want = jF.load_features_from_npy(str(tmp_path), str(tmp_path), vid,
                                         2.0, 7.0, 10.0, d_vid=16, d_aud=8)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_make_masks_matches_jax():
    f = features(seed=4)
    f["rgb"][1] = 0.0  # a clip with zero features
    want = jmasking.make_masks({k: jnp.asarray(v) for k, v in f.items()},
                               None, "audio_video", 1)
    got = masking.make_masks(to_torch(f))
    assert set(got) == set(want) == {"V_mask", "A_mask"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seq_len,d", [(3660, 32), (50, 7), (10, 300)])
def test_sinusoid_table_matches_jax(seq_len, d):
    np.testing.assert_array_equal(blocks.sinusoid_table(seq_len, d),
                                  jblocks.sinusoid_table(seq_len, d))


@pytest.mark.parametrize("seed", range(6))
def test_frontier_goal_matches_jax(seed):
    rng = np.random.RandomState(seed)
    Bn = 5
    x = rng.randn(Bn, 1, 4).astype(np.float32)
    label = (rng.rand(Bn) > 0.6).astype(np.int32)
    hb = (rng.rand(Bn) > 0.5) | label.astype(bool)
    want = jsegments.frontier_goal(jnp.asarray(x), jnp.asarray(label),
                                   jnp.asarray(hb))
    got = segments.frontier_goal(torch.from_numpy(x), torch.from_numpy(label),
                                 torch.from_numpy(hb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_arelu_matches_jax():
    x = np.linspace(-3, 3, 13, dtype=np.float32)[None]
    params = {"params": {"alpha": np.array([1.5], np.float32),
                         "beta": np.array([0.3], np.float32)}}
    want = jblocks.AReLU().apply(jax_tree(params), jnp.asarray(x))
    mod = load_jax_params(blocks.AReLU(), params)
    _close(mod(torch.from_numpy(x)).detach().numpy(), want)


# ---- weight bridge ---------------------------------------------------------
def test_random_tree_has_the_jax_init_layout(tree):
    model = jax_agent()
    rgb = jnp.ones((2, 16, DIMS["d_video"]))
    aud = jnp.ones((2, 16, DIMS["d_audio"]))
    trg = jnp.full((2, 8), 1, jnp.int32).at[:, 0].set(2)
    masks = jmasking.make_masks({"rgb": rgb, "audio": aud}, trg,
                                "audio_video", 1)
    k = jax.random.PRNGKey(0)
    ref = jax.jit(model.init)({"params": k, "dropout": k, "noise": k},
                              (rgb, aud), trg, masks)
    want = {jax.tree_util.keystr(p): np.shape(v) for p, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {jax.tree_util.keystr(p): np.shape(v) for p, v in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want


def test_load_jax_params_is_strict(tree):
    model = torch_agent(tree)
    got = model.emb_C.embedding.weight.numpy()
    np.testing.assert_array_equal(
        got, tree["params"]["emb_C"]["embedding"]["embedding"])
    kernel = tree["params"]["worker"]["projection"]["kernel"]
    np.testing.assert_array_equal(model.worker.projection.weight.numpy(),
                                  kernel.T)
    bad = {"params": dict(tree["params"], extra={"w": np.zeros(1)})}
    with pytest.raises(KeyError, match="extra"):
        torch_agent(bad)
    missing = {"params": {k: v for k, v in tree["params"].items()
                          if k != "manager"}}
    with pytest.raises(KeyError, match="manager"):
        torch_agent(missing)
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["params"]["manager"]["linear"]["kernel"] = np.zeros((3, 3))
    with pytest.raises(ValueError, match="manager/linear/kernel"):
        torch_agent(wrong)


def test_agent_requires_a_card_for_cuda():
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BMHrlAgent(**DIMS)


# ---- model modules ----------------------------------------------------------
def _mha_pair(seed, dq, dkv, H, d_model):
    jm = JMHA(dq, dkv, dkv, H, d_model=d_model, dtype=jnp.float32)
    x = jnp.ones((1, 4, dq))
    kv = jnp.ones((1, 4, dkv))
    p = jm.init(jax.random.PRNGKey(seed), x, kv, kv, None)
    tm = MultiheadedAttention(dq, dkv, dkv, H, d_model=d_model,
                              dtype=torch.float32, device="cpu")
    return jm, p, load_jax_params(tm, jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("Sk,cross", [(160, False), (160, True), (64, False),
                                      (130, True)])
def test_mha_matches_jax(Sk, cross):
    """Sk >= 128 with d_k = 128 takes the flash path on both sides (Pallas
    interpret vs the port's plain version); Sk = 64 the plain headed path."""
    jm, p, tm = _mha_pair(Sk, 128, 128, 2, 256)
    rng = np.random.RandomState(Sk)
    mem = rng.randn(B, Sk, 128).astype(np.float32)
    q = rng.randn(B, 40 if cross else Sk, 128).astype(np.float32)
    mask = np.ones((B, 1, Sk), bool)
    mask[0, :, Sk // 3:] = False
    mask[1] = False  # fully-masked row
    jq, jmem = jnp.asarray(q), jnp.asarray(mem)
    with jax_kernels(flash=True):
        assert jfused.flash_qualifies(1, Sk, 128) == (Sk >= 128)
        if cross:
            want = jm.apply(p, jq, jmem, jmem, jnp.asarray(mask))
        else:
            want = jm.apply(p, jmem, jmem, jmem, jnp.asarray(mask))
    tq, tmem = torch.from_numpy(q), torch.from_numpy(mem)
    with torch.no_grad():
        if cross:
            got = tm(tq, tmem, tmem, torch.from_numpy(mask))
        else:
            got = tm(tmem, tmem, tmem, torch.from_numpy(mask))
    _close(got.numpy(), want)


def test_segment_critic_step_matches_jax():
    D, Bn, T = 32, 4, 6
    rng = np.random.RandomState(2)
    emb = rng.randn(Bn, T, D).astype(np.float32)
    jc = JCritic(D)
    p = jc.init(jax.random.PRNGKey(3), jnp.asarray(emb))
    tc = load_jax_params(SegmentCritic(D, device="cpu"),
                         jax.tree.map(np.asarray, p))
    jstate = jc.apply(p, Bn, method="init_state")
    tstate = tc.init_state(Bn)
    for t in range(T):
        js, jstate = jc.apply(p, jnp.asarray(emb[:, t]), jstate,
                              method="step")
        with torch.no_grad():
            ts, tstate = tc.step(torch.from_numpy(emb[:, t]), tstate)
        _close(ts.numpy(), js)
        for (th, tcc), (jh, jcc) in zip(tstate["lstm"], jstate["lstm"]):
            _close(th.numpy(), jh)
            _close(tcc.numpy(), jcc)
        for th, jh in zip(tstate["gru"], jstate["gru"]):
            _close(th.numpy(), jh)
    # the decode step is the scan's row t
    full = jc.apply(p, jnp.asarray(emb))
    _close(ts.numpy(), full[:, -1])


def test_fusion_layer_step_matches_jax(tree):
    """Two decode positions of one BMFusionLayer: step_mem_pre, one folded
    contraction per branch, step_mem_post; caches and outputs agree."""
    H, L, dk = DIMS["att_heads"], 5, DIMS["d_model"] // DIMS["att_heads"]
    jl = JFusionLayer(DIMS["d_audio"], DIMS["d_video"], DIMS["d_model_caps"],
                      DIMS["d_model"], DIMS["d_ff_c"], 0.0, H,
                      dtype=jnp.float32)
    lp = {"params": tree["params"]["bm_worker_fus"]["layer_0"]}
    tl = load_jax_params(
        BMFusionLayer(DIMS["d_audio"], DIMS["d_video"], DIMS["d_model_caps"],
                      DIMS["d_model"], H, torch.float32, "cpu"), lp)
    jp = jax_tree(lp)
    rng = np.random.RandomState(5)
    Av = rng.randn(B, SA, DIMS["d_audio"]).astype(np.float32)
    Va = rng.randn(B, SV, DIMS["d_video"]).astype(np.float32)
    mA = np.ones((B, SA), bool)
    mA[2, 100:] = False
    mV = np.ones((B, SV), bool)
    mV[1] = False  # fully masked: JAX runs its XLA path for this case
    valid = np.zeros((B, L), bool)
    valid[:, :2] = True
    scale = 1.0 / np.sqrt(dk)
    jcache = {"k": jnp.zeros((B, H, L, dk)), "v": jnp.zeros((B, H, L, dk))}
    tcache = {"k": torch.zeros(B, H, L, dk), "v": torch.zeros(B, H, L, dk)}
    sw = tl.step_weights()
    for t in range(2):
        c_t = rng.randn(B, 1, DIMS["d_model_caps"]).astype(np.float32)
        with jax_kernels(folded=False):
            C, qA, qV, jcache = jl.apply(
                jp, jnp.asarray(c_t), t, jcache, key_mask=jnp.asarray(valid),
                method="step_mem_pre")
            ctxA = jfused.folded_attend(qA, jnp.asarray(Av), jnp.asarray(mA),
                                        scale)
            ctxV = jfused.folded_attend(qV, jnp.asarray(Va), jnp.asarray(mV),
                                        scale)
            want = jl.apply(jp, C, ctxA, ctxV, method="step_mem_post")
        with torch.no_grad():
            tC, tqA, tqV = tl.step_mem_pre(torch.from_numpy(c_t),
                                           torch.tensor(t), tcache,
                                           torch.from_numpy(valid), sw)
            _close(tC.numpy(), C)
            _close(tqA.numpy(), qA)
            _close(tqV.numpy(), qV)
            from bmhrl_tpu_torch.ops import attention as att
            tctxA = att.folded_attend(tqA, torch.from_numpy(Av),
                                      torch.from_numpy(mA), scale)
            tctxV = att.folded_attend(tqV, torch.from_numpy(Va),
                                      torch.from_numpy(mV), scale)
            got = tl.step_mem_post(tC, tctxA, tctxV, sw)
        _close(got.numpy(), want)
        _close(tcache["k"].numpy(), jcache["k"])
        _close(tcache["v"].numpy(), jcache["v"])


def test_encoder_matches_jax(tree):
    f = features(seed=6)
    V, A = f["rgb"] + f["flow"], f["audio"]
    jm = jax_agent()
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    jmasks = jmasking.make_masks(jf, None, "audio_video", 1)
    with jax_kernels(flash=True):
        Va, Av = jax.jit(lambda p: jm.apply(p, jnp.asarray(V), jnp.asarray(A),
                                            jmasks, method="encode"))(
            jax_tree(tree))
    tm = torch_agent(tree)
    tf = to_torch(f)
    with torch.no_grad():
        tVa, tAv = tm.encode(tf["rgb"] + tf["flow"], tf["audio"],
                             masking.make_masks(tf))
    _close(tVa.numpy(), Va, 1e-4)
    _close(tAv.numpy(), Av, 1e-4)


def test_config_defaults_match_jax():
    from bmhrl_tpu.config import Config as JConfig
    from bmhrl_tpu_torch.config import Config

    jcfg = JConfig(to_log=False, mesh_shape=(1, 1))
    cfg = Config()
    for name in Config.__dataclass_fields__:
        # the two fields set above for one CPU device: their own defaults
        want = (JConfig.__dataclass_fields__[name].default
                if name in ("to_log", "mesh_shape") else getattr(jcfg, name))
        assert getattr(cfg, name) == want, name
    assert cfg.inference_batch_size == jcfg.inference_batch_size
    kw = cfg.agent_kwargs(10172)
    assert kw["dtype"] == torch.bfloat16 and kw["use_flash"]
    # the flagship: the JAX agent's own defaults
    from bmhrl_tpu.models.bmhrl import BMHrlAgent as JAgent

    flagship = JAgent(voc_size=10172)
    for name in ("d_video", "d_audio", "d_model", "d_model_caps",
                 "att_heads", "att_layers", "d_goal", "d_ff_v", "d_ff_a",
                 "d_ff_c", "critic_score_threshold"):
        assert kw[name] == getattr(flagship, name), name


def test_read_meta_tsv_matches_jax(tmp_path):
    from bmhrl_tpu.serve import read_meta_tsv as jread
    from bmhrl_tpu_torch.serve import read_meta_tsv

    path = tmp_path / "meta.csv"
    path.write_text("video_id\tcaption\tstart\tend\tduration\n"
                    "v1\ta dog runs\t0.5\t4.25\t10.0\n"
                    "v2\tpeople talk\t3\t9\t12.5\n")
    got = [(r.video_id, r.start, r.end, r.duration)
           for r in read_meta_tsv(str(path))]
    want = [(r.video_id, r.start, r.end, r.duration) for r in jread(str(path))]
    assert got == want == [("v1", 0.5, 4.25, 10.0), ("v2", 3.0, 9.0, 12.5)]
