"""Shared set-up of the tests/test_torch_port_detr_*.py files: small DETR
dims that still reach the flash gate (d_k = 256 / 2 = 128, Sv = 128) and
an even temporal kernel (n_time = 2: kernels 3 and 6), one random
flax-layout tree per variant, loaded into both packages.

JAX runs with flash attention off (its plain XLA attention, f32): the
port's flash plain version is held to the same function, and the Pallas
interpret mode would cost minutes here. The detector (ObjectDetect) is
fixed at width 256, 6 + 6 layers, as in the JAX package."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_common import features, to_torch

VOC = 40
DIMS = dict(voc_size=VOC, d_model=256, d_model_caps=32, d_goal=16, nhead=2,
            num_layers=2, n_time=2, dim_ff=64)
D_VIDEO = 128
B, SV, SA, MAX_LEN = 3, 128, 160, 8
PAD, BOS, EOS = 1, 2, 3


def dims(pre_goal=False, dout_p=0.1):
    return dict(DIMS, pre_goal_attention=pre_goal, dout_p=dout_p)


def port_tree(pre_goal=False, seed=3):
    from bmhrl_tpu_torch.weights import random_jax_layout_params

    return random_jax_layout_params(dict(dims(pre_goal), d_video=D_VIDEO),
                                    seed=seed)


def torch_detr(tree, pre_goal=False, dout_p=0.1):
    from bmhrl_tpu_torch.models.detr import DetrCaption
    from bmhrl_tpu_torch.weights import load_jax_params

    model = DetrCaption(**dims(pre_goal, dout_p), d_video=D_VIDEO,
                        dtype=torch.float32, device="cpu")
    return load_jax_params(model, tree).requires_grad_(False)


def jax_detr(pre_goal=False, dout_p=0.1):
    from bmhrl_tpu.models.detr import DetrCaption

    return DetrCaption(**dims(pre_goal, dout_p), dtype=jnp.float32)


def detr_features(seed=0, b=B, distinct=False):
    """Features at the DETR's video width, a padded tail in row 0. With
    ``distinct`` each clip's frames get a pattern of its own: uniform
    noise averages to the same memory in every clip, and a random model
    then captions every clip alike."""
    f = features(seed=seed, b=b, sv=SV, sa=SA, dv=D_VIDEO, da=128)
    if distinct:
        rng = np.random.RandomState(seed + 100)
        for i in range(b):
            valid = f["rgb"][i, :, 0] != 0
            f["rgb"][i, valid] += 3.0 * rng.randn(D_VIDEO).astype(np.float32)
    return f


def captions(seed=1, b=B, length=MAX_LEN):
    """(b, length) ids: <s>, words, </s>, pad, one row per length."""
    rng = np.random.RandomState(seed)
    cap = np.full((b, length), PAD, np.int64)
    cap[:, 0] = BOS
    for i in range(b):
        n = length - 2 - 2 * i
        cap[i, 1:1 + n] = rng.randint(4, VOC, n)
        cap[i, 1 + n] = EOS
    return cap


def both_inputs(f, cap=None):
    """(port V, A, masks), (JAX V, A, masks) of numpy features, with the
    caption mask when ``cap`` is given."""
    from bmhrl_tpu.ops.masking import make_masks as jmake_masks
    from bmhrl_tpu_torch.ops.masking import make_masks

    tf = to_torch(f)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tcap = None if cap is None else torch.from_numpy(cap)
    jcap = None if cap is None else jnp.asarray(cap)
    tm = make_masks(tf, tcap)
    jm = jmake_masks({"rgb": jf["rgb"], "audio": jf["audio"]}, jcap,
                     "audio_video", PAD)
    return ((tf["rgb"] + tf["flow"], tf["audio"], tm),
            (jf["rgb"] + jf["flow"], jf["audio"], jm))


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---- one training step, port vs JAX (test_torch_port_detr_{train,loop}) ----
D_CAPS = DIMS["d_model_caps"]
STEP_LR = 1e-4  # the default captioner LR (rl_cap_lr)
STEP_CFG = dict(grad_clip=0.5, rl_stabilize=True)


def step_setup():
    """Trees, one batch, its sampled tokens, scores and Hungarian targets,
    the JAX key and the synonym draws it makes."""
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.weights import random_module_params
    from torch_port_train_common import (RecordingDraws, jax_synonym_draws,
                                         port_batch)

    tree = port_tree(seed=11)
    wv = random_module_params(BMWorkerValueFunction(D_CAPS, device="meta"), 6)
    mv = random_module_params(BMManagerValueFunction(D_CAPS, device="meta"),
                              7)
    f = detr_features(seed=4, distinct=True)
    cap = captions(seed=5, length=MAX_LEN + 1)
    key = jax.random.PRNGKey(3)
    syn = jax_synonym_draws(jax.random.split(key, 5)[1], (B, MAX_LEN), VOC)
    rng = np.random.RandomState(8)
    sampled = rng.randint(2, VOC, (B, MAX_LEN)).astype(np.int32)
    score = rng.rand(B, MAX_LEN).astype(np.float32)
    sf, state = port_steps((tree, wv, mv))
    roll = sf.detr_rollout(state, port_batch(f, cap), 0,
                           draws=RecordingDraws(synonym=syn))
    tc = sf.match_targets(roll["pred_classes"], roll["x_idx"])
    return dict(trees=(tree, wv, mv), f=f, cap=cap, key=key, syn=syn,
                sampled=sampled, score=score, tc=tc)


def port_steps(trees):
    """The port's DetrStepFactory (dropout 0) over ``trees`` and its state."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory
    from bmhrl_tpu_torch.weights import load_jax_params

    tree, wv_tree, mv_tree = trees
    wv = load_jax_params(BMWorkerValueFunction(D_CAPS, device="cpu"),
                         wv_tree)
    mv = load_jax_params(BMManagerValueFunction(D_CAPS, device="cpu"),
                         mv_tree)
    sf = DetrStepFactory(Config(to_log=False, **STEP_CFG),
                         torch_detr(tree, dout_p=0.0), wv, mv,
                         emb_trainable=True)
    return sf, sf.init_state()


def jax_steps(trees):
    """The JAX package's DetrStepFactory over ``trees`` and a TrainState
    built from them (no ``init``)."""
    from bmhrl_tpu.config import Config as JConfig
    from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
    from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
    from bmhrl_tpu.train.steps import TrainState
    from bmhrl_tpu.train.steps_detr import DetrStepFactory

    tree, wv, mv = (jax_tree(t) for t in trees)
    sf = DetrStepFactory(JConfig(to_log=False, mesh_shape=(1, 1),
                                 **STEP_CFG),
                         jax_detr(dout_p=0.0), JWV(D_CAPS, 0.0),
                         JMV(D_CAPS, 0.0), emb_trainable=True)
    state = TrainState(cap_params=tree, wv_params=wv, mv_params=mv,
                       cap_opt=sf.cap_optim.init(tree),
                       wv_opt=sf.val_optim.init(wv),
                       mv_opt=sf.val_optim.init(mv))
    return sf, state


def check_update_matches_jax(update):
    """One ``update`` step ("detr_update" or "reinforce_update") of both
    packages from the same state and inputs: losses within rtol 1e-5,
    every captioner and worker value parameter within 1e-5; the caption
    losses move the encoder, the word loss alone the detector."""
    from torch_port_common import jax_kernels
    from torch_port_train_common import (RecordingDraws, assert_params_close,
                                         leaf_pairs, port_batch)

    s = step_setup()
    sf, state = port_steps(s["trees"])
    jsf, jstate = jax_steps(s["trees"])
    batch = port_batch(s["f"], s["cap"])
    jbatch = {k: jnp.asarray(v) for k, v in s["f"].items()}
    jbatch["caption_idx"] = jnp.asarray(s["cap"])
    args = [torch.from_numpy(s["sampled"]), torch.from_numpy(s["score"])]
    jargs = [jnp.asarray(s["sampled"]), jnp.asarray(s["score"])]
    if update == "detr_update":
        args.append(torch.from_numpy(s["tc"]))
        jargs.append(jnp.asarray(s["tc"]))
    state, m = getattr(sf, update)(state, batch, 0, STEP_LR, *args,
                                   draws=RecordingDraws(synonym=s["syn"]))
    with jax_kernels(flash=False):
        jstate, jm = getattr(jsf, update)(jstate, jbatch, s["key"], STEP_LR,
                                          *jargs)
    assert m.keys() == jm.keys()
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert_params_close(sf.model, jstate.cap_params, 1e-5)
    assert_params_close(sf.wv_model, jstate.wv_params, 1e-5)
    moved = {n.split("/")[0] for n, g, w in leaf_pairs(
        sf.model, s["trees"][0]) if not np.array_equal(g, w)}
    assert "encoder" in moved
    assert ("object_detector" in moved) == (update == "detr_update")


# ---- serving from a port checkpoint (test_torch_port_{leftovers,detr_loop})
SERVE = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=2,
             rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8, d_vid=128,
             d_aud=128, caption_buckets=(16,), rl_critic_path="/nonexistent")


def serve_argv(corpus, out, *extra):
    return ["--meta", corpus["val_1"],
            "--video_features_path", corpus["video_features_path"],
            "--audio_features_path", corpus["audio_features_path"],
            "--train_meta_path", corpus["train"], "--compute_dtype",
            "float32", "--batch_size", "4", "--max_len", "8",
            "--config_json", json.dumps(SERVE), "--device", "cpu",
            "--out", out, *extra]


def port_checkpoint(corpus, mode, root, seed):
    """A port checkpoint of random ``mode`` weights (what a training run
    writes), and the model."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.train.loop import build_model
    from bmhrl_tpu_torch.train.optim import GatedAdam
    from bmhrl_tpu_torch.train.steps import TrainState
    from bmhrl_tpu_torch.utils.checkpoint import save_checkpoint
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    cfg = Config(mode=mode, compute_dtype="float32", to_log=False, **SERVE)
    voc = len(build_vocab_from_tsv(corpus["train"]))
    model = build_model(cfg, voc, "cpu")
    load_jax_params(model, random_module_params(model, seed))
    wv = BMWorkerValueFunction(cfg.d_model_caps, device="cpu")
    mv = BMManagerValueFunction(cfg.d_model_caps, device="cpu")
    opt = GatedAdam()
    state = TrainState(*(opt.init(dict(m.named_parameters()))
                         for m in (model, wv, mv)))
    path = save_checkpoint(str(root / "checkpoints" / "E_0"), model,
                                 wv, mv, state)
    return path, cfg, model.eval().requires_grad_(False)
