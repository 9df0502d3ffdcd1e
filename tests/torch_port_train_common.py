"""Shared set-up of the tests/test_torch_port_train_*.py files: the draws
of one port forward recorded and fed to the JAX package, and the map
between the port's parameters and the flax tree.

Dropout masks and exploration normals are drawn by the port (a recording
``Draws``) and handed to JAX: ``nn.intercept_methods`` replaces each flax
``Dropout`` call, in call order, by the port's mask with flax's own
arithmetic, and ``jax.random.normal`` returns the port's normals while the
JAX forward is traced. Nothing in the JAX package changes."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from torch_port_common import DIMS, features, to_torch

from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.weights import _flax_paths


class RecordingDraws(Draws):
    """Draws from generators (on the CPU) that keeps every dropout mask and
    exploration normal, in order; synonym draws and samples may be fed."""

    def __init__(self, seed=0, synonym=None, sampled=None):
        super().__init__(seed, "cpu")
        self.keeps, self.normals = [], []
        self._synonym, self._sampled = synonym, sampled

    def keep(self, shape, keep_prob):
        k = super().keep(shape, keep_prob)
        self.keeps.append(k.numpy())
        return k

    def normal(self, shape):
        n = super().normal(shape)
        self.normals.append(n.numpy())
        return n

    def synonym(self, shape, voc_size):
        if self._synonym is None:
            return super().synonym(shape, voc_size)
        return tuple(torch.from_numpy(np.asarray(a)) for a in self._synonym)

    def categorical(self, logp):
        if self._sampled is None:
            return super().categorical(logp)
        return torch.from_numpy(np.array(self._sampled)).long()


@contextlib.contextmanager
def fed_draws(keeps, normals):
    """Inside: every flax Dropout call that would draw takes the next of
    ``keeps`` (shapes must agree) and ``jax.random.normal`` returns the next
    of ``normals``. Use while tracing the JAX forward; all must be used."""
    keeps, normals = list(keeps), list(normals)

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = fnn.merge_param("deterministic", mod.deterministic,
                              kwargs.get("deterministic"))
        if mod.rate == 0.0 or det:
            return x
        keep = keeps.pop(0)
        assert keep.shape == x.shape, (keep.shape, x.shape)
        return jax.lax.select(jnp.asarray(keep), x / (1.0 - mod.rate),
                              jnp.zeros_like(x))

    def normal(key, shape, dtype=jnp.float32):
        z = jnp.asarray(normals.pop(0), dtype)
        assert z.shape == tuple(shape)
        return z

    with fnn.intercept_methods(interceptor), \
            mock.patch.object(jax.random, "normal", normal):
        yield
    assert not keeps and not normals, (len(keeps), len(normals))


def port_to_tree(model):
    """The flax tree ``{"params": ...}`` of a port module's parameters."""
    tree = {}
    for path, p, transposed in _flax_paths(model):
        a = p.detach().float().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.T if transposed else a
    return {"params": tree}


def leaf_pairs(model, tree):
    """(name, port array in the flax layout, JAX array) for every
    parameter."""
    got = port_to_tree(model)["params"]
    out = []
    for path, _, _ in _flax_paths(model):
        g, w = got, tree["params"]
        for k in path:
            g, w = g[k], w[k]
        out.append(("/".join(path), g, np.asarray(w)))
    return out


def mixed_label_tree(tree, captions, scale=10.0):
    """``tree`` with the critic's output layer scaled and shifted so that
    about half the segment labels of ``captions`` (B, L) are boundaries
    (random weights put every sigmoid near 0.47, all above the 0.25
    threshold)."""
    from torch_port_common import torch_agent

    tree = jax.tree.map(np.array, tree)
    lin = tree["params"]["critic"]["lin"]
    lin["kernel"] = lin["kernel"] * scale
    lin["bias"] = lin["bias"] * scale
    model = torch_agent(tree)
    with torch.no_grad():
        logits = model.critic(model.emb_C(torch.as_tensor(captions)))
    logit_thr = np.log(0.25 / 0.75)
    lin["bias"] = lin["bias"] + (logit_thr
                                 - float(np.median(logits.numpy())))
    return tree


def caption_batch(seed, b, length, voc, lens=None):
    """(b, length) caption ids: <s>, random words, </s>, pad."""
    rng = np.random.RandomState(seed)
    cap = np.full((b, length), 1, np.int64)
    cap[:, 0] = 2
    for i in range(b):
        n = length - 2 - i if lens is None else lens[i]
        cap[i, 1:1 + n] = rng.randint(4, voc, n)
        cap[i, 1 + n] = 3
    return cap


def jax_synonym_draws(key, shape, voc_size):
    """The draws ``bmhrl_tpu.train.steps.synonym_noise(key, ...)`` makes,
    split as it splits its key."""
    r1, r2, r3 = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(r1, shape)),
            np.array(jax.random.uniform(r2, shape)),
            np.array(jax.random.randint(r3, shape, 2, voc_size)))


def assert_params_close(model, jax_params, tol):
    """Every parameter of a port module within ``tol`` (absolute) of the
    flax tree's leaf."""
    for name, got, want in leaf_pairs(model, jax_params):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)


# ---- the step tests' set-up ----------------------------------------------------
PAD = 1
LC = 9  # caption buffer: x_idx and y_idx are 8 long
VOC = DIMS["voc_size"]
D = DIMS["d_model_caps"]


def step_batch(seed):
    """(numpy features, captions (3, LC)) of one step."""
    return features(seed=seed), caption_batch(seed + 10, 3, LC, VOC)


def train_trees():
    """(captioner, worker value, manager value) flax trees; the critic's
    output layer set so that the step batches have mixed labels."""
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.weights import (random_jax_layout_params,
                                         random_module_params)

    _, cap = step_batch(0)
    tree = mixed_label_tree(random_jax_layout_params(DIMS, seed=5),
                            cap[:, :-1])
    wv = random_module_params(BMWorkerValueFunction(D, device="meta"), 6)
    mv = random_module_params(BMManagerValueFunction(D, device="meta"), 7)
    return tree, wv, mv


def port_setup(trees, cfg):
    """A port StepFactory on the CPU over fresh modules loaded from
    ``trees``, and its initial state."""
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.train.steps import StepFactory
    from bmhrl_tpu_torch.weights import load_jax_params
    from torch_port_common import torch_agent

    tree, wv_tree, mv_tree = trees
    wv = load_jax_params(BMWorkerValueFunction(D, device="cpu"), wv_tree)
    mv = load_jax_params(BMManagerValueFunction(D, device="cpu"), mv_tree)
    sf = StepFactory(cfg, torch_agent(tree), wv, mv, emb_trainable=True)
    return sf, sf.init_state()


def port_batch(f, cap):
    b = to_torch(f)
    b["caption_idx"] = torch.from_numpy(cap)
    return b


def jax_inputs(f, cap, key):
    """V, A, noised x_idx, y_idx and masks as the JAX step's ``_prep``
    makes them from ``key``, and the synonym draws it took."""
    from bmhrl_tpu.ops.masking import make_masks
    from bmhrl_tpu.train.steps import synonym_noise

    x_idx, y_idx = jnp.asarray(cap[:, :-1]), jnp.asarray(cap[:, 1:])
    syn = jax_synonym_draws(key, x_idx.shape, VOC)
    x_idx = synonym_noise(key, x_idx, VOC)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    masks = make_masks({"rgb": jf["rgb"], "audio": jf["audio"]}, x_idx,
                       "audio_video", PAD)
    return (jf["rgb"] + jf["flow"], jf["audio"], x_idx, y_idx, masks), syn


def jax_rl_steps(model, wv, mv, cfg):
    """rl_rollout and rl_update of the JAX package's StepFactory for the
    flax agent ``model``, composed from the package's functions (the
    forward with fed draws, the biased KL, ``GatedAdam`` under the phase's
    ``phase_mask``, the value-net regression), jitted."""
    from bmhrl_tpu.ops import segments as jseg
    from bmhrl_tpu.train import losses as JL
    from bmhrl_tpu.train import optim as joptim
    from bmhrl_tpu.train.steps import LOSS_FACTOR
    from bmhrl_tpu.train.steps import param_groups as jparam_groups
    from bmhrl_tpu.train.steps import phase_mask as jphase_mask

    def forward(params, inputs, keeps, normals, train_worker):
        V, A, x_idx, _, masks = inputs
        with fed_draws(keeps, normals):
            return model.apply(params, (V, A), x_idx, masks,
                               exploration=not train_worker,
                               deterministic=False,
                               rngs={"noise": jax.random.PRNGKey(0),
                                     "dropout": jax.random.PRNGKey(0)})

    def rollout(params, wv_p, mv_p, inputs, keeps, normals, r_samp,
                train_worker):
        pred, wf, mf, goals, seg = jax.lax.stop_gradient(
            forward(params, inputs, keeps, normals, train_worker))
        if train_worker:
            sampled = jax.random.categorical(r_samp, pred, axis=-1)
        else:
            sampled = jnp.argmax(pred, axis=-1)
        sampled = sampled.astype(jnp.int32)
        probs = jnp.take_along_axis(jnp.exp(pred), sampled[..., None],
                                    axis=-1)[..., 0]
        ev = (wv.apply(wv_p, (wf, goals)) if train_worker
              else mv.apply(mv_p, mf))[..., 0]
        return {"sampled": sampled, "sampled_probs": probs,
                "expected_value": ev, "seg": seg,
                "loss_mask": inputs[3] != PAD}

    def update(params, v_p, opt, v_opt, inputs, keeps, normals, lr, roll,
               score, train_worker):
        y_idx = inputs[3]
        loss_mask = y_idx != PAD
        n_tokens = loss_mask.sum()
        Lc = y_idx.shape[1]
        sampled, sampled_probs = roll["sampled"], roll["sampled_probs"]
        expected_value, seg0 = roll["expected_value"], roll["seg"]
        if train_worker:
            norm_factor = loss_mask.sum(-1, keepdims=True).astype(
                jnp.float32)
        else:
            norm_factor = seg0.sum(-1, keepdims=True).astype(jnp.float32)
            score = score * seg0.astype(jnp.float32)
            log_p = jnp.log(jnp.clip(sampled_probs, 1e-30))
            sampled_probs = jnp.exp(jseg.segment_sum_expand(log_p, seg0))
            nb = jseg.next_boundary(seg0)
            sampled_probs = jnp.where(nb < Lc, sampled_probs, 0.0)
            expected_value = jseg.segment_sum_expand(expected_value, seg0)
        if cfg.rl_stabilize:
            score = (score - expected_value) * loss_mask.astype(jnp.float32)
        amplitude = jnp.clip(score * sampled_probs * norm_factor, 0.0, 1.0)

        def cap_loss_fn(p):
            pred, wf, mf, goals, seg = forward(p, inputs, keeps, normals,
                                               train_worker)
            div = JL.biased_kl(pred, y_idx, sampled, amplitude, 0.7, PAD)
            return jnp.sum(div) / (n_tokens * LOSS_FACTOR), (wf, mf)

        (cap_loss, (wf, mf)), grads = jax.value_and_grad(
            cap_loss_fn, has_aux=True)(params)
        phase = "worker" if train_worker else "manager"
        mask = jphase_mask(jparam_groups(params), phase, True)
        params, opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], cfg.eps,
                                       cfg.weight_decay).update(
            grads, opt, params, mask, lr)
        vmask = (loss_mask if train_worker else seg0).astype(jnp.float32)
        net, feat = (wv, (wf, None)) if train_worker else (mv, mf)
        v_l, v_g = jax.value_and_grad(lambda p: JL.masked_mse(
            net.apply(p, feat)[..., 0], score, vmask))(v_p)
        v_p, v_opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], 1e-8,
                                      0.0).update(
            v_g, v_opt, v_p, True, cfg.rl_value_function_lr)
        return params, v_p, cap_loss, v_l, jnp.sum(score)

    return {"rollout": jax.jit(rollout, static_argnums=7),
            "update": jax.jit(update, static_argnums=10)}
