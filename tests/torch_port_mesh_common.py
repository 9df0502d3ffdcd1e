"""The rank functions of the tests/test_torch_port_mesh*.py files.

``parallel.mesh.spawn`` starts each rank as a new process that unpickles
its function by module and name, so the functions live here: this module
imports torch, numpy and the port only (no JAX), which keeps a rank's
start-up to torch's import. A rank function takes its mesh and global
inputs (numpy, made in the test from a seed), runs the port on its rows
and returns rank 0's view of the result (``gather_rows`` puts every
rank's rows back in the global order)."""
import numpy as np
import torch

from bmhrl_tpu_torch.parallel import mesh as mesh_lib


def local(mesh, x):
    """This rank's rows of a global numpy array, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(x[mesh.rows(len(x))]))


def gathered(mesh, t):
    return mesh_lib.gather_rows(t, mesh).numpy()


def helpers_rank(mesh, cases):
    """Every cross-row helper and the functions built on them, on this
    rank's rows of ``cases``; the global results."""
    from bmhrl_tpu_torch.models.blocks import Draws
    from bmhrl_tpu_torch.ops import segments

    out = {"rank_rows": gathered(mesh, torch.full((2, 3), float(mesh.rank)))}
    for name, (x, m) in cases["expand"].items():
        out[f"expand_{name}"] = gathered(mesh, segments.expand_goals(
            local(mesh, x), local(mesh, m), mesh))
    for name, (x, lab, hb) in cases["frontier"].items():
        out[f"frontier_{name}"] = gathered(mesh, segments.frontier_goal(
            local(mesh, x), local(mesh, lab), local(mesh, hb), mesh))
        out[f"later_{name}"] = gathered(
            mesh, mesh_lib.rows_later_have(local(mesh, hb).bool(), mesh))
        out[f"any_{name}"] = bool(mesh_lib.rows_any(local(mesh, hb).bool(),
                                                    mesh))
    x_full = local(mesh, cases["x_full"])
    for t in (0, 3):
        noise = segments.frontier_exploration_noise(
            x_full, torch.tensor(t), x_full.shape[-1], Draws(7, "cpu", mesh),
            10.0, 5.0, mesh)
        out[f"noise_t{t}"] = noise.numpy()
    out["nanmean"] = float(mesh_lib.global_nanmean(local(mesh,
                                                         cases["nan"]), mesh))
    out["count"] = int(mesh_lib.global_count(local(mesh, cases["nan"]) > 0.5,
                                             mesh))
    d = Draws(11, "cpu", mesh)
    b = len(cases["x_full"]) // mesh.world
    out["keep"] = gathered(mesh, d.keep((b, 5, 3), 0.6))
    out["synonym"] = [gathered(mesh, a) for a in d.synonym((b, 6), 40)]
    out["categorical"] = gathered(mesh, d.categorical(
        local(mesh, cases["logp"])))
    out["normal"] = mesh_lib.gather_rows(d.normal((4,))[None],
                                         mesh).numpy()
    grads = {"a": torch.full((2, 2), 1.0 + mesh.rank), "b": None,
             "c": torch.arange(3.0) * (mesh.rank + 1)}
    red = mesh_lib.all_reduce_grads(grads, mesh)
    out["grads"] = {k: None if v is None else v.numpy()
                    for k, v in red.items()}
    out["done_some"] = mesh_lib.all_done(
        torch.tensor([True, mesh.rank == 0]), mesh)
    out["done_all"] = mesh_lib.all_done(torch.tensor([True, True]), mesh)
    out["shard"] = mesh_lib.shard_batch(
        mesh, {"x": np.arange(8).reshape(4, 2), "s": "keep"})["x"]
    # a broadcast from rank 0 replaces every rank's parameters
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(mesh.rank))
    mesh_lib.replicate(lin, mesh)
    out["replicated"] = gathered(mesh, lin.weight.detach()[None])
    out["collectives"] = dict(mesh_lib.COLLECTIVES)
    return out


# ---- the training steps ---------------------------------------------------------
# small f32 captioners: a few layers, narrow widths
SMALL = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=1,
             rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8, d_vid=24,
             d_aud=20, compute_dtype="float32", rl_critic_path="/nonexistent",
             to_log=False, max_len=6)
VOC = 30
PAD = 1


def small_config(mode="BMHRL", **kw):
    from bmhrl_tpu_torch.config import Config

    return Config(mode=mode, **dict(SMALL, **kw))


def small_model(cfg, captions, seed=5):
    """The captioner of ``cfg.mode`` at SMALL dims on the CPU from
    ``seed``, its critic's output layer set so that about half the segment
    labels of ``captions`` (numpy (B, L)) are boundaries and none lies on
    the threshold."""
    from bmhrl_tpu_torch.train.loop import build_model
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = build_model(cfg, VOC, "cpu")
    load_jax_params(model, random_module_params(model, seed))
    critic = getattr(model, "critic", None)
    if critic is not None:
        with torch.no_grad():
            critic.lin.weight.mul_(10.0)
            critic.lin.bias.mul_(10.0)
            logits = critic(model.emb_C(torch.from_numpy(captions)))
            # the threshold midway between two distinct logits near the
            # median: no label sits on it (a tie there flips with the last
            # bit of the sum, and the two packages round differently)
            u = np.unique(logits.numpy())
            mid = 0.5 * (float(u[len(u) // 2 - 1]) + float(u[len(u) // 2]))
            critic.lin.bias.add_(float(np.log(0.25 / 0.75)) - mid)
    return model


def step_inputs(b=4, seed=0, sv=10, sa=14, lc=7):
    """Numpy features (ragged padding) and captions (b, lc) of one step."""
    rng = np.random.RandomState(seed)
    f = {"rgb": rng.rand(b, sv, SMALL["d_vid"]).astype(np.float32),
         "flow": rng.rand(b, sv, SMALL["d_vid"]).astype(np.float32),
         "audio": rng.rand(b, sa, SMALL["d_aud"]).astype(np.float32)}
    f["rgb"][0, sv - 3:] = f["flow"][0, sv - 3:] = 0.0
    f["audio"][b - 1, sa - 4:] = 0.0
    cap = np.full((b, lc), PAD, np.int64)
    cap[:, 0] = 2
    for i in range(b):
        n = lc - 2 - (i % 3)
        cap[i, 1:1 + n] = rng.randint(4, VOC, n)
        cap[i, 1 + n] = 3
    return f, cap


def value_nets(d: int):
    """The worker and manager value nets of width d from seeds 6 and 7."""
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    return tuple(load_jax_params(cls(d, device="cpu"), random_module_params(
        cls(d, device="meta"), seed))
        for cls, seed in ((BMWorkerValueFunction, 6),
                          (BMManagerValueFunction, 7)))


def _params(*modules):
    return {f"{i}.{n}": p.detach().numpy().copy()
            for i, m in enumerate(modules) for n, p in m.named_parameters()}


def recording_draws(record):
    """A ``Draws`` class that appends every draw, in call order, to the
    lists of ``record`` (dict): "keep" (dropout masks), "normal",
    "synonym" ((u1, u2, words)) and "categorical" (samples)."""
    from bmhrl_tpu_torch.models.blocks import Draws

    class Recording(Draws):
        def _keep(self, kind, x):
            record.setdefault(kind, []).append(
                tuple(a.numpy().copy() for a in x) if isinstance(x, tuple)
                else x.numpy().copy())
            return x

        def keep(self, shape, keep_prob):
            return self._keep("keep", super().keep(shape, keep_prob))

        def normal(self, shape):
            return self._keep("normal", super().normal(shape))

        def synonym(self, shape, voc_size):
            return self._keep("synonym", super().synonym(shape, voc_size))

        def categorical(self, logp):
            return self._keep("categorical", super().categorical(logp))

    return Recording


def step_sequence(mesh, mode, f, cap, scores, lr=1e-3, record=None):
    """Warmstart, value warmstart, an RL worker and an RL manager step and a
    greedy decode of a small ``mode`` captioner on this rank's rows of the
    global batch (f, cap); ``scores`` are the host scores (global). Runs
    with ``mesh=None`` on the whole batch too. Returns losses, tokens
    (global) and parameters: the initial ones (flax trees of the captioner
    and the value nets), after the warmstart and at the end (also the
    captioner's flax tree, "tree"). With
    ``record`` (a dict) every draw of the steps is kept there
    (``recording_draws``)."""
    from bmhrl_tpu_torch.data.vocab import BOS, EOS
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import decode
    from bmhrl_tpu_torch.train.steps import StepFactory
    from bmhrl_tpu_torch.weights import jax_layout_params

    rows = (lambda x: torch.from_numpy(np.ascontiguousarray(x))) \
        if mesh is None else (lambda x: local(mesh, x))
    back = (lambda t: t.numpy()) if mesh is None \
        else (lambda t: gathered(mesh, t))
    cfg = small_config(mode, grad_clip=0.5)
    model = small_model(cfg, cap[:, :-1])
    wv, mv = value_nets(cfg.d_model_caps)
    for net in (model, wv, mv):
        mesh_lib.replicate(net, mesh)
    sf = StepFactory(cfg, model, wv, mv, emb_trainable=True, mesh=mesh)
    if record is not None:
        cls = recording_draws(record)
        sf.draws = lambda seed: cls(seed, sf.device, mesh)
    state = sf.init_state()
    batch = {k: rows(v) for k, v in f.items()}
    batch["caption_idx"] = rows(cap)
    out = {"init": tuple(jax_layout_params(net) for net in (model, wv, mv))}
    state, m, aux = sf.warmstart_step(state, batch, 1, lr)
    out["warmstart_loss"] = float(m["loss"])
    out["n_tokens"] = int(m["n_tokens"])
    out["seg"] = back(aux["seg"])
    out["argmax"] = back(aux["argmax"])
    out["ws_params"] = _params(model)
    state, vm = sf.value_warmstart_step(
        state, aux["wf"], aux["mf"], rows(scores[0]), rows(scores[1]),
        aux["token_mask"], aux["seg"])
    out["wv_loss"], out["mv_loss"] = float(vm["wv_loss"]), float(vm["mv_loss"])
    for name, tw, seed in (("worker", True, 2), ("manager", False, 3)):
        roll = sf.rl_rollout(state, batch, seed, tw)
        out[f"sampled_{name}"] = back(roll["sampled"])
        out[f"seg_{name}"] = back(roll["seg"])
        state, m2 = sf.rl_update(state, batch, seed, lr, roll,
                                 rows(scores[2]), tw)
        out[f"rl_{name}_loss"] = float(m2["loss"])
        out[f"rl_{name}_value_loss"] = float(m2["value_loss"])
    feats = {k: batch[k] for k in ("rgb", "flow", "audio")}
    toks, _ = decode(model, feats, make_masks(feats), cfg.max_len, BOS, EOS,
                     PAD)
    out["decode_tokens"] = back(toks)
    out["params"] = _params(model, wv, mv)
    out["tree"] = jax_layout_params(model)
    out["collectives"] = dict(mesh_lib.COLLECTIVES)
    return out


def steps_rank(mesh, modes, f, cap, scores):
    return {mode: step_sequence(mesh, mode, f, cap, scores)
            for mode in modes}


def detr_sequence(mesh, f, cap, score, pre_goal, lr=1e-4):
    """A DETR training step (rollout, the host's Hungarian matching on the
    rank's rows, the update) and a ``--with_reinforce`` update of a small
    f32 DETR captioner on this rank's rows (``mesh=None``: the whole
    batch), at the captioner's default LR (the one-process DETR update
    test's). Returns losses, the samples (global) and the parameters."""
    from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory

    rows = (lambda x: torch.from_numpy(np.ascontiguousarray(x))) \
        if mesh is None else (lambda x: local(mesh, x))
    back = (lambda t: t.numpy()) if mesh is None \
        else (lambda t: gathered(mesh, t))
    cfg = small_config("DETR", pre_goal_attention=pre_goal, grad_clip=0.5)
    model = small_model(cfg, cap[:, :-1])
    wv, mv = value_nets(cfg.d_model_caps)
    for net in (model, wv, mv):
        mesh_lib.replicate(net, mesh)
    sf = DetrStepFactory(cfg, model, wv, mv, emb_trainable=True, mesh=mesh)
    state = sf.init_state()
    batch = {k: rows(v) for k, v in f.items()}
    batch["caption_idx"] = rows(cap)
    roll = sf.detr_rollout(state, batch, 1)
    tc = sf.match_targets(roll["pred_classes"], roll["x_idx"])
    state, m = sf.detr_update(state, batch, 1, lr, roll["sampled"],
                              rows(score), torch.from_numpy(tc))
    out = {k: float(v) for k, v in m.items()}
    out["sampled"] = back(roll["sampled"])
    out["targets"] = back(torch.from_numpy(tc))
    roll = sf.detr_rollout(state, batch, 2)
    state, m = sf.reinforce_update(state, batch, 2, lr, roll["sampled"],
                                   rows(score))
    out["reinforce_loss"] = float(m["loss"])
    out["params"] = _params(model, wv)
    return out


def detr_rank(mesh, f, cap, score):
    return {pg: detr_sequence(mesh, f, cap, score, pg)
            for pg in (False, True)}


# ---- serving ---------------------------------------------------------------------
def serve_rank(mesh, dims, tree, cfg_fields, itos, runs):
    """``CaptionServer`` on this rank for each (options, requests) of
    ``runs``; returns rank 0's (submission, stats summary, the global
    "sample" uniforms the server drew)."""
    from bmhrl_tpu_torch import serve as serve_mod
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.models.blocks import Draws
    from bmhrl_tpu_torch.weights import load_jax_params

    class Recording(Draws):
        """Draws that keep the global uniforms of the "sample" stream."""

        def __init__(self, seed, device, mesh):
            super().__init__(seed, device, mesh)
            self.drawn = []

        def _draw(self, fn, stream, *args):
            x = super()._draw(fn, stream, *args)
            if stream == "sample":
                self.drawn.append(x.numpy().copy())
            return x

    model = load_jax_params(BMHrlAgent(**dims, dtype=torch.float32,
                                       device="cpu"), tree)
    model.eval().requires_grad_(False)
    out = []
    for opts, reqs in runs:
        made = []
        serve_mod.Draws = lambda seed, device, mesh: made.append(
            Recording(seed, device, mesh)) or made[-1]
        server = serve_mod.CaptionServer(
            Config(**cfg_fields), model, itos, device="cpu", mesh=mesh,
            **opts)
        got, stats = server.caption(
            [serve_mod.ClipRequest(*r, 10.0) for r in reqs], batch_size=4,
            io_threads=2)
        out.append((got, stats.summary(), made[0].drawn if made else []))
    return out


# ---- serving AOT bundles -------------------------------------------------------
def recorded_log_probs(log):
    """Patches of the decode's host loops (``train.decode``'s, which the
    live server reaches, its greedy token and ``serve_export``'s names of
    the loops) whose step functions append each token's log-probs to
    ``log``."""
    from contextlib import ExitStack
    from unittest import mock

    from bmhrl_tpu_torch import serve_export
    from bmhrl_tpu_torch.train import decode

    def recorded(step_fn):
        def step(*a):
            logits, caches = step_fn(*a)
            log.append(logits.clone())
            return logits, caches

        return step

    def recording(loop):
        def run(caches, valid, step_fn, *args, **kw):
            return loop(caches, valid, recorded(step_fn), *args, **kw)

        return run

    def recording_token(token):
        def run(state, step, *args):
            return token(state, recorded(step), *args)

        return run

    stack = ExitStack()
    for name in ("_fast_loop", "_beam_fast_loop"):
        loop = recording(getattr(decode, name))
        for module in (decode, serve_export):
            stack.enter_context(mock.patch.object(module, name, loop))
    stack.enter_context(mock.patch.object(
        decode, "greedy_token", recording_token(decode.greedy_token)))
    return stack


def alone_on(rank, mesh):
    """A patch of ``cross_flags`` under which ``rank`` still takes part in
    the exchange but feeds its body the flags of a batch held whole
    (``serve_export._alone_flags``): a fault the log-probs must show."""
    from contextlib import nullcontext
    from unittest import mock

    from bmhrl_tpu_torch.serve_export import _alone_flags

    if mesh.rank != rank:
        return nullcontext()
    exchange = mesh_lib.cross_flags

    def cross_flags(flag, mesh=None):
        exchange(flag, mesh)
        return _alone_flags(flag.device)

    return mock.patch.object(mesh_lib, "cross_flags", cross_flags)


def bundle_serve_rank(mesh, runs, reqs, batch_size=4):
    """For each run of ``runs`` the server on this rank serving ``reqs``
    (a list of ``serve.ClipRequest``) at ``batch_size``: ("bundle", dir,
    video_dir, audio_dir) an ``ExportedCaptionServer`` of that bundle
    (("bundle", dir, video_dir, audio_dir, r): with rank r's body fed the
    flags of a batch held whole, ``alone_on``), ("live", cfg_fields,
    voc_size, tree, itos, options) a ``CaptionServer`` of the model of
    ``Config(**cfg_fields)`` with the flax-layout ``tree`` (fixed batch
    shapes, as the bundle's). Returns rank 0's list of (submission, stats
    summary, all_reduce calls of the serve, every rank's load seconds or
    None, every rank's log-probs of every token (world, n) in the order
    the loops made them)."""
    from contextlib import nullcontext

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.serve import CaptionServer
    from bmhrl_tpu_torch.serve_export import ExportedCaptionServer
    from bmhrl_tpu_torch.train.loop import build_model
    from bmhrl_tpu_torch.weights import load_jax_params

    out = []
    for run in runs:
        load_s, fault = None, nullcontext()
        if run[0] == "bundle":
            server = ExportedCaptionServer(*run[1:4], device="cpu",
                                           mesh=mesh)
            load_s = gathered(mesh, torch.tensor([server.load_s])).tolist()
            if len(run) > 4:
                fault = alone_on(run[4], mesh)
        else:
            fields, voc, tree, itos, opts = run[1:]
            cfg = Config(**fields)
            model = load_jax_params(build_model(cfg, voc, "cpu"), tree)
            model.eval().requires_grad_(False)
            server = CaptionServer(cfg, model, itos, device="cpu", mesh=mesh,
                                   **opts)
            server._fixed_batch = True
        log = []
        mesh_lib.reset_collectives()
        with recorded_log_probs(log), fault:
            got, stats = server.caption(reqs, batch_size=batch_size,
                                        io_threads=2)
        calls = mesh_lib.COLLECTIVES["all_reduce"]
        flat = torch.cat([x.reshape(-1) for x in log])
        out.append((got, stats.summary(), calls, load_s,
                    gathered(mesh, flat[None])))
    return out
