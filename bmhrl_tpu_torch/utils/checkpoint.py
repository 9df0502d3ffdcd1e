"""Checkpoints of the port's training state, and the reference's torch
files (the port of bmhrl_tpu/utils/checkpoint.py):

- ``save_checkpoint`` / ``load_checkpoint``: the captioner's parameters,
  both value nets' and the three ``GatedAdam`` states of
  ``train.steps.TrainState``, one ``torch.save`` file per component in a
  directory (the training loop's ``.../checkpoints/E_{n}/``);
- ``load_model_params``: a checkpoint's captioner parameters alone, for
  the serving CLIs' ``--checkpoint_dir``;
- ``save_proposal_checkpoint`` / ``load_proposal_checkpoint``: the
  proposal generator's parameters, Adam state and step (``props.pt``,
  ``cli.train_proposals``'s best-F1 checkpoint; ``anchors.npy`` lies
  beside it);
- ``load_torch_critic`` / ``install_critic`` / ``export_torch_critic``:
  the reference's pretrained segment critic (``critic.cp``), which
  ``cli.train_critic`` writes;
- ``import_torch_bmhrl`` / ``export_torch_bmhrl``: the reference's
  ``bm_hrl_agent.pt`` state dict <-> the flax-layout weight tree, which
  goes into the port's ``BMHrlAgent`` through ``weights.load_jax_params``;
- ``export_torch_unimodal`` / ``export_torch_detr``: an AHRL/VHRL or DETR
  captioner (or its flax-layout tree) -> the reference's
  ``unimodal_hrl_agent.pt`` / ``detr_agent.pt`` state dict, dead
  parameters included (neither package imports these files).

Orbax checkpoints (the JAX package's own format) are out of reach here:
orbax imports JAX. A directory that holds one is refused with a message;
the JAX package's ``export_torch_bmhrl`` writes a captioner's weights as a
``.pt``."""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

# the files of a port checkpoint, one per component
COMPONENTS = ("cap_params", "wv_params", "mv_params", "cap_opt", "wv_opt",
              "mv_opt")
# the proposal generator's checkpoint: one file, named as the JAX CLI's
# orbax directory; anchors.npy lies beside it
PROPOSAL_NAME = "props"
ORBAX_MESSAGE = ("{} holds a checkpoint of the JAX package (orbax), which "
                 "the port cannot read: {}")
_ORBAX_REMEDY = {
    "state": "export its weights as a reference .pt with "
             "bmhrl_tpu.utils.checkpoint.export_torch_bmhrl",
    PROPOSAL_NAME: "train the proposal generator with "
                   "bmhrl_tpu_torch.cli.train_proposals"}


def refuse_orbax(ckpt_dir: str, name: str = "state") -> None:
    """Exit with a message when ``ckpt_dir`` is not a port checkpoint: of
    the training state (``name`` "state", the JAX package's orbax name for
    it) or of the proposal generator (``PROPOSAL_NAME``)."""
    files = COMPONENTS if name == "state" else (name,)
    if not all(os.path.exists(os.path.join(ckpt_dir, f"{c}.pt"))
               for c in files):
        raise SystemExit(
            ORBAX_MESSAGE.format(ckpt_dir, _ORBAX_REMEDY[name])
            if os.path.isdir(os.path.join(ckpt_dir, name))
            else f"{ckpt_dir} is not a checkpoint of the port")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def save_checkpoint_on_main(ckpt_dir: str, model, wv_model, mv_model,
                            state, mesh=None) -> str:
    """``save_checkpoint`` from rank 0 of a data-parallel ``mesh`` (the
    ranks hold one replica), between two barriers: every rank has finished
    the step before, and finds the files complete after. Without a mesh,
    ``save_checkpoint``."""
    ranks = mesh is not None and mesh.world > 1
    if ranks:
        mesh.barrier()
    if not ranks or mesh.is_main:
        save_checkpoint(ckpt_dir, model, wv_model, mv_model, state)
    if ranks:
        mesh.barrier()
    return ckpt_dir


def save_checkpoint(ckpt_dir: str, model, wv_model, mv_model, state) -> str:
    """Write the modules' parameters and ``state`` (a ``TrainState``) into
    ``ckpt_dir``; returns it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    parts = {f"{k}_params": {n: _cpu(p) for n, p in m.named_parameters()}
             for k, m in (("cap", model), ("wv", wv_model),
                          ("mv", mv_model))}
    for k in ("cap", "wv", "mv"):
        opt = getattr(state, f"{k}_opt")
        parts[f"{k}_opt"] = {
            "count": dict(opt.count),
            "mu": {n: _cpu(v) for n, v in opt.mu.items()},
            "nu": {n: _cpu(v) for n, v in opt.nu.items()}}
    for name, obj in parts.items():
        tmp = os.path.join(ckpt_dir, f"{name}.pt.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(ckpt_dir, f"{name}.pt"))
    return ckpt_dir


@torch.no_grad()
def load_checkpoint(ckpt_dir: str, model, wv_model, mv_model, state):
    """Copy a checkpoint's parameters into the modules (strict: every name
    and shape) and return its ``TrainState``, on the modules' device, in the
    structure of ``state``."""
    from bmhrl_tpu_torch.train.optim import AdamState

    refuse_orbax(ckpt_dir)
    opts = {}
    for k, m in (("cap", model), ("wv", wv_model), ("mv", mv_model)):
        _copy_params(ckpt_dir, k, _read(ckpt_dir, f"{k}_params"), m)
        opt, like = _read(ckpt_dir, f"{k}_opt"), getattr(state, f"{k}_opt")
        opts[f"{k}_opt"] = AdamState(
            count={n: int(opt["count"][n]) for n in like.count},
            mu={n: opt["mu"][n].to(v.device) for n, v in like.mu.items()},
            nu={n: opt["nu"][n].to(v.device) for n, v in like.nu.items()})
    return state._replace(**opts)


def _read(ckpt_dir: str, name: str):
    return torch.load(os.path.join(ckpt_dir, f"{name}.pt"),
                      map_location="cpu", weights_only=True)


def _copy_params(ckpt_dir: str, what: str, saved: Dict[str, torch.Tensor],
                 module) -> None:
    """Copy ``saved`` into ``module``'s parameters, strict: every name and
    shape."""
    params = dict(module.named_parameters())
    if set(saved) != set(params):
        raise KeyError(f"{ckpt_dir}: {what} parameters differ: "
                       f"{sorted(set(saved) ^ set(params))[:5]}")
    for n, p in params.items():
        if saved[n].shape != p.shape:
            raise ValueError(f"{ckpt_dir}: {what} {n}: checkpoint "
                             f"{tuple(saved[n].shape)} vs model "
                             f"{tuple(p.shape)}")
        p.copy_(saved[n])


@torch.no_grad()
def load_model_params(ckpt_dir: str, model):
    """The captioner's parameters of a port checkpoint (a training run's
    ``.../checkpoints/E_{n}``) copied into ``model``, strict: the serving
    CLIs' ``--checkpoint_dir``. An orbax directory is refused with a
    message. Returns the model."""
    refuse_orbax(ckpt_dir)
    _copy_params(ckpt_dir, "cap", _read(ckpt_dir, "cap_params"), model)
    return model


def save_proposal_checkpoint(ckpt_dir: str, model, state) -> str:
    """Write the proposal generator's parameters and ``state`` (a
    ``train.steps_proposal.ProposalState``: Adam state and step) into
    ``ckpt_dir/props.pt``; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    obj = {"params": {n: _cpu(p) for n, p in model.named_parameters()},
           "opt": {"count": dict(state.opt.count),
                   "mu": {n: _cpu(v) for n, v in state.opt.mu.items()},
                   "nu": {n: _cpu(v) for n, v in state.opt.nu.items()}},
           "step": int(state.step)}
    path = os.path.join(ckpt_dir, f"{PROPOSAL_NAME}.pt")
    torch.save(obj, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)
    return path


@torch.no_grad()
def load_proposal_checkpoint(ckpt_dir: str, model, state):
    """Copy a proposal checkpoint's parameters into ``model`` (strict) and
    return its ``ProposalState`` on the model's device, in the structure
    of ``state``. A JAX CLI's log directory (orbax ``props/``) is refused
    with a message."""
    from bmhrl_tpu_torch.train.optim import AdamState

    refuse_orbax(ckpt_dir, PROPOSAL_NAME)
    saved = _read(ckpt_dir, PROPOSAL_NAME)
    _copy_params(ckpt_dir, PROPOSAL_NAME, saved["params"], model)
    opt, like = saved["opt"], state.opt
    return state._replace(
        opt=AdamState(
            count={n: int(opt["count"][n]) for n in like.count},
            mu={n: opt["mu"][n].to(v.device) for n, v in like.mu.items()},
            nu={n: opt["nu"][n].to(v.device) for n, v in like.nu.items()}),
        step=int(saved["step"]))


def load_torch_critic(path: str) -> Dict[str, Any]:
    """``critic.cp`` (the reference SegmentCritic's state dict) -> the flax
    tree of the critic ``{"params": ...}`` (numpy arrays), which
    ``weights.load_jax_params`` loads into the port's ``SegmentCritic``."""
    sd = _load_state_dict(path)
    out: Dict[str, Any] = {}
    for kind, n in (("lstm", 4), ("gru", 2)):
        for l in range(n):
            out[f"{kind}_l{l}"] = {
                k: sd[f"{kind}.{k}_l{l}"]
                for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    out["lin"] = {"kernel": sd["lin.weight"].T, "bias": sd["lin.bias"]}
    for r in ("relu", "relu2"):
        out[r] = {"alpha": sd[f"{r}.alpha"], "beta": sd[f"{r}.beta"]}
    return {"params": out}


def export_torch_critic(critic, path: str) -> str:
    """The inverse of ``load_torch_critic``: a ``SegmentCritic``'s weights
    -> ``path``, a state dict in the reference's layout (``critic.cp``)."""
    sd = {}
    for kind, n in (("lstm", 4), ("gru", 2)):
        for l in range(n):
            layer = getattr(critic, f"{kind}_l{l}")
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"{kind}.{k}_l{l}"] = _cpu(getattr(layer, k))
    sd["lin.weight"] = _cpu(critic.lin.weight)
    sd["lin.bias"] = _cpu(critic.lin.bias)
    for r in ("relu", "relu2"):
        sd[f"{r}.alpha"] = _cpu(getattr(critic, r).alpha)
        sd[f"{r}.beta"] = _cpu(getattr(critic, r).beta)
    torch.save(sd, path)
    return path


def install_critic(model, critic_path: str):
    """Overwrite the agent's critic with the pretrained weights of
    ``critic_path``; returns the model."""
    from bmhrl_tpu_torch.weights import load_jax_params

    load_jax_params(model.critic, load_torch_critic(critic_path))
    return model

_MHA = ("linear_Q2d", "linear_K2d", "linear_V2d", "linear_d2Q")


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()}


def import_torch_bmhrl(path: str, n_layers: int = 2) -> Dict[str, Any]:
    """A reference ``bm_hrl_agent.pt`` -> the flax tree ``{"params": ...}``
    of ``BMHrlAgent`` with ``n_layers`` encoder and fusion layers (numpy
    arrays). The reference's dead parameters (each fusion layer's unapplied
    feed-forward, ``Manager.core``) are not read."""
    sd = _load_state_dict(path)

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T,
                "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def mha(prefix):
        return {n: dense(f"{prefix}.{n}") for n in _MHA}

    # the plain nn.Embedding key; the GloVe adapter variant uses embedder.0
    emb = ("emb_C.embedder.weight" if "emb_C.embedder.weight" in sd
           else "emb_C.embedder.0.weight")
    p: Dict[str, Any] = {"emb_C": {"embedding": {"embedding": sd[emb]}}}

    crit: Dict[str, Any] = {}
    for kind, n in (("lstm", 4), ("gru", 2)):
        for l in range(n):
            crit[f"{kind}_l{l}"] = {
                k: sd[f"critic.{kind}.{k}_l{l}"]
                for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    crit["lin"] = dense("critic.lin")
    for r in ("relu", "relu2"):
        crit[r] = {"alpha": sd[f"critic.{r}.alpha"],
                   "beta": sd[f"critic.{r}.beta"]}
    p["critic"] = crit

    enc: Dict[str, Any] = {}
    for i in range(n_layers):
        pref = f"bm_enc.encoder.layers.{i}"
        layer = {n: mha(f"{pref}.{n}") for n in (
            "self_att_M1", "self_att_M2", "bi_modal_att_M1",
            "bi_modal_att_M2")}
        for m in ("M1", "M2"):
            layer[f"ff_{m}"] = {fc: dense(f"{pref}.feed_forward_{m}.{fc}")
                                for fc in ("fc1", "fc2")}
            for j in range(3):
                layer[f"res_{m}_{j}"] = {
                    "norm": ln(f"{pref}.res_layers_{m}.{j}.norm")}
        enc[f"layer_{i}"] = layer
    p["bm_enc"] = enc

    for name in ("bm_worker_fus", "bm_manager_fus"):
        fus: Dict[str, Any] = {}
        for i in range(n_layers):
            pref = f"{name}.decoder.layers.{i}"
            fus[f"layer_{i}"] = {
                "self_att": mha(f"{pref}.self_att"),
                "enc_att_A": mha(f"{pref}.enc_att_A"),
                "enc_att_V": mha(f"{pref}.enc_att_V"),
                **{f"res_{n}": {"norm": ln(f"{pref}.res_layer_{n}.norm")}
                   for n in ("self_att", "enc_att_A", "enc_att_V")},
                "normCA": ln(f"{pref}.normCA"),
                "normCV": ln(f"{pref}.normCV"),
                "a_v_constant": sd[f"{pref}.a_v_constant"]}
        p[name] = fus

    p["manager"] = {"linear": dense("manager.linear")}
    p["worker"] = {"goal_attention": mha("worker.goal_attention"),
                   "projection": dense("worker.core.projection")}
    return {"params": p}


def export_torch_bmhrl(params, path: str, n_layers: int = 2,
                       d_ff_c: int = 2048) -> str:
    """The inverse of ``import_torch_bmhrl``: a ``BMHrlAgent`` or its flax
    tree (``{"params": ...}`` or its inside; numpy arrays or tensors) -> a
    reference ``bm_hrl_agent.pt``. The reference's dead parameters (each
    fusion layer's feed-forward, ``Manager.core`` under both its names) are
    written as zeros, so a strict ``load_state_dict`` on the reference model
    succeeds."""
    p = _params_tree(params)
    sd: Dict[str, torch.Tensor] = {}
    put, dense, ln, mha = _writers(sd)

    def zeros(key, *shape):
        sd[key] = torch.zeros(*shape)

    put("emb_C.embedder.weight", p["emb_C"]["embedding"]["embedding"])
    _put_critic(put, dense, p["critic"])
    for i in range(n_layers):
        layer = p["bm_enc"][f"layer_{i}"]
        pref = f"bm_enc.encoder.layers.{i}"
        for n in ("self_att_M1", "self_att_M2", "bi_modal_att_M1",
                  "bi_modal_att_M2"):
            mha(f"{pref}.{n}", layer[n])
        for m in ("M1", "M2"):
            for fc in ("fc1", "fc2"):
                dense(f"{pref}.feed_forward_{m}.{fc}", layer[f"ff_{m}"][fc])
        for j in range(3):
            for m in ("M1", "M2"):
                ln(f"{pref}.res_layers_{m}.{j}.norm",
                   layer[f"res_{m}_{j}"]["norm"])
    d_caps, d_goal = np.shape(p["manager"]["linear"]["kernel"])
    for name in ("bm_worker_fus", "bm_manager_fus"):
        for i in range(n_layers):
            layer = p[name][f"layer_{i}"]
            pref = f"{name}.decoder.layers.{i}"
            for n in ("self_att", "enc_att_A", "enc_att_V"):
                mha(f"{pref}.{n}", layer[n])
            for n in ("self_att", "enc_att_A", "enc_att_V"):
                ln(f"{pref}.res_layer_{n}.norm", layer[f"res_{n}"]["norm"])
            ln(f"{pref}.normCA", layer["normCA"])
            ln(f"{pref}.normCV", layer["normCV"])
            put(f"{pref}.a_v_constant", layer["a_v_constant"])
            # the feed-forward the reference builds but never applies
            zeros(f"{pref}.feed_forward.fc1.weight", d_ff_c, d_caps)
            zeros(f"{pref}.feed_forward.fc1.bias", d_ff_c)
            zeros(f"{pref}.feed_forward.fc2.weight", d_caps, d_ff_c)
            zeros(f"{pref}.feed_forward.fc2.bias", d_caps)
    dense("manager.linear", p["manager"]["linear"])
    # the reference registers its unused LinearCore twice (manager.core and
    # manager_core); both key sets must exist for a strict load
    for core in ("manager.core", "manager_core"):
        zeros(f"{core}.linear.weight", d_goal, d_caps)
        zeros(f"{core}.linear.bias", d_goal)
    mha("worker.goal_attention", p["worker"]["goal_attention"])
    dense("worker.core.projection", p["worker"]["projection"])
    torch.save(sd, path)
    return path


def _params_tree(params) -> Dict[str, Any]:
    """The inside of a flax-layout tree: of a captioner module (through
    ``weights.jax_layout_params``) or of a tree (``{"params": ...}`` or its
    inside; numpy arrays or tensors)."""
    if isinstance(params, torch.nn.Module):
        from bmhrl_tpu_torch.weights import jax_layout_params

        params = jax_layout_params(params)
    p = params.get("params", params)

    def arrays(t):
        return ({k: arrays(v) for k, v in t.items()} if isinstance(t, dict)
                else np.asarray(t))

    return arrays(p)


def _writers(sd: Dict[str, torch.Tensor]):
    """(put, dense, ln, mha) writing the reference's keys into ``sd``."""

    def put(key, arr):
        sd[key] = torch.tensor(np.asarray(arr))

    def dense(prefix, t):
        put(f"{prefix}.weight", t["kernel"].T)
        put(f"{prefix}.bias", t["bias"])

    def ln(prefix, t):
        put(f"{prefix}.weight", t["scale"])
        put(f"{prefix}.bias", t["bias"])

    def mha(prefix, t):
        for n in _MHA:
            dense(f"{prefix}.{n}", t[n])

    return put, dense, ln, mha


def _put_critic(put, dense, crit) -> None:
    for kind, n in (("lstm", 4), ("gru", 2)):
        for l in range(n):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                put(f"critic.{kind}.{k}_l{l}", crit[f"{kind}_l{l}"][k])
    dense("critic.lin", crit["lin"])
    for r in ("relu", "relu2"):
        put(f"critic.{r}.alpha", crit[r]["alpha"])
        put(f"critic.{r}.beta", crit[r]["beta"])


def export_torch_unimodal(params, path: str, *, n_layers: int = 2,
                          d_ff_c: int = 2048) -> str:
    """An AHRL/VHRL captioner (``UnimodalAgent``) or its flax-layout tree ->
    ``path``, the reference's ``unimodal_hrl_agent.pt`` state dict
    (model/bm_hrl_agent.py:663-799). The reference's dead parameters are
    written too, so a strict ``load_state_dict`` succeeds: each fusion
    layer's unapplied feed-forward (width ``d_ff_c``) and ``Manager.core``
    as zeros, the encoder's unused middle residual LayerNorm at its init
    (ones, zeros)."""
    p = _params_tree(params)
    sd: Dict[str, torch.Tensor] = {}
    put, dense, ln, mha = _writers(sd)
    put("emb_C.embedder.weight", p["emb_C"]["embedding"]["embedding"])
    _put_critic(put, dense, p["critic"])
    d_m1 = p["uni_enc_layer_0"]["self_att_M1"]["linear_Q2d"]["kernel"].shape[0]
    for i in range(n_layers):
        layer = p[f"uni_enc_layer_{i}"]
        pref = f"uni_enc.encoder.layers.{i}"
        mha(f"{pref}.self_att_M1", layer["self_att_M1"])
        dense(f"{pref}.feed_forward_M1.fc1", layer["ff_M1"]["fc1"])
        dense(f"{pref}.feed_forward_M1.fc2", layer["ff_M1"]["fc2"])
        ln(f"{pref}.res_layers_M1.0.norm", layer["res_M1_0"]["norm"])
        ln(f"{pref}.res_layers_M1.2.norm", layer["res_M1_2"]["norm"])
        # the middle residual slot the reference clones and never applies
        put(f"{pref}.res_layers_M1.1.norm.weight",
            np.ones((d_m1,), np.float32))
        put(f"{pref}.res_layers_M1.1.norm.bias",
            np.zeros((d_m1,), np.float32))
    d_caps, d_goal = p["manager"]["linear"]["kernel"].shape
    for name in ("uni_worker_fus", "uni_manager_fus"):
        for i in range(n_layers):
            layer = p[f"{name}_layer_{i}"]
            pref = f"{name}.decoder.layers.{i}"
            mha(f"{pref}.self_att", layer["self_att"])
            mha(f"{pref}.enc_att", layer["enc_att"])
            ln(f"{pref}.res_layer_self_att.norm",
               layer["res_self_att"]["norm"])
            ln(f"{pref}.res_layer_enc_att.norm", layer["res_enc_att"]["norm"])
            ln(f"{pref}.normC", layer["normC"])
            # the feed-forward the reference builds but never applies
            for key, shape in (("fc1.weight", (d_ff_c, d_caps)),
                               ("fc1.bias", (d_ff_c,)),
                               ("fc2.weight", (d_caps, d_ff_c)),
                               ("fc2.bias", (d_caps,))):
                put(f"{pref}.feed_forward.{key}", np.zeros(shape, np.float32))
    dense("manager.linear", p["manager"]["linear"])
    put("manager.core.linear.weight", np.zeros((d_goal, d_caps), np.float32))
    put("manager.core.linear.bias", np.zeros((d_goal,), np.float32))
    mha("worker.goal_attention", p["worker"]["goal_attention"])
    dense("worker.core.projection", p["worker"]["projection"])
    torch.save(sd, path)
    return path


def export_torch_detr(params, path: str, *, d_goal: int = 64,
                      num_layers: int = 3, n_time: int = 3,
                      dim_ff: int = 2048, obj_hidden: int = 256,
                      obj_layers: int = 6,
                      pre_goal_attention: bool = False) -> str:
    """A ``DetrCaption`` or its flax-layout tree -> ``path``, the reference's
    ``detr_agent.pt`` state dict (model/det_bmhrl_agent.py:12-91 and the
    encoder, decoder and object-detector module trees), for a STRICT
    ``load_state_dict`` on the reference model. The parameters the
    reference registers and its executed forward never reads (the manager
    decoder stack, each decoder layer's goal attention and norm4, the empty
    ``positional_encoding``, the encoders' ``embed`` heads, ``query_embed``
    (80, 300), ``object_detector.linear``, and on the default path the
    critic and the goal modules) are written as zeros; with
    ``pre_goal_attention`` the goal path is live and written from
    ``params``."""
    p = _params_tree(params)
    sd: Dict[str, torch.Tensor] = {}
    put, dense, ln, mha = _writers(sd)

    def zeros(key, *shape):
        sd[key] = torch.zeros(*shape) if shape else torch.zeros(0)

    def ln_dead(prefix, d):
        zeros(f"{prefix}.weight", d)
        zeros(f"{prefix}.bias", d)

    def mha_dead(prefix, dq, dk, dv, d_att):
        for n, din, dout in (("linear_Q2d", dq, d_att),
                             ("linear_K2d", dk, d_att),
                             ("linear_V2d", dv, d_att),
                             ("linear_d2Q", d_att, dq)):
            zeros(f"{prefix}.{n}.weight", dout, din)
            zeros(f"{prefix}.{n}.bias", dout)

    emb = p["emb_C"]["embedding"]["embedding"]
    voc, d_caps = emb.shape
    d_model = p["encoder"]["layer_0"]["self_attn"]["linear_Q2d"][
        "kernel"].shape[0]
    d_worker = d_caps + (d_goal if pre_goal_attention else 0)
    put("emb_C.embedder.weight", emb)
    if "critic" in p:
        _put_critic(put, dense, p["critic"])
    else:
        # the default path's critic: dead (no flax parameters), registered
        # by the reference
        for l in range(4):
            zeros(f"critic.lstm.weight_ih_l{l}", 8 * d_caps,
                  d_caps if l == 0 else 2 * d_caps)
            zeros(f"critic.lstm.weight_hh_l{l}", 8 * d_caps, 2 * d_caps)
            zeros(f"critic.lstm.bias_ih_l{l}", 8 * d_caps)
            zeros(f"critic.lstm.bias_hh_l{l}", 8 * d_caps)
        for l in range(2):
            zeros(f"critic.gru.weight_ih_l{l}", 6 * d_caps, 2 * d_caps)
            zeros(f"critic.gru.weight_hh_l{l}", 6 * d_caps, 2 * d_caps)
            zeros(f"critic.gru.bias_ih_l{l}", 6 * d_caps)
            zeros(f"critic.gru.bias_hh_l{l}", 6 * d_caps)
        zeros("critic.lin.weight", 1, 2 * d_caps)
        zeros("critic.lin.bias", 1)
        for r in ("relu", "relu2"):
            zeros(f"critic.{r}.alpha", 1)
            zeros(f"critic.{r}.beta", 1)

    def encoder_stack(tname, tree, d, nl):
        """Live self_attn, linear1/2, norm1/2; the dead ``embed`` (Linear
        d -> 300, encoder.py:50)."""
        for i in range(nl):
            layer = tree[f"layer_{i}"]
            pref = f"{tname}.layers.{i}"
            mha(f"{pref}.self_attn", layer["self_attn"])
            dense(f"{pref}.linear1", layer["linear1"])
            dense(f"{pref}.linear2", layer["linear2"])
            zeros(f"{pref}.embed.weight", 300, d)
            zeros(f"{pref}.embed.bias", 300)
            ln(f"{pref}.norm1", layer["norm1"])
            ln(f"{pref}.norm2", layer["norm2"])
        ln(f"{tname}.norm", tree["norm"])

    def decoder_stack(tname, tree, d_mem, d_C, d_g, d_att, nl,
                      live_detected, live=True):
        """Per layer self_attn and multihead_attn live, detected_attention
        live on the worker path only, goal_attention and norm4 dead,
        positional_encoding an empty parameter (decoder.py:39-66)."""
        for i in range(nl):
            layer = tree[f"layer_{i}"] if live else None
            pref = f"{tname}.layers.{i}"
            zeros(f"{pref}.positional_encoding")
            if live:
                mha(f"{pref}.self_attn", layer["self_attn"])
                mha(f"{pref}.multihead_attn", layer["multihead_attn"])
            else:
                mha_dead(f"{pref}.self_attn", d_C, d_C, d_C, d_att)
                mha_dead(f"{pref}.multihead_attn", d_C, d_mem, d_mem, d_att)
            if live and live_detected:
                mha(f"{pref}.detected_attention", layer["detected_attention"])
                ln(f"{pref}.norm5", layer["norm5"])
            else:
                mha_dead(f"{pref}.detected_attention", d_C, 256, 256, d_att)
                ln_dead(f"{pref}.norm5", d_C)
            mha_dead(f"{pref}.goal_attention", d_C, d_g, d_g, d_att)
            ln_dead(f"{pref}.norm4", d_C)
            if live:
                dense(f"{pref}.linear1", layer["linear1"])
                dense(f"{pref}.linear2", layer["linear2"])
                for n in ("norm1", "norm2", "norm3"):
                    ln(f"{pref}.{n}", layer[n])
            else:
                zeros(f"{pref}.linear1.weight", dim_ff, d_C)
                zeros(f"{pref}.linear1.bias", dim_ff)
                zeros(f"{pref}.linear2.weight", d_C, dim_ff)
                zeros(f"{pref}.linear2.bias", d_C)
                for n in ("norm1", "norm2", "norm3"):
                    ln_dead(f"{pref}.{n}", d_C)
        if live:
            ln(f"{tname}.norm", tree["norm"])
        else:
            ln_dead(f"{tname}.norm", d_C)

    encoder_stack("encoder", p["encoder"], d_model, num_layers)
    decoder_stack("worker_decoder", p["worker_decoder"], d_model, d_worker,
                  d_goal, d_model, num_layers, live_detected=True)
    if pre_goal_attention:
        decoder_stack("manager_decoder", p["manager_decoder"], d_model,
                      d_caps, d_goal, d_model, num_layers,
                      live_detected=False)
        dense("manager.linear", p["manager"]["linear"])
        ln("goal_norm", p["goal_norm"])
        mha("goal_attention", p["goal_attention"])
        mha("goal_feature_attention", p["goal_feature_attention"])
    else:
        decoder_stack("manager_decoder", None, d_model, d_caps, d_goal,
                      d_model, num_layers, live_detected=False, live=False)
        # the reference's default path holds ONE LayerNorm object as both
        # worker_decoder.norm and manager_decoder.norm
        # (det_bmhrl_agent.py:43), so a load takes the last key: both keys
        # get the live values
        ln("manager_decoder.norm", p["worker_decoder"]["norm"])
        zeros("manager.linear.weight", d_goal, d_caps)
        zeros("manager.linear.bias", d_goal)
        ln_dead("goal_norm", d_caps)
        mha_dead("goal_attention", d_caps, d_goal, d_goal, d_model)
        mha_dead("goal_feature_attention", d_goal, d_caps, d_caps, d_model)
    dense("linear", p["linear"])
    zeros("query_embed.weight", 80, 300)  # dead (det_bmhrl_agent.py:74)
    od = p["object_detector"]
    dense("object_detector.class_embed", od["class_embed"])
    put("object_detector.query_embed.weight", od["query_embed"])
    dense("object_detector.input_projection", od["input_projection"])
    zeros("object_detector.linear.weight", voc, obj_hidden)  # dead
    zeros("object_detector.linear.bias", voc)
    encoder_stack("object_detector.encoder", od["encoder"], obj_hidden,
                  obj_layers)
    decoder_stack("object_detector.decoder", od["decoder"], obj_hidden,
                  obj_hidden, d_goal, obj_hidden, obj_layers,
                  live_detected=False)
    for i in range(n_time):
        # Conv1d weight (out, in, k) from the flax kernel (k, in, out)
        put(f"input_proj.{i}.0.weight",
            p[f"input_proj_{i}"]["kernel"].transpose(2, 1, 0))
        put(f"input_proj.{i}.0.bias", p[f"input_proj_{i}"]["bias"])
        put(f"input_proj.{i}.1.weight", p[f"input_norm_{i}"]["scale"])
        put(f"input_proj.{i}.1.bias", p[f"input_norm_{i}"]["bias"])
    torch.save(sd, path)
    return path
