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
  goes into the port's ``BMHrlAgent`` through ``weights.load_jax_params``.

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


def export_torch_bmhrl(params: Dict[str, Any], path: str, n_layers: int = 2,
                       d_ff_c: int = 2048) -> str:
    """The inverse of ``import_torch_bmhrl``: a flax tree (``{"params":
    ...}`` or its inside; numpy arrays or tensors) -> a reference
    ``bm_hrl_agent.pt``. The reference's dead parameters (each fusion
    layer's feed-forward, ``Manager.core`` under both its names) are written
    as zeros, so a strict ``load_state_dict`` on the reference model
    succeeds."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.tensor(np.asarray(arr, dtype=np.float32))

    def zeros(key, *shape):
        sd[key] = torch.zeros(*shape)

    def dense(prefix, t):
        put(f"{prefix}.weight", np.asarray(t["kernel"]).T)
        put(f"{prefix}.bias", t["bias"])

    def ln(prefix, t):
        put(f"{prefix}.weight", t["scale"])
        put(f"{prefix}.bias", t["bias"])

    def mha(prefix, t):
        for n in _MHA:
            dense(f"{prefix}.{n}", t[n])

    put("emb_C.embedder.weight", p["emb_C"]["embedding"]["embedding"])
    crit = p["critic"]
    for kind, n in (("lstm", 4), ("gru", 2)):
        for l in range(n):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                put(f"critic.{kind}.{k}_l{l}", crit[f"{kind}_l{l}"][k])
    dense("critic.lin", crit["lin"])
    for r in ("relu", "relu2"):
        put(f"critic.{r}.alpha", crit[r]["alpha"])
        put(f"critic.{r}.beta", crit[r]["beta"])
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
