"""The reference's ``bm_hrl_agent.pt`` state dict <-> the flax-layout
weight tree (the port's copy of the name map of
bmhrl_tpu/utils/checkpoint.py, ``import_torch_bmhrl`` and
``export_torch_bmhrl``). A tree goes into the port's ``BMHrlAgent`` through
``weights.load_jax_params``.

Orbax checkpoints are out of reach here (orbax imports JAX): trained
weights come to the port as a reference-layout ``.pt``, which the JAX
package writes with its own ``export_torch_bmhrl``."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
