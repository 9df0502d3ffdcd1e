"""Weights in the JAX package's layout: load a flax variable tree into the
port (a captioner, a value function or the proposal generator), or make a
random one from a numpy seed.

The port's module and parameter names follow the flax param tree, so the map
is by rule: a path ``a/b/c/leaf`` of the tree is the parameter ``a.b.c.X``,
where X depends on the owning module:

- ``Dense`` (an ``nn.Linear``): ``kernel`` (in, out) <-> ``weight`` (out, in),
  transposed; ``bias`` <-> ``bias``;
- ``nn.Conv1d`` (the DETR's temporal projections, the proposal heads'
  convolutions): ``kernel`` (k, in, out) <-> ``weight`` (out, in, k), all
  axes reversed; ``bias`` <-> ``bias``;
- ``nn.LayerNorm`` and ``nn.GroupNorm``: ``scale`` <-> ``weight``;
  ``bias`` <-> ``bias``;
- ``nn.Embedding``: ``embedding`` <-> ``weight``;
- anything else (critic RNN weights, already in torch layout; AReLU
  ``alpha``/``beta``; ``a_v_constant``; the DETR detector's
  ``query_embed``): the same name.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {nn.Linear: {"weight": "kernel", "bias": "bias"},
         nn.Conv1d: {"weight": "kernel", "bias": "bias"},
         nn.LayerNorm: {"weight": "scale", "bias": "bias"},
         nn.GroupNorm: {"weight": "scale", "bias": "bias"},
         nn.Embedding: {"weight": "embedding"}}


def _flax_paths(model: nn.Module
                ) -> Iterator[Tuple[Tuple[str, ...], nn.Parameter, bool]]:
    """(flax path under "params", torch parameter, transposed: all axes
    reversed) for every parameter of ``model``."""
    for mod_name, mod in model.named_modules():
        rename = next((m for t, m in _LEAF.items() if isinstance(mod, t)), {})
        for leaf, p in mod.named_parameters(recurse=False):
            path = tuple(mod_name.split(".")) if mod_name else ()
            yield (path + (rename.get(leaf, leaf),), p,
                   isinstance(mod, (nn.Linear, nn.Conv1d))
                   and leaf == "weight")


def _flatten(tree: Dict, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Dict) -> nn.Module:
    """Copy a flax variable tree ``{"params": ...}`` (nested dicts of arrays)
    into ``model``. Strict: every parameter is loaded, every leaf is used and
    every shape agrees."""
    leaves = _flatten(tree["params"])
    seen = set()
    for path, p, transposed in _flax_paths(model):
        if path not in leaves:
            raise KeyError(f"missing from the tree: {'/'.join(path)}")
        arr = np.asarray(leaves[path], dtype=np.float32)
        if transposed:
            arr = arr.T
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: tree {arr.shape} vs model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr)))
        seen.add(path)
    extra = sorted("/".join(k) for k in leaves if k not in seen)
    if extra:
        raise KeyError(f"tree leaves the model has no place for: {extra}")
    return model


def flax_keys(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """{parameter name: (its "a/b/c" key under "params" in the flax tree,
    transposed: all axes reversed)} for every parameter of ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: ("/".join(path), transposed)
            for path, p, transposed in _flax_paths(model)}


@torch.no_grad()
def jax_layout_params(model: nn.Module) -> Dict:
    """The inverse of ``load_jax_params``: ``model``'s weights as a flax
    variable tree ``{"params": ...}`` of numpy f32 arrays (copies: a later
    in-place update of the module leaves them as they are)."""
    tree: Dict = {}
    for path, p, transposed in _flax_paths(model):
        arr = p.detach().float().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr.T if transposed else arr, order="C")
    return {"params": tree}


def random_jax_layout_params(dims: Dict, seed: int = 0) -> Dict:
    """A random flax-layout tree ``{"params": ...}`` of numpy f32 arrays with
    the keys and shapes that the JAX package's ``init`` of the agent gives
    (``random_module_params`` of the agent's shapes): ``UnimodalAgent`` when
    ``dims`` name a ``modality`` (AHRL/VHRL), ``DetrCaption`` when they
    name ``n_time`` (DETR), ``MultimodalProposalGenerator`` when they name
    ``num_anchors`` (the proposal generator), else ``BMHrlAgent``."""
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.models.detr import DetrCaption
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.models.unimodal import UnimodalAgent

    cls = (UnimodalAgent if "modality" in dims
           else DetrCaption if "n_time" in dims
           else MultimodalProposalGenerator if "num_anchors" in dims
           else BMHrlAgent)
    return random_module_params(cls(**dims, device="meta"), seed)


def random_module_params(model: nn.Module, seed: int = 0,
                         flax_init: bool = False) -> Dict:
    """A random flax-layout tree for ``model`` (its parameters give the
    keys and shapes; a model on the "meta" device is enough). Scales follow
    the flax initialisers (lecun-normal kernels, unit-normal embedding and
    DETR queries, torch-RNN uniform critic weights, AReLU constants at their
    init values); biases, norm parameters and the fusion gate constant get
    small random values so that a loader that drops them shows, or, with
    ``flax_init``, the flax initialisers' values (zero biases and gate
    constant, unit norm scales; the biases of a ``ConvSame`` with
    ``torch_bias_init`` (the DETR's projections) uniform in
    ±1/sqrt(fan-in), torch's, as the JAX package sets them): the start of
    a training run."""
    rng = np.random.RandomState(seed)
    convs = {n for n, m in model.named_modules()
             if getattr(m, "torch_bias_init", False)}
    tree: Dict = {}
    for path, p, transposed in _flax_paths(model):
        shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
        leaf = path[-1]
        if leaf == "kernel":
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "bias" and flax_init and ".".join(path[:-1]) in convs:
            conv = model.get_submodule(".".join(path[:-1]))
            bound = 1.0 / np.sqrt(conv.weight[0].numel())
            arr = rng.uniform(-bound, bound, shape)
        elif leaf in ("embedding", "query_embed"):
            arr = rng.randn(*shape)
        elif leaf.startswith(("weight_", "bias_")):
            bound = 1.0 / np.sqrt(max(shape[0] // 4, 1))
            arr = rng.uniform(-bound, bound, shape)
        elif leaf == "scale":
            arr = np.ones(shape) if flax_init else 1.0 + 0.1 * rng.randn(
                *shape)
        elif leaf == "bias":
            arr = np.zeros(shape) if flax_init else 0.02 * rng.randn(*shape)
        elif leaf == "alpha":
            arr = np.full(shape, 0.9)
        elif leaf == "beta":
            arr = np.full(shape, 2.0)
        elif leaf == "a_v_constant":
            arr = np.zeros(shape) if flax_init else 0.5 * rng.randn(*shape)
        else:
            raise KeyError(f"no initialiser for {'/'.join(path)}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}
