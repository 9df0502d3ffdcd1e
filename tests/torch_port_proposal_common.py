"""Shared set-up of the tests/test_torch_port_proposal_*.py files: the JAX
proposal test's bump-coded corpus (``test_proposal_model.
_synthetic_dataset``: six 10 s videos, features 16 / 8 wide, an event
marked by a bump over its span; pads 32 / 64), its TINY dims, batches
made by both packages' ``ProposalDataset`` from the same files, and one
random flax-layout tree loaded into both models."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_proposal_model import TINY, _synthetic_dataset

from bmhrl_tpu.data.proposal import ProposalDataset as JProposalDataset
from bmhrl_tpu_torch.data.proposal import ProposalDataset

# the parts of a batch the model reads, in the order of its arguments
KEYS = ("feature_stacks", "targets", "masks")
PADS = dict(pad_video_to=32, pad_audio_to=64)


def corpus(root, missing=False):
    """(meta, video dir, audio dir, the JAX dataset) of the bump-coded
    corpus under ``root``; with ``missing``, a seventh video without
    feature files (zero (1, D) stacks, original length 1)."""
    jds, meta, vdir, adir = _synthetic_dataset(root)
    if missing:
        with open(meta, "a") as f:
            f.write("v_missing\tno features\t2.0\t5.0\t8.0\ttrain\t6\n")
    return str(meta), str(vdir), str(adir)


def datasets(meta, vdir, adir, num_anchors=3):
    """The port's and the JAX package's ``ProposalDataset`` of one corpus."""
    kw = dict(num_anchors=num_anchors, d_vid=16, d_aud=8, **PADS)
    return (ProposalDataset(meta, vdir, adir, **kw),
            JProposalDataset(meta, vdir, adir, **kw))


def dims(num_anchors, **over):
    return dict(TINY, num_anchors=num_anchors, **over)


def jax_inputs(batch):
    return tuple(jax.tree.map(jnp.asarray, batch[k]) for k in KEYS)


def torch_inputs(batch):
    return tuple(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                              batch[k]) for k in KEYS)


def port_model(tree, d, dtype=torch.float32):
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.weights import load_jax_params

    model = MultimodalProposalGenerator(**d, dtype=dtype, device="cpu")
    return load_jax_params(model, tree)


def jax_model(d, dtype=jnp.float32):
    from bmhrl_tpu.models.proposal import MultimodalProposalGenerator

    return MultimodalProposalGenerator(**d, dtype=dtype)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
