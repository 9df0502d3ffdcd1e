"""Pretrain the frozen SegmentCritic, the segment-boundary detector that
every BMHRL run loads (the port of cli/train_critic.py, flag for flag, plus
``--device``).

    python -m bmhrl_tpu_torch.cli.train_critic --corpus_json train.json \\
        --train_meta_path ./data/train.csv --out ./data/models/critic.cp \\
        [--segment_json charades.json] [--epochs 3] [--device cuda]

- with ``--segment_json`` in the CharadeCaptions layout ({"captions": [...],
  "seg_labels": [...]} per entry) the labels are taken as they are;
- otherwise labels are made from the captions of an ANet-format JSON
  corpus: a boundary at the token before a clause marker and at the
  caption's end (``synth_labels``).

The critic trains standalone (embedding + BCE over its boundary logits,
through ``SegmentCritic.logits_trainable``) and is written as a
reference-layout ``critic.cp`` (``utils.checkpoint.export_torch_critic``),
which ``utils.checkpoint.install_critic`` loads.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Sequence, Tuple

import numpy as np

BOUNDARY_WORDS = {"and", "then", "while", "before", "after", "as"}


def synth_labels(tokens: Sequence[str]) -> List[int]:
    """A boundary at each token before a clause marker and at the end."""
    labels = [0] * len(tokens)
    for i, tok in enumerate(tokens):
        if i > 0 and (tok in {",", ";", "."} or tok in BOUNDARY_WORDS):
            labels[i - 1] = 1
    if labels:
        labels[-1] = 1
    return labels


def load_examples(args) -> List[Tuple[List[str], List[int]]]:
    """(tokens with <s> (and </s>), labels) of every usable caption."""
    from bmhrl_tpu_torch.data.tokenizer import tokenize_lower

    out: List[Tuple[List[str], List[int]]] = []
    if args.segment_json:
        with open(args.segment_json) as f:
            data = json.load(f)
        entries = data.values() if isinstance(data, dict) else data
        for item in entries:
            for caption, seg in zip(item["captions"], item["seg_labels"]):
                words = caption.split()
                if len(words) != len(seg):
                    continue
                out.append((["<s>"] + [w.lower() for w in words],
                            [0] + list(seg)))
    else:
        with open(args.corpus_json) as f:
            data = json.load(f)
        for info in data.values():
            for caption in info.get("sentences", []):
                toks = tokenize_lower(caption)
                if not toks:
                    continue
                out.append((["<s>"] + toks + ["</s>"],
                            [0] + synth_labels(toks) + [0]))
    return out


def encode_examples(examples, vocab, max_len: int):
    """(ids (N, max_len) PAD-filled, labels, mask) float32 arrays."""
    from bmhrl_tpu_torch.data.vocab import PAD

    n = len(examples)
    ids = np.full((n, max_len), PAD, np.int64)
    labels = np.zeros((n, max_len), np.float32)
    mask = np.zeros((n, max_len), np.float32)
    for i, (toks, lab) in enumerate(examples):
        enc = vocab.encode(toks)[:max_len]
        ids[i, : len(enc)] = enc
        labels[i, : len(enc)] = lab[: len(enc)]
        mask[i, : len(enc)] = 1.0
    return ids, labels, mask


def critic_trainer(voc_size: int, d: int, device):
    """The trained module: ``emb`` (the scaled embedding) and ``critic``,
    named as the JAX trainer's flax tree."""
    import torch

    from bmhrl_tpu_torch.models.blocks import VocabularyEmbedder
    from bmhrl_tpu_torch.models.critic import SegmentCritic

    class CriticTrainer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = VocabularyEmbedder(voc_size, d, device)
            self.critic = SegmentCritic(d, device)

        def forward(self, tokens):
            return self.critic.logits_trainable(self.emb(tokens))[..., 0]

    return CriticTrainer()


def bce_loss(logits, labels, mask):
    """Masked mean of the logits' binary cross-entropy, the JAX trainer's
    stable form."""
    import torch

    bce = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return (bce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def train_step(model, optim, opt_state, tok, lab, msk, lr: float):
    """One Adam step over every parameter; returns (state, loss)."""
    import torch

    params = dict(model.named_parameters())
    loss = bce_loss(model(tok), lab, msk)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    return optim.update(grads, opt_state, params, True, lr), loss.detach()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Pretrain the segment critic "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--corpus_json", default="./data/train.json",
                   help="ANet-format JSON caption corpus")
    p.add_argument("--segment_json", default=None,
                   help="CharadeCaptions-format JSON with seg_labels")
    p.add_argument("--train_meta_path", default="./data/train.csv",
                   help="meta TSV for the vocabulary")
    p.add_argument("--glove_path", default=None)
    p.add_argument("--out", default="./data/models/critic.cp")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--d_model_caps", type=int, default=300)
    p.add_argument("--max_examples", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda or cpu")
    return p


def train(args):
    """Train the critic as ``args`` say; returns (the trainer module, the
    mean BCE of each epoch)."""
    import torch

    from bmhrl_tpu_torch import resolve_device
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.train.optim import GatedAdam
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    device = resolve_device(args.device)
    vocab = build_vocab_from_tsv(args.train_meta_path, 1, args.glove_path,
                                 args.d_model_caps)
    examples = load_examples(args)
    if args.max_examples:
        examples = examples[: args.max_examples]
    print(f"{len(examples)} critic training examples, vocab {len(vocab)}")
    ids, labels, mask = (torch.from_numpy(a).to(device) for a in
                         encode_examples(examples, vocab, args.max_len))

    model = critic_trainer(len(vocab), args.d_model_caps, device)
    load_jax_params(model, random_module_params(model, args.seed,
                                                flax_init=True))
    if vocab.vectors is not None:
        with torch.no_grad():
            model.emb.embedding.weight.copy_(torch.from_numpy(vocab.vectors))
    optim = GatedAdam(0.9, 0.999, 1e-8, 0.0)
    opt_state = optim.init(dict(model.named_parameters()))

    n = len(examples)
    order = np.arange(n)
    rng_np = np.random.RandomState(args.seed)
    bces = []
    for epoch in range(args.epochs):
        rng_np.shuffle(order)
        losses = []
        for s in range(0, n - args.batch_size + 1, args.batch_size):
            idx = torch.from_numpy(order[s: s + args.batch_size]).to(device)
            opt_state, loss = train_step(model, optim, opt_state, ids[idx],
                                         labels[idx], mask[idx], args.lr)
            losses.append(loss)
        bces.append(float(torch.stack(losses).mean()) if losses
                    else float("nan"))
        print(f"epoch {epoch}: bce={bces[-1]:.4f}")
    return model, bces


def main(argv=None):
    from bmhrl_tpu_torch.utils.checkpoint import export_torch_critic

    args = build_parser().parse_args(argv)
    model, _ = train(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    export_torch_critic(model.critic, args.out)
    print(f"saved {args.out}")
    return args.out


if __name__ == "__main__":
    main()
