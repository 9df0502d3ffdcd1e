"""Proposal-generator training CLI of the PyTorch/CUDA port (the port of
cli/train_proposals.py, flag for flag, plus ``--device``): per-epoch
training with the per-modality losses, validation that post-processes the
predictions (top-k by confidence, trim to the video, optional NMS, drop
segments of 0.2 s or less) and scores detection precision / recall / F1
across tIoUs, the best-F1 checkpoint.

    python -m bmhrl_tpu_torch.cli.train_proposals \\
        --train_meta_path data/train.csv --val_meta_path data/val_1.csv \\
        --video_features_path .../i3d --audio_features_path .../vggish \\
        --log_dir ./log/props [--epochs 30] [--device cuda]

After training (or with ``--emit_only --checkpoint_dir``) it writes the
best model's validation proposals as an ANet-style JSON
(``learned_proposals.json``) and as the meta TSV (``learned_props.csv``)
that the captioner's ``learned_props`` phase reads
(``data.dataset.CaptioningDataset(cfg, "learned_props")`` through
``cfg.val_prop_meta_path``). The checkpoint is the port's own
(``utils.checkpoint.save_proposal_checkpoint``: ``props.pt`` with
``anchors.npy`` beside it); a JAX run's log directory (orbax) is refused
with a message.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from bmhrl_tpu_torch.utils.proposals import (nms, select_topk_predictions,
                                             tiou_vectorized, trim_proposals)


def evaluate_proposals(pred_segments, gt_by_vid, tious):
    """Detection precision and recall per tIoU, averaged over videos (the
    semantics of ANETcaptions' detection scores), F1 from the two, and
    their averages over the tIoUs under ``"avg"``."""
    out = {}
    for tiou in tious:
        ps, rs = [], []
        for vid, gt in gt_by_vid.items():
            preds = np.asarray(pred_segments.get(vid, []), np.float32)
            gt = np.asarray(gt, np.float32)
            if len(preds) == 0:
                ps.append(0.0)
                rs.append(0.0)
                continue
            iou = tiou_vectorized(preds[:, :2], gt)
            ps.append(float((iou.max(axis=1) > tiou).mean()))
            rs.append(float((iou.max(axis=0) > tiou).mean()))
        p, r = float(sum(ps) / len(ps)), float(sum(rs) / len(rs))
        f1 = 2 * p * r / max(p + r, 1e-9)
        out[tiou] = {"Precision": p, "Recall": r, "F1": f1}
    avg = {k: sum(out[t][k] for t in tious) / len(tious)
           for k in ("Precision", "Recall", "F1")}
    out["avg"] = avg
    return out


def postprocess(preds_np, durations, max_props, nms_tiou):
    """Raw (B, N, 3) seconds-space predictions -> per-video [start, end,
    conf] lists: top-k by confidence, trim to the duration, optional NMS,
    drop segments of 0.2 s or less."""
    out = []
    for b in range(preds_np.shape[0]):
        segs, confs = preds_np[b, :, :2], preds_np[b, :, 2]
        segs, confs = select_topk_predictions(segs, confs, max_props)
        segs = trim_proposals(segs, float(durations[b]))
        if nms_tiou is not None:
            kept = nms(segs, confs, nms_tiou)
            segs, confs = segs[kept], confs[kept]
        keep = (segs[:, 1] - segs[:, 0]) > 0.2  # shortest-segment prior
        rows = np.concatenate([segs[keep], confs[keep, None]], 1)
        out.append(rows.tolist())
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the proposal generator "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--train_meta_path", required=True)
    p.add_argument("--val_meta_path", required=True)
    p.add_argument("--video_features_path", required=True)
    p.add_argument("--audio_features_path", required=True)
    p.add_argument("--log_dir", default="./log/props")
    p.add_argument("--B", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--num_anchors", type=int, default=10)
    p.add_argument("--d_model", type=int, default=1024)
    p.add_argument("--d_model_aud", type=int, default=128)
    p.add_argument("--att_heads", type=int, default=4)
    p.add_argument("--att_layers", type=int, default=2)
    p.add_argument("--d_ff_v", type=int, default=1024)
    p.add_argument("--d_ff_a", type=int, default=512)
    p.add_argument("--d_vid", type=int, default=1024)
    p.add_argument("--d_aud", type=int, default=128)
    p.add_argument("--pad_video_to", type=int, default=300)
    p.add_argument("--pad_audio_to", type=int, default=800)
    p.add_argument("--dout_p", type=float, default=0.1)
    p.add_argument("--max_prop_per_vid", type=int, default=100)
    p.add_argument("--nms_tiou_thresh", type=float, default=None)
    p.add_argument("--tIoUs", type=float, nargs="+",
                   default=[0.3, 0.5, 0.7, 0.9])
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None,
                   help="restore and continue / emit from this dir (a "
                        "log dir of this CLI)")
    p.add_argument("--emit_only", action="store_true", default=False,
                   help="skip training; just write val proposals from the "
                        "checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from bmhrl_tpu_torch.data.proposal import ProposalDataset
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
    from bmhrl_tpu_torch.utils.captioning import make_metafile
    from bmhrl_tpu_torch.utils.checkpoint import (PROPOSAL_NAME,
                                                  load_proposal_checkpoint,
                                                  refuse_orbax,
                                                  save_proposal_checkpoint)
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    if args.checkpoint_dir:
        refuse_orbax(args.checkpoint_dir, PROPOSAL_NAME)
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    ds_kw = dict(video_features_path=args.video_features_path,
                 audio_features_path=args.audio_features_path,
                 pad_video_to=args.pad_video_to,
                 pad_audio_to=args.pad_audio_to,
                 num_anchors=args.num_anchors,
                 d_vid=args.d_vid, d_aud=args.d_aud)
    train_ds = ProposalDataset(args.train_meta_path, **ds_kw)
    if args.checkpoint_dir:
        # the anchors travel with the checkpoint: the head's length scales
        # mean nothing against anchors re-clustered from another meta
        anchors_path = os.path.join(args.checkpoint_dir, "anchors.npy")
        if os.path.exists(anchors_path):
            train_ds.anchors = np.load(anchors_path)
            print(f"anchors restored from {anchors_path}")
        else:
            print(f"WARNING: {anchors_path} missing; re-clustered anchors "
                  "from --train_meta_path may not match the checkpoint")
    val_ds = ProposalDataset(args.val_meta_path, **ds_kw)
    val_ds.anchors = train_ds.anchors  # anchors belong to the train corpus
    model = MultimodalProposalGenerator(
        d_vid=args.d_vid, d_aud=args.d_aud, d_model=args.d_model,
        d_model_aud=args.d_model_aud, d_ff_v=args.d_ff_v,
        d_ff_a=args.d_ff_a, att_heads=args.att_heads,
        att_layers=args.att_layers, num_anchors=len(train_ds.anchors),
        dout_p=args.dout_p, dtype=dtype, device=args.device)
    load_jax_params(model, random_module_params(model, args.seed,
                                                flax_init=True))
    sf = ProposalStepFactory(model, lr=args.lr, grad_clip=args.grad_clip,
                             device=args.device)
    state = sf.init_state()
    if args.checkpoint_dir:
        state = load_proposal_checkpoint(args.checkpoint_dir, model, state)
        print(f"restored {args.checkpoint_dir}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"proposal generator: {n_params/1e6:.2f}M params, "
          f"anchors={np.round(train_ds.anchors, 2).tolist()}")

    gt_by_vid = {v: val_ds.videos[v]["segments"] for v in val_ds.video_ids}
    os.makedirs(args.log_dir, exist_ok=True)

    def run_validation(epoch):
        pred_segments = {}
        for batch in val_ds.batches(epoch, args.B, shuffle=False):
            preds = sf.predict(state, batch).cpu().numpy()
            per_vid = postprocess(preds, batch["durations"],
                                  args.max_prop_per_vid,
                                  args.nms_tiou_thresh)
            for vid, rows in zip(batch["video_ids"], per_vid):
                pred_segments[vid] = rows
        metrics = evaluate_proposals(pred_segments, gt_by_vid, args.tIoUs)
        return pred_segments, metrics

    best_f1, best_preds = -1.0, None
    if args.emit_only:
        best_preds, metrics = run_validation(0)
        best_f1 = metrics["avg"]["F1"]
        print(json.dumps({"val_F1": best_f1, "per_tiou": {
            str(t): metrics[t] for t in args.tIoUs}}))
    else:
        for epoch in range(args.epochs):
            tot, n = 0.0, 0
            for bi, batch in enumerate(
                    train_ds.batches(epoch, args.B, seed=args.seed)):
                if (args.max_steps_per_epoch is not None
                        and bi >= args.max_steps_per_epoch):
                    break
                # one stream of draws per step, from the seed and the step
                draws = sf.draws(args.seed + 1 + 1_000_003 * state.step)
                state, m = sf.train_step(state, batch, draws)
                tot += float(m["loss"])
                n += 1
            preds, metrics = run_validation(epoch)
            f1 = metrics["avg"]["F1"]
            print(f"epoch {epoch}: train_loss={tot/max(n,1):.4f} "
                  f"val_F1={f1:.4f} P={metrics['avg']['Precision']:.4f} "
                  f"R={metrics['avg']['Recall']:.4f}")
            if f1 > best_f1:
                best_f1, best_preds = f1, preds
                save_proposal_checkpoint(args.log_dir, model, state)
                np.save(os.path.join(args.log_dir, "anchors.npy"),
                        train_ds.anchors)

    # an ANet-style JSON (empty sentences, make_metafile-ready) and the
    # learned-props meta TSV the captioner's eval phase reads
    anet = {}
    for vid, rows in (best_preds or {}).items():
        dur = val_ds.videos[vid]["duration"]
        anet[vid] = {"duration": dur,
                     "timestamps": [[r[0], r[1]] for r in rows],
                     "sentences": ["" for _ in rows]}
    json_path = os.path.join(args.log_dir, "learned_proposals.json")
    with open(json_path, "w") as f:
        json.dump(anet, f)
    tsv_path = os.path.join(args.log_dir, "learned_props.csv")
    n_rows = make_metafile(json_path, tsv_path, phase="learned_props")
    print(json.dumps({"best_val_F1": best_f1, "proposals_json": json_path,
                      "learned_props_tsv": tsv_path, "rows": n_rows}))
    return best_f1


if __name__ == "__main__":
    main()
