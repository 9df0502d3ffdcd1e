"""Dense video captioning in one command on the PyTorch/CUDA port (the
port of cli/dense_caption.py, flag for flag, plus ``--device``): full-clip
features -> ``MultimodalProposalGenerator`` -> top-k / NMS post-processing
-> batch captioning (``serve.CaptionServer``) -> one submission JSON whose
segments carry the caption and the proposal's confidence
(``proposal_score``).

    python -m bmhrl_tpu_torch.cli.dense_caption \\
        --durations_json videos.json \\
        --video_features_path .../i3d --audio_features_path .../vggish \\
        --proposal_checkpoint ./log/props \\
        --train_meta_path ./data/train.csv --torch_checkpoint agent.pt \\
        --out dense.json [--max_props 10 --nms_tiou_thresh 0.5 \\
        --beam_width 4] [--device cuda]

``--proposal_checkpoint`` is a log directory of
``bmhrl_tpu_torch.cli.train_proposals`` (``props.pt`` + ``anchors.npy``;
a JAX run's orbax directory is refused with a message). The captioner's
weights come from a reference ``.pt`` (``--torch_checkpoint``, BMHRL) or
the port's training checkpoint (``--checkpoint_dir``, every ``--mode``),
not both; without either it is random (seed 0). Videos come from
``--durations_json`` ({vid: seconds} or ANet-format). Prints one summary
JSON line and returns the submission.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Propose + caption in one pass "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--durations_json", required=True,
                   help="videos to process: {vid: seconds} or ANet JSON")
    p.add_argument("--video_features_path", required=True)
    p.add_argument("--audio_features_path", required=True)
    p.add_argument("--proposal_checkpoint", required=True,
                   help="a train_proposals log dir (props.pt + anchors.npy)")
    p.add_argument("--train_meta_path", default="./data/train.csv")
    p.add_argument("--glove_path", default=None)
    p.add_argument("--checkpoint_dir", default=None,
                   help="a training checkpoint of the port "
                        "(.../checkpoints/E_n)")
    p.add_argument("--torch_checkpoint", default=None,
                   help="reference bm_hrl_agent.pt")
    p.add_argument("--mode", default="BMHRL",
                   choices=["BMHRL", "DETR", "AHRL", "VHRL"])
    # proposal-model dims (must match the checkpoint)
    p.add_argument("--prop_d_model", type=int, default=1024)
    p.add_argument("--prop_d_model_aud", type=int, default=128)
    p.add_argument("--prop_att_heads", type=int, default=4)
    p.add_argument("--prop_att_layers", type=int, default=2)
    p.add_argument("--prop_d_ff_v", type=int, default=1024)
    p.add_argument("--prop_d_ff_a", type=int, default=512)
    p.add_argument("--d_vid", type=int, default=1024)
    p.add_argument("--d_aud", type=int, default=128)
    p.add_argument("--pad_video_to", type=int, default=300)
    p.add_argument("--pad_audio_to", type=int, default=800)
    p.add_argument("--prop_B", type=int, default=8)
    p.add_argument("--max_props", type=int, default=10,
                   help="proposals kept per video (top confidence)")
    p.add_argument("--nms_tiou_thresh", type=float, default=0.5)
    # captioning knobs (as cli.serve_captions)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--beam_width", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--max_len", type=int, default=30)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--config_json", default=None,
                   help="captioner Config overrides (ablation dims)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--out", required=True)
    return p


def propose(args, durations, device):
    """Stage 1: {vid: [[start, end, conf], ...]}, the number of
    proposals, the stage's wall seconds and the first batch's (which
    carries the lazy set-up: the kernels' build, cuBLAS)."""
    import numpy as np
    import torch

    from bmhrl_tpu_torch.cli.train_proposals import postprocess
    from bmhrl_tpu_torch.data.proposal import ProposalDataset
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
    from bmhrl_tpu_torch.utils.checkpoint import load_proposal_checkpoint

    anchors = np.load(os.path.join(args.proposal_checkpoint, "anchors.npy"))
    with tempfile.TemporaryDirectory() as tmp:
        # a ProposalDataset over the full clips: one [0, duration] row per
        # video feeds the feature loader; targets are unused at inference
        meta = os.path.join(tmp, "videos.csv")
        with open(meta, "w") as f:
            f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
            for i, (vid, dur) in enumerate(durations.items()):
                f.write(f"{vid}\t-\t0.0\t{dur}\t{dur}\tinfer\t{i}\n")
        ds = ProposalDataset(meta, args.video_features_path,
                             args.audio_features_path,
                             pad_video_to=args.pad_video_to,
                             pad_audio_to=args.pad_audio_to,
                             d_vid=args.d_vid, d_aud=args.d_aud)
    ds.anchors = anchors
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    model = MultimodalProposalGenerator(
        d_vid=args.d_vid, d_aud=args.d_aud, d_model=args.prop_d_model,
        d_model_aud=args.prop_d_model_aud, d_ff_v=args.prop_d_ff_v,
        d_ff_a=args.prop_d_ff_a, att_heads=args.prop_att_heads,
        att_layers=args.prop_att_layers, num_anchors=len(anchors),
        dtype=dtype, device=device)
    sf = ProposalStepFactory(model, device=device)
    state = load_proposal_checkpoint(args.proposal_checkpoint, model,
                                     sf.init_state())
    print(f"proposal model restored from {args.proposal_checkpoint}")

    proposals = {}
    t0 = time.time()
    first_s = 0.0
    for i, batch in enumerate(ds.batches(0, args.prop_B, shuffle=False)):
        preds = sf.predict(state, batch).cpu().numpy()
        if i == 0:
            first_s = time.time() - t0
        per_vid = postprocess(preds, batch["durations"], args.max_props,
                              args.nms_tiou_thresh)
        for vid, rows in zip(batch["video_ids"], per_vid):
            proposals[vid] = rows
    wall_s = time.time() - t0
    n_props = sum(len(v) for v in proposals.values())
    print(f"{n_props} proposals across {len(proposals)} videos "
          f"in {wall_s:.2f}s")
    return proposals, n_props, wall_s, first_s


def main(argv=None):
    args = build_parser().parse_args(argv)

    from bmhrl_tpu_torch.cli.serve_captions import (load_captioner,
                                                    refuse_unported)
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.serve import (CaptionServer, ClipRequest,
                                       read_durations_json)
    from bmhrl_tpu_torch.utils.checkpoint import PROPOSAL_NAME, refuse_orbax

    refuse_unported(args)
    refuse_orbax(args.proposal_checkpoint, PROPOSAL_NAME)
    durations = read_durations_json(args.durations_json)
    print(f"{len(durations)} videos")

    # ---- stage 1: propose ------------------------------------------------
    proposals, n_props, propose_wall_s, prop_first_s = propose(
        args, durations, args.device)

    # ---- stage 2: caption ------------------------------------------------
    overrides = json.loads(args.config_json) if args.config_json else {}
    cfg = Config(mode=args.mode, train_meta_path=args.train_meta_path,
                 glove_path=args.glove_path, max_len=args.max_len,
                 compute_dtype=args.compute_dtype, to_log=False,
                 video_features_path=args.video_features_path,
                 audio_features_path=args.audio_features_path,
                 mesh_shape=(1, 1), **overrides)
    vocab = build_vocab_from_tsv(cfg.train_meta_path, cfg.min_freq_caps,
                                 cfg.glove_path, cfg.d_model_caps)
    model = load_captioner(cfg, len(vocab), args.torch_checkpoint,
                           args.device, args.checkpoint_dir)

    reqs, confs = [], []
    for vid, rows in proposals.items():
        for s, e, conf in rows:
            reqs.append(ClipRequest(vid, float(s), float(e),
                                    durations[vid]))
            confs.append(float(conf))
    server = CaptionServer(cfg, model, vocab.itos, device=args.device,
                           beam_width=args.beam_width,
                           length_penalty=args.length_penalty)
    predictions, stats = server.caption(reqs, batch_size=args.batch_size)
    # the proposal confidences: requests map one to one, in order, onto the
    # segments of their video
    seg_iters = {}
    for r, conf in zip(reqs, confs):
        segs = predictions["results"][r.video_id]
        idx = seg_iters.get(r.video_id, 0)
        segs[idx]["proposal_score"] = conf
        seg_iters[r.video_id] = idx + 1
    with open(args.out, "w") as f:
        json.dump(predictions, f)
    caption = stats.summary()
    e2e_s = propose_wall_s + caption["wall_s"]
    summary = {
        "videos": len(durations), "proposals": n_props,
        "propose_wall_s": round(propose_wall_s, 3),
        "propose_compile_s": round(prop_first_s, 3),
        "props_per_sec": round(n_props / propose_wall_s, 2)
        if propose_wall_s else 0.0,
        "caption": caption,
        "e2e_wall_s": round(e2e_s, 3),
        "e2e_clips_per_sec": round(n_props / e2e_s, 2) if e2e_s else 0.0,
    }
    print(json.dumps(summary))
    return predictions


if __name__ == "__main__":
    main()
