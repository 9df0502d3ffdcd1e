"""Caption one clip with the PyTorch/CUDA port (the port of
cli/single_video.py, flag for flag): build the agent and the vocabulary,
load the features from three .npy files, decode one caption.

    python -m bmhrl_tpu_torch.cli.single_video \\
        --rgb women_long_jump_rgb.npy --flow women_long_jump_flow.npy \\
        --audio women_long_jump_vggish.npy \\
        --train_meta_path ./data/train.csv \\
        [--torch_checkpoint bm_hrl_agent.pt | --checkpoint_dir RUN/E_n] \\
        [--mode BMHRL|DETR|AHRL|VHRL] [--device cuda]

Prints the sentence and returns it. ``--checkpoint_dir`` reads a training
checkpoint of the port (an orbax directory exits with a message);
``--mode`` (the port's addition; the JAX CLI serves BMHRL only) picks the
family.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Caption one clip "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--rgb", required=True)
    p.add_argument("--flow", required=True)
    p.add_argument("--audio", required=True)
    p.add_argument("--train_meta_path", default="./data/train.csv")
    p.add_argument("--checkpoint_dir", default=None,
                   help="a training checkpoint of the port "
                        "(.../checkpoints/E_n)")
    p.add_argument("--mode", default="BMHRL",
                   choices=["BMHRL", "DETR", "AHRL", "VHRL"])
    p.add_argument("--torch_checkpoint", default=None,
                   help="reference bm_hrl_agent.pt; random init if omitted")
    p.add_argument("--glove_path", default=None)
    p.add_argument("--max_len", type=int, default=30)
    p.add_argument("--beam_width", type=int, default=1,
                   help="beam-search width (1 = greedy)")
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=0.0, help="0 = full clip")
    p.add_argument("--duration", type=float, default=0.0)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)

    import torch

    from bmhrl_tpu_torch import resolve_device
    from bmhrl_tpu_torch.cli.serve_captions import (load_captioner,
                                                    refuse_unported)
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.features import crop_a_segment
    from bmhrl_tpu_torch.data.vocab import (BOS, EOS, PAD,
                                            build_vocab_from_tsv)
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode, detokenize

    refuse_unported(args)
    device = resolve_device(args.device)
    cfg = Config(mode=args.mode, train_meta_path=args.train_meta_path,
                 glove_path=args.glove_path, max_len=args.max_len,
                 compute_dtype=args.compute_dtype, to_log=False,
                 mesh_shape=(1, 1))
    vocab = build_vocab_from_tsv(cfg.train_meta_path, cfg.min_freq_caps,
                                 cfg.glove_path, cfg.d_model_caps)
    model = load_captioner(cfg, len(vocab), args.torch_checkpoint, device,
                           args.checkpoint_dir)
    if args.torch_checkpoint:
        print(f"imported torch checkpoint {args.torch_checkpoint}")

    feats = {}
    for key in ("rgb", "flow", "audio"):
        x = np.load(getattr(args, key)).astype(np.float32)
        if args.end > 0:
            x = crop_a_segment(x, args.start, args.end,
                               args.duration or args.end)
        feats[key] = torch.from_numpy(x)[None].to(device)
    masks_src = make_masks(feats)
    if args.beam_width > 1:
        tokens, _ = beam_decode(model, feats, masks_src, cfg.max_len, BOS,
                                EOS, PAD, beam_width=args.beam_width,
                                length_penalty=args.length_penalty)
    else:
        tokens, _ = decode(model, feats, masks_src, cfg.max_len, BOS, EOS,
                           PAD)
    sentence = detokenize(tokens.cpu().numpy(), vocab.itos)[0]
    print(sentence)
    return sentence


if __name__ == "__main__":
    main()
