"""Learning proof of the port (the port of cli/synthetic_proof.py): write
the synthetic 6-class corpus (``utils.synthetic.generate``) and run the
training procedure on it, printing the held-out METEOR.

Default flags are the JAX proof's full-size run; ``--small`` switches to
the reduced dims of its CPU regression test.

    python -m bmhrl_tpu_torch.cli.synthetic_proof --out DIR --epochs 12 \\
        --warmstart 4 [--device cuda]
    python -m bmhrl_tpu_torch.cli.synthetic_proof --out DIR --small \\
        --epochs 4 --device cpu
    python -m bmhrl_tpu_torch.cli.synthetic_proof --out DIR --generate_only

``--mesh_data d`` trains on d data-parallel ranks (``--B`` per rank), as
``run_training`` does.
"""
from __future__ import annotations

import argparse
import os

from bmhrl_tpu_torch.config import Config


def build_config(paths, args):
    small = dict(
        d_model=64, d_model_caps=64, rl_att_heads=2, rl_att_layers=1,
        rl_ff_c=64, rl_ff_v=64, rl_ff_a=32, rl_goal_d=16,
        caption_buckets=(16,), video_buckets=(20,), audio_buckets=(48,),
        compute_dtype="float32",
        # small models tolerate (and need) a hotter LR to converge within
        # the few epochs a CPU regression test can afford; the reference's
        # 0.7 label smoothing also needs taming at these dims or greedy
        # decode degenerates into repetition while TF loss sits at the floor
        rl_cap_warmstart_lr=1e-3, rl_cap_lr=3e-4, rl_value_function_lr=1e-3,
        smoothing=0.1,
    ) if args.small else {}
    return Config(
        train_meta_path=paths["train"],
        val_1_meta_path=paths["val_1"],
        vatex_meta_path="/nonexistent", msrvtt_meta_path="/nonexistent",
        video_features_path=paths["video_features_path"],
        audio_features_path=paths["audio_features_path"],
        reference_paths=(paths["ref"],) * 4,
        rl_critic_path="/nonexistent",  # critic defaults to random-init
        scorer=args.scorer,
        B=args.B, mesh_shape=(args.mesh_data, 1),
        epoch_num=args.epochs, rl_warmstart_epochs=args.warmstart,
        one_by_one_starts_at=args.eval_from,
        early_stop_after=10_000,
        max_len=12, seed=args.seed,
        log_dir=os.path.join(args.out, "log"),
        **small)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--clips_per_class", type=int, default=30)
    p.add_argument("--val_per_class", type=int, default=4)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--warmstart", type=int, default=4)
    p.add_argument("--eval_from", type=int, default=0)
    p.add_argument("--B", type=int, default=16)
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel ranks (0 = every card)")
    p.add_argument("--scorer", default="CIDER",
                   choices=["CIDER", "METEOR", "BLEU"])
    p.add_argument("--small", action="store_true",
                   help="reduced model dims (fast CPU check)")
    p.add_argument("--generate_only", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from bmhrl_tpu_torch.utils.synthetic import generate

    paths = generate(args.out, args.clips_per_class, args.val_per_class,
                     args.noise, args.seed)
    print(f"corpus written to {args.out}")
    if args.generate_only:
        return None

    from bmhrl_tpu_torch.parallel.mesh import resolve_data
    from bmhrl_tpu_torch.train.loop import train_ranks, train_rl_cap

    args.mesh_data = resolve_data((args.mesh_data, 1), args.device)
    cfg = build_config(paths, args)
    if args.mesh_data > 1:
        out = train_ranks(cfg, args.device)
    else:
        out = train_rl_cap(cfg, device=args.device)
    print(f"best held-out METEOR: {out['best_metric'] * 100:.1f}")
    return out


if __name__ == "__main__":
    main()
