"""Training CLI of the PyTorch/CUDA port (the port of cli/run_training.py,
flag for flag, plus ``--device``): the flags map onto ``Config`` fields
and run ``train.loop.train_rl_cap``.

    python -m bmhrl_tpu_torch.cli.run_training --mode BMHRL --scorer CIDER \\
        --B 16 [--device cuda]

``--mode DETR`` trains the DETR captioner (``--with_reinforce``,
``--pre_goal_attention``), ``--mode verbose`` runs the loss-decomposition
pass (in one process). ``--mesh_data d`` trains data-parallel on d ranks
started from this one command (0: every card; ``--device cpu``: gloo
ranks on the CPU); ``--B`` is the batch of one rank. ``--mesh_model`` > 1 exits: the port has no
model axis. ``--rl_pretrained_model_dir`` and ``--auto_resume``
read the port's own checkpoints (a JAX run's orbax directory exits with a
message).
"""
from __future__ import annotations

import argparse
from pprint import pprint

from bmhrl_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run experiment (bmhrl_tpu_torch)")
    # rl agent
    p.add_argument("--rl_high_level_enc_d", type=int, default=256)
    p.add_argument("--rl_low_level_enc_d", type=int, default=512)
    p.add_argument("--rl_worker_lstm", type=int, default=1024)
    p.add_argument("--rl_manager_lstm", type=int, default=256)
    p.add_argument("--rl_goal_d", type=int, default=64)
    p.add_argument("--rl_attn_d", type=int, default=512)
    p.add_argument("--rl_critic_path", type=str, default="./data/models/critic.cp")
    p.add_argument("--rl_critic_score_threshhold", type=float, default=0.25)
    p.add_argument("--rl_gamma_worker", type=float, default=0.0)
    p.add_argument("--rl_gamma_manager", type=float, default=0.0)
    p.add_argument("--rl_pretrained_model_dir", type=str, default=None)
    p.add_argument("--rl_train_worker", type=bool, default=True)
    p.add_argument("--rl_warmstart_epochs", type=int, default=0)
    p.add_argument("--rl_projection_d", type=int, default=512)
    p.add_argument("--rl_att_heads", type=int, default=4)
    p.add_argument("--rl_att_layers", type=int, default=2)
    p.add_argument("--rl_reward_weight_worker", type=float, default=1)
    p.add_argument("--rl_reward_weight_manager", type=float, default=2)
    p.add_argument("--rl_ff_c", type=int, default=2048)
    p.add_argument("--rl_ff_v", type=int, default=1024)
    p.add_argument("--rl_ff_a", type=int, default=512)
    p.add_argument("--rl_stabilize", type=bool, default=True)
    p.add_argument("--rl_value_function_lr", type=float, default=1e-4)
    p.add_argument("--rl_cap_warmstart_lr", type=float, default=1e-4)
    p.add_argument("--rl_cap_lr", type=float, default=1e-4)
    # mode / scorer
    p.add_argument("--mode", type=str, default="BMHRL",
                   choices=["DETR", "BMHRL", "BM", "AHRL", "VHRL", "verbose", "eval"])
    p.add_argument("--scorer", type=str, default="CIDER",
                   choices=["CIDER", "METEOR", "BLEU"])
    p.add_argument("--with_reinforce", action="store_true", default=False)
    p.add_argument("--pre_goal_attention", action="store_true", default=False)
    # data
    p.add_argument("--train_meta_path", type=str, default="./data/train.csv")
    p.add_argument("--val_1_meta_path", type=str, default="./data/val_1.csv")
    p.add_argument("--val_2_meta_path", type=str, default="./data/val_2.csv")
    p.add_argument("--vatex_meta_path", type=str, default="./data/vatex_val.csv")
    p.add_argument("--msrvtt_meta_path", type=str, default="./data/msrvtt_val.csv")
    p.add_argument("--modality", type=str, default="audio_video",
                   choices=["audio", "video", "audio_video"])
    p.add_argument("--video_feature_name", type=str, default="i3d")
    p.add_argument("--audio_feature_name", type=str, default="vggish")
    p.add_argument("--video_features_path", type=str,
                   default="./data/i3d_25fps_stack64step64_2stream_npy/")
    p.add_argument("--audio_features_path", type=str, default="./data/vggish_npy/")
    p.add_argument("--d_vid", type=int, default=1024)
    p.add_argument("--d_aud", type=int, default=128)
    p.add_argument("--word_emb_caps", type=str, default="glove.840B.300d")
    p.add_argument("--glove_path", type=str, default=None)
    p.add_argument("--unfreeze_word_emb", action="store_true", default=False)
    p.add_argument("--start_token", type=str, default="<s>")
    p.add_argument("--end_token", type=str, default="</s>")
    p.add_argument("--pad_token", type=str, default="<blank>")
    p.add_argument("--max_len", type=int, default=30)
    p.add_argument("--min_freq_caps", type=int, default=1)
    # optimization
    p.add_argument("--optimizer", type=str, default="adam", choices=["adam"])
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.999])
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--B", type=int, default=16)
    p.add_argument("--inf_B_coeff", type=int, default=2)
    p.add_argument("--epoch_num", type=int, default=50)
    p.add_argument("--one_by_one_starts_at", type=int, default=0)
    p.add_argument("--early_stop_after", type=int, default=30)
    p.add_argument("--smoothing", type=float, default=0.7)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--scheduler", type=str, default="constant",
                   choices=["constant", "reduce_on_plateau"])
    p.add_argument("--pad_audio_feats_up_to", type=int, default=800)
    p.add_argument("--pad_video_feats_up_to", type=int, default=300)
    # model (ref: runTraining.py:146-168)
    p.add_argument("--d_model", type=int, default=1024)
    p.add_argument("--d_model_caps", type=int, default=300)
    p.add_argument("--d_model_video", type=int, default=None)
    p.add_argument("--d_model_audio", type=int, default=None)
    p.add_argument("--use_linear_embedder", action="store_true", default=False)
    p.add_argument("--dout_p", type=float, default=0.1)
    # evaluation
    p.add_argument("--reference_paths", type=str, nargs="+", default=[
        "./data/val_1_no_missings.json", "./data/val_2_no_missings.json",
        "./data/vatex_no_missings.json", "./data/msrvtt_no_missings.json"])
    p.add_argument("--tIoUs", type=float, nargs="+", default=[0.3, 0.5, 0.7, 0.9])
    p.add_argument("--max_prop_per_vid", type=int, default=100)
    p.add_argument("--prop_pred_path", type=str, default=None,
                   help="path to a .json file with proposal predictions")
    p.add_argument("--val_prop_meta_path", type=str, default=None,
                   help="predicted-proposals meta TSV; with --mode eval "
                        "adds the learned_props phase (full tIoU sweep "
                        "over all reference files)")
    p.add_argument("--meteor_preset", type=str, default="nltk",
                   choices=["nltk", "meteor15"])
    p.add_argument("--meteor_paraphrase_path", type=str, default=None,
                   help="METEOR 1.5 paraphrase table (e.g. the jar's "
                        "paraphrase-en.gz) to enable the paraphrase stage")
    # logging
    p.add_argument("--log_dir", type=str, default="./log/")
    p.add_argument("--dont_log", dest="to_log", action="store_false")
    p.add_argument("--procedure", type=str, default="train_rl_cap",
                   choices=["train_rl_cap"])
    p.add_argument("--device_ids", type=int, nargs="+", default=[0],
                   help="accepted for reference-CLI compatibility; the mesh "
                        "flags below control the devices")
    p.add_argument("--debug", action="store_true", default=False)
    # --- TPU-native flags ---
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel ranks, one per card, started from "
                        "this command (0 = every card; with --device cpu, "
                        "gloo ranks on the CPU)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel mesh axis size (only 1: the port "
                        "has no tensor parallelism)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--eval_max_batches", type=int, default=None)
    p.add_argument("--train_with_all", action="store_true", default=False,
                   help="concat VATEX training captions (ref train_with_all)")
    p.add_argument("--vatex_training_json", type=str,
                   default="./data/vatex_training.json")
    p.add_argument("--debug_nans", action="store_true", default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace dir (first epoch)")
    p.add_argument("--auto_resume", action="store_true", default=False,
                   help="restore the newest E_{n} checkpoint under "
                        "--log_dir and continue at epoch n+1 "
                        "(preemption-safe; data order is epoch-seeded)")
    p.add_argument("--beam_width", type=int, default=1,
                   help="eval-decode beam width (1 = greedy like the "
                        "reference); quality knob for validation/eval mode")
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="GNMT length-normalization exponent for beam rank")
    p.add_argument("--no_pallas_attention", dest="use_pallas_attention",
                   action="store_false", default=True)
    p.add_argument("--no_rl_pipeline", dest="rl_pipeline",
                   action="store_false", default=True,
                   help="disable the one-batch-deep host-score pipeline "
                        "(restores the reference's strictly sequential "
                        "rollout -> score -> update order)")
    # --- the port's flag ---
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(to_log=True)
    return p


def create_config(argv=None) -> Config:
    args = build_parser().parse_args(argv)
    d = vars(args).copy()
    d["mesh_shape"] = (d.pop("mesh_data"), d.pop("mesh_model"))
    d["betas"] = tuple(d["betas"])
    for k in ("device_ids", "debug", "max_steps_per_epoch", "device"):
        d.pop(k, None)
    return Config(**d)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh_model > 1:
        raise SystemExit("--mesh_model > 1: the port has no model axis (no "
                         "tensor parallelism; the JAX loop replicates that "
                         "axis, so (d, m) trains as (d, 1)): use "
                         "--mesh_data d")
    pprint(vars(args))
    cfg = create_config(argv)
    from bmhrl_tpu_torch.parallel.mesh import resolve_data
    from bmhrl_tpu_torch.train.loop import train_ranks, train_rl_cap

    if cfg.mesh_shape[0] <= 0:  # every card of --device
        cfg = cfg.replace(mesh_shape=(resolve_data(cfg.mesh_shape,
                                                   args.device), 1))

    if cfg.mesh_shape[0] > 1:
        out = train_ranks(cfg, args.device, args.max_steps_per_epoch)
    else:
        out = train_rl_cap(cfg, max_steps_per_epoch=args.max_steps_per_epoch,
                           device=args.device)
    if cfg.mode == "eval" and isinstance(out, dict):
        for phase, metrics in out.items():
            line = "  ".join(f"{k}={v * 100:.2f}" for k, v in metrics.items()
                             if isinstance(v, float))
            print(f"[eval] {phase}: {line}")
    return out


if __name__ == "__main__":
    main()
