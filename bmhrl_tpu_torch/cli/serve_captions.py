"""Batch-captioning serving CLI of the PyTorch/CUDA port: caption every
proposal in a JSON or TSV (the port of cli/serve_captions.py, flag for
flag).

    python -m bmhrl_tpu_torch.cli.serve_captions \\
        --proposals data/val_1_no_missings.json \\
        --video_features_path DIR --audio_features_path DIR \\
        --train_meta_path ./data/train.csv \\
        --torch_checkpoint bm_hrl_agent.pt --out submission.json \\
        [--mode BMHRL|DETR|AHRL|VHRL] [--batch_size 256] [--device cuda]

Weights come from a training checkpoint of the port (``--checkpoint_dir``,
a ``run_training`` run's ``.../checkpoints/E_{n}``; every mode) or from a
reference-layout ``.pt`` (``--torch_checkpoint``, BMHRL; the JAX package
writes one from a trained tree with its ``export_torch_bmhrl``); without
either the model has random weights. An orbax directory (the JAX
package's checkpoints) exits with a message.

``--mesh n`` serves data-parallel on n ranks started from this one command
(one card each; ``--device cpu``: gloo ranks on the CPU): each batch of
``--batch_size`` is row-padded to a multiple of n as the JAX server pads
for its data axis, each rank decodes its rows, and rank 0 writes the
submission (``serve.CaptionServer(mesh=...)``).

``--export_bundle DIR`` exports, instead of serving, the decode programs
(``serve_export``) for exactly the shapes this request set plans at
``--batch_size``, greedy or with ``--beam_width`` / ``--length_penalty``,
on ``--device``, in this one process whatever ``--mesh`` says (the
programs take any rows a rank holds); ``--from_bundle DIR`` serves such a
bundle on ``--device`` (the platform it was exported on) without building
a model, with ``--mesh n`` on n ranks, each loading the bundle
(``serve_export.ExportedCaptionServer(mesh=...)``; a batch size n does
not divide exits before the ranks start).
Prints one JSON stats line (clips/s, latency percentiles, shape count) and
returns the stats (the manifest after an export). ``--profile_dir DIR``
serves (on rank 0) under ``torch.profiler`` with the server's spans on a
``utils.profiling.StepTimer`` (each span also a ``record_function`` in
the trace), writes ``DIR/serve_trace.json`` and prints one more line after
the stats, ``{"spans": <the timer's summary>}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os


def refuse_unported(args) -> None:
    """Exit with a message for two sources of weights at once and for a
    ``--checkpoint_dir`` that is not a checkpoint of the port."""
    from bmhrl_tpu_torch.utils.checkpoint import refuse_orbax

    if getattr(args, "checkpoint_dir", None):
        if args.torch_checkpoint:
            raise SystemExit("--checkpoint_dir and --torch_checkpoint are "
                             "two sources of weights: give one")
        refuse_orbax(args.checkpoint_dir)


def load_captioner(cfg, voc_size: int, torch_checkpoint, device,
                   checkpoint_dir=None):
    """The captioner of ``cfg.mode`` on ``device``, in eval mode: weights
    from a reference ``.pt`` (BMHRL only, as in the JAX CLIs), from the
    port's training checkpoint ``checkpoint_dir``, or random ones from
    seed 0 with the flax initialisers' scales."""
    from bmhrl_tpu_torch.train.loop import build_model
    from bmhrl_tpu_torch.utils.checkpoint import (import_torch_bmhrl,
                                                  load_model_params)
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = build_model(cfg, voc_size, device)
    if torch_checkpoint:
        if cfg.mode != "BMHRL":
            raise SystemExit(f"--torch_checkpoint unsupported for {cfg.mode}")
        load_jax_params(model, import_torch_bmhrl(torch_checkpoint,
                                                  cfg.rl_att_layers))
    elif checkpoint_dir:
        load_model_params(checkpoint_dir, model)
        print(f"restored {checkpoint_dir}")
    else:
        load_jax_params(model, random_module_params(model, seed=0))
    return model.eval().requires_grad_(False)


def main(argv=None):
    p = argparse.ArgumentParser(description="Batch caption serving "
                                            "(PyTorch/CUDA port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--proposals", help="ANet-format proposals JSON")
    src.add_argument("--meta", help="reference meta TSV (captions ignored)")
    p.add_argument("--durations_json", default=None,
                   help="video durations ({vid: seconds} or ANet JSON); "
                        "required when --proposals is a submission-style "
                        "file (those carry no durations)")
    p.add_argument("--video_features_path", required=True)
    p.add_argument("--audio_features_path", required=True)
    p.add_argument("--train_meta_path", default="./data/train.csv",
                   help="vocab source (must match training)")
    p.add_argument("--glove_path", default=None)
    p.add_argument("--checkpoint_dir", default=None,
                   help="a training checkpoint of the port "
                        "(.../checkpoints/E_n)")
    p.add_argument("--torch_checkpoint", default=None,
                   help="reference bm_hrl_agent.pt; random init if omitted")
    p.add_argument("--mode", default="BMHRL",
                   choices=["BMHRL", "DETR", "AHRL", "VHRL"])
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--beam_width", type=int, default=1,
                   help="beam-search width (1 = greedy); quality knob")
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="GNMT length-normalization exponent for beam rank")
    p.add_argument("--sample", action="store_true", default=False,
                   help="stochastic decode instead of greedy/beam")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0,
                   help="sampling truncation: keep the k best tokens")
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling mass (0 = off)")
    p.add_argument("--sample_seed", type=int, default=0)
    p.add_argument("--max_len", type=int, default=30)
    p.add_argument("--mesh", type=int, default=1,
                   help="data-parallel ranks, one per card (with --device "
                        "cpu, gloo ranks on the CPU)")
    p.add_argument("--io_threads", type=int, default=8)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--config_json", default=None,
                   help="JSON dict of extra Config overrides "
                        '(e.g. \'{"d_model": 64}\' for ablation models)')
    p.add_argument("--export_bundle", default=None,
                   help="instead of serving, export the decode programs for "
                        "exactly the shapes this request set plans to, "
                        "into this bundle dir (see serve_export)")
    p.add_argument("--from_bundle", default=None,
                   help="serve from a bundle dir exported on this device "
                        "(no model build; the model flags are ignored)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace dir (serve_trace.json) and a "
                        "spans line after the stats")
    p.add_argument("--out", required=True, help="submission JSON path")
    args = p.parse_args(argv)
    refuse_unported(args)

    from bmhrl_tpu_torch.serve import (read_durations_json, read_meta_tsv,
                                       read_proposals_json)

    durations = (read_durations_json(args.durations_json)
                 if args.durations_json else None)
    reqs = (read_proposals_json(args.proposals, durations)
            if args.proposals else read_meta_tsv(args.meta))
    print(f"{len(reqs)} clip requests")

    if args.from_bundle:
        from bmhrl_tpu_torch.serve_export import (BundleError, check_world,
                                                  read_manifest)

        try:
            manifest = read_manifest(args.from_bundle, args.device)
        except BundleError as e:
            raise SystemExit(str(e))
        if args.mesh == 1:
            return _serve_bundle(args, reqs, args.device)
        check_world(manifest, args.mesh)
    if args.mesh > 1 and not args.export_bundle:
        from bmhrl_tpu_torch.parallel.mesh import spawn

        return spawn(_serve_rank, args.mesh, args.device, args=(args, reqs))
    return _build_and_serve(args, reqs, args.device)


def _serve_rank(mesh, args, reqs):
    """One rank of ``--mesh``: its server; rank 0 writes the submission."""
    if args.from_bundle:
        return _serve_bundle(args, reqs, mesh.device, mesh)
    return _build_and_serve(args, reqs, mesh.device, mesh)


def _serve_bundle(args, reqs, device, mesh=None):
    """Serve ``reqs`` from the bundle of ``--from_bundle`` on ``device``
    (``mesh``: this rank's; each rank prints its load seconds)."""
    from bmhrl_tpu_torch.serve_export import ExportedCaptionServer

    server = ExportedCaptionServer(
        args.from_bundle, args.video_features_path,
        args.audio_features_path, device=device, mesh=mesh)
    if mesh is not None:
        print(json.dumps({"rank": mesh.rank, "load_s": server.load_s}),
              flush=True)
    return _serve(server, reqs, args, mesh is None or mesh.is_main)


def _build_and_serve(args, reqs, device, mesh=None):
    """The model of the flags on ``device``, then export it
    (``--export_bundle``) or serve ``reqs``."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.serve import CaptionServer

    overrides = json.loads(args.config_json) if args.config_json else {}
    cfg = Config(
        mode=args.mode, train_meta_path=args.train_meta_path,
        glove_path=args.glove_path, max_len=args.max_len,
        compute_dtype=args.compute_dtype, to_log=False,
        video_features_path=args.video_features_path,
        audio_features_path=args.audio_features_path,
        mesh_shape=(args.mesh, 1), **overrides)
    vocab = build_vocab_from_tsv(cfg.train_meta_path, cfg.min_freq_caps,
                                 cfg.glove_path, cfg.d_model_caps)
    model = load_captioner(cfg, len(vocab), args.torch_checkpoint,
                           device, args.checkpoint_dir)
    if args.export_bundle:
        from bmhrl_tpu_torch.serve import plan_batches
        from bmhrl_tpu_torch.serve_export import export_decode_bundle

        plan = plan_batches(reqs, cfg, args.batch_size)
        shapes = sorted({(args.batch_size, vb, ab) for _, vb, ab in plan})
        manifest = export_decode_bundle(
            cfg, model, vocab.itos, shapes, args.export_bundle,
            beam_width=args.beam_width, length_penalty=args.length_penalty)
        print(json.dumps({"exported": manifest["shapes"],
                          "bundle": args.export_bundle}))
        return manifest
    server = CaptionServer(cfg, model, vocab.itos, device=device,
                           beam_width=args.beam_width,
                           length_penalty=args.length_penalty,
                           sample=args.sample, temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p,
                           sample_seed=args.sample_seed, mesh=mesh)
    return _serve(server, reqs, args, mesh is None or mesh.is_main)


def _serve(server, reqs, args, main: bool = True):
    """Caption ``reqs``; rank 0 (``main``) writes the submission and
    prints the stats line (``--profile_dir``: the module docstring's)."""
    profiler, timer = contextlib.nullcontext(), None
    if args.profile_dir and main:
        from torch.profiler import ProfilerActivity, profile

        from bmhrl_tpu_torch.utils.profiling import StepTimer

        timer = StepTimer()
        server.spans = timer.phase
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if server.device.type == "cuda" else []))
    with profiler:
        predictions, stats = server.caption(reqs, batch_size=args.batch_size,
                                            io_threads=args.io_threads)
    if main:
        with open(args.out, "w") as f:
            json.dump(predictions, f)
        print(json.dumps(stats.summary()))
    if timer is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir,
                                                  "serve_trace.json"))
        print(json.dumps({"spans": timer.summary()}))
    return stats


if __name__ == "__main__":
    main()
