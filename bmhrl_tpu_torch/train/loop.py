"""Training orchestration (the port of bmhrl_tpu/train/loop.py):
``train_rl_cap(cfg)`` assembles the dataset, the captioner, its value
nets, the reward scorer and ``train.steps.StepFactory``, then runs the
reference's procedure: warmstart epochs, the switch to RL (one epoch late,
as the reference switches), worker/manager alternation, the LR scheduler
on the teacher-forced validation loss, greedy or beam validation scored
with METEOR, checkpoints and early stop, and auto-resume.

The host scores rewards while the card works (``cfg.rl_pipeline``): the
step of batch t+1 is dispatched before batch t is scored. Right after a
step is dispatched, the tensors the host scores are copied into pinned host
buffers behind it and an event is recorded, so scoring batch t waits for
batch t's work only (a plain ``.cpu()`` issued after step t+1 would wait
for that step as well, on the one stream). The steps update parameters in
place, and stream order makes rollout t+1, enqueued before update t, read
the parameters from before that update: the JAX package's "one update
stale" pipeline. ``rl_pipeline=False`` keeps the reference's sequential
order. Loss terms stay on the device and are fetched once per epoch, so
the host score's fetch is a step's one wait for the card.

Each step's random draws come from a seed derived from ``cfg.seed``, the
epoch and the step index (``step_seed``); ``rl_update`` gets its rollout's
seed, since it re-runs that forward.

Data parallel (``mesh``, ``parallel.mesh``): every rank runs this loop on
its rows of each global batch (the dataset shards them), with replicated
modules (broadcast from rank 0) and steps whose updates are the global
batch's. The host scores and the DETR's matching run on the rank's rows.
Rank 0 logs, writes the validation submission, scores METEOR (over every
rank's predictions, gathered) and the checkpoints; the metrics, the LR
schedule and the early stop take the same values on every rank, and an
auto-resume loads rank 0's choice of checkpoint everywhere.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
from bmhrl_tpu_torch.parallel import mesh as mesh_lib

def build_model(cfg: Config, voc_size: int, device="cuda"):
    """The captioner of ``cfg.mode`` on ``device``, its parameters as the
    modules initialise them (load weights with ``weights.load_jax_params``):
    ``BMHrlAgent`` for BMHRL/BM/verbose/eval, ``AudioAgent`` for AHRL,
    ``VideoAgent`` for VHRL, ``DetrCaption`` for DETR.
    ``cfg.use_pallas_attention`` decides whether the encoder sites that
    qualify run the flash kernel."""
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.models.detr import DetrCaption
    from bmhrl_tpu_torch.models.unimodal import AudioAgent, VideoAgent

    if cfg.mode in ("BMHRL", "BM", "verbose", "eval"):
        return BMHrlAgent(**cfg.agent_kwargs(voc_size), device=device)
    if cfg.mode == "AHRL":
        return AudioAgent.build(cfg, voc_size, device)
    if cfg.mode == "VHRL":
        return VideoAgent.build(cfg, voc_size, device)
    if cfg.mode == "DETR":
        return DetrCaption.build(cfg, voc_size, device)
    raise ValueError(f"unknown mode {cfg.mode}")


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The draws' seed of one training step."""
    return int(np.random.SeedSequence([seed, epoch, step])
               .generate_state(1)[0])


def device_batch(batch: Dict) -> Dict[str, torch.Tensor]:
    """The arrays a step takes, from a batch the Prefetcher staged."""
    out = {k: batch[k] for k in ("rgb", "flow", "audio")}
    out["caption_idx"] = batch["caption_idx"].long()
    return out


def to_host(tensors: Dict[str, torch.Tensor]):
    """Copy ``tensors`` to the host behind the work queued so far; returns
    a function that waits for that copy only and gives numpy arrays."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        return lambda: {k: v.numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in tensors.items()}
    for k, v in tensors.items():
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return {k: v.numpy() for k, v in host.items()}
    return wait


def eval_model(cfg: Config, sf, state, dataset, epoch: int, logger,
               reference_path: str, max_batches: Optional[int] = None
               ) -> Dict:
    """Decode a validation split (greedy, or beam search when
    ``cfg.beam_width`` > 1), write the ActivityNet submission JSON and
    score it; returns the metrics averaged across tIoUs."""
    from bmhrl_tpu_torch.data.dataset import Prefetcher
    from bmhrl_tpu_torch.eval.anet_eval import calculate_metrics
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode, detokenize

    if max_batches is None:
        max_batches = cfg.eval_max_batches
    model = sf.model
    mesh = sf.mesh
    main = mesh is None or mesh.is_main
    predictions = {"version": "VERSION 1.0",
                   "external_data": {"used": True, "details": ""},
                   "results": {}}
    itos = dataset.train_vocab.itos
    batches = Prefetcher(dataset.batches(epoch, shuffle=False,
                                         drop_last=False),
                         cfg.prefetch_batches, sf.device)
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        feats = {k: batch[k] for k in ("rgb", "flow", "audio")}
        masks_src = make_masks(feats)
        if cfg.beam_width > 1:
            tokens, _ = beam_decode(model, feats, masks_src, cfg.max_len,
                                    BOS, EOS, PAD, beam_width=cfg.beam_width,
                                    length_penalty=cfg.length_penalty)
        else:
            tokens, _ = decode(model, feats, masks_src, cfg.max_len, BOS,
                               EOS, PAD, greedy=True)
        if "global_idxs" in batch:  # a rank's rows: every rank's, in order
            rows = [dataset.rows[i] for i in batch["global_idxs"]]
            tokens = mesh_lib.gather_rows(tokens, mesh)[: len(rows)]
            meta = [(r.video_id, r.start, r.end) for r in rows]
        else:
            tokens = tokens[: batch["n_valid"]]
            meta = zip(batch["video_ids"], batch["starts"], batch["ends"])
        sentences = detokenize(tokens.cpu().numpy(), itos)
        for (vid, s, e), sent in zip(meta, sentences):
            seg = {"sentence": sent, "timestamp": [float(s), float(e)]}
            predictions["results"].setdefault(vid, []).append(seg)

    if not main:
        return mesh.broadcast_object(None)
    if cfg.log_path is not None:
        os.makedirs(cfg.log_path, exist_ok=True)
        sub_path = os.path.join(
            cfg.log_path, f"captioning_results_{dataset.phase}_e{epoch}.json")
        with open(sub_path, "w") as f:
            json.dump(predictions, f)
    if dataset.phase == "learned_props":
        # predicted proposals: every reference file, the full tIoU sweep
        refs = [p for p in cfg.reference_paths if os.path.exists(p)]
        tious = list(cfg.tIoUs)
    else:
        refs, tious = [reference_path], [0.5]
    metrics = calculate_metrics(
        refs, predictions, tious, cfg.max_prop_per_vid,
        meteor_preset=cfg.meteor_preset,
        meteor_paraphrase_path=cfg.meteor_paraphrase_path)
    avg = metrics["Average across tIoUs"]
    if logger is not None:
        for m in ("METEOR", "Bleu_4", "Bleu_3", "Precision", "Recall"):
            if m in avg:
                logger.add_scalar(f"{dataset.phase}/{m.lower()}",
                                  avg[m] * 100, epoch)
    if mesh is not None and mesh.world > 1:
        avg = mesh.broadcast_object(avg)
    return avg


def find_latest_checkpoint(log_dir: str):
    """Newest ``.../checkpoints/E_{n}`` under ``log_dir``'s run dirs (by
    directory mtime, then by highest epoch). Returns (path, n) or None."""
    if not log_dir or not os.path.isdir(log_dir):
        return None
    candidates = []
    for d in glob.glob(os.path.join(log_dir, "**", "checkpoints", "E_*"),
                       recursive=True):
        try:
            epoch = int(os.path.basename(d).split("_", 1)[1])
        except ValueError:
            continue
        if os.path.isdir(d):
            candidates.append((os.path.getmtime(d), epoch, d))
    if not candidates:
        return None
    _, epoch, d = max(candidates)
    return d, epoch


def reference_json_for(cfg: Config, phase: str) -> Optional[str]:
    """The reference JSON of a validation phase, None if absent."""
    idx = {"val_1": 0, "val_2": 1, "vatex_val": 2, "msrvtt_val": 3}.get(phase)
    if idx is None:
        return None
    path = cfg.reference_paths[idx]
    return path if os.path.exists(path) else None


class ReduceLROnPlateau:
    """factor 0.1, patience 10 on the teacher-forced validation loss."""

    def __init__(self, factor: float = 0.1, patience: int = 10):
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best - 1e-6:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


def _init_seed(seed: int, part: int) -> int:
    return int(np.random.SeedSequence([seed, part]).generate_state(1)[0])


def make_step_factory(cfg: Config, vocab, device, mesh=None):
    """The captioner of ``cfg.mode`` and its two value nets on ``device``,
    initialised as flax initialises them from seeds derived from
    ``cfg.seed``, the embedding from GloVe where the vocabulary has vectors
    (then frozen unless ``cfg.unfreeze_word_emb``), the pretrained critic
    where ``cfg.rl_critic_path`` exists and the captioner has a critic;
    their ``StepFactory`` (``DetrStepFactory`` for DETR) and its initial
    state. ``mesh``: the modules are replicated from rank 0 over it."""
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.train.steps import StepFactory
    from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory
    from bmhrl_tpu_torch.utils.checkpoint import install_critic
    from bmhrl_tpu_torch.utils.logging import log_stderr
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = build_model(cfg, len(vocab), device)
    wv_model = BMWorkerValueFunction(cfg.d_model_caps, device)
    mv_model = BMManagerValueFunction(cfg.d_model_caps, device)
    for part, net in enumerate((model, wv_model, mv_model)):
        load_jax_params(net, random_module_params(
            net, _init_seed(cfg.seed, part), flax_init=True))
    glove_loaded = vocab.vectors is not None
    if glove_loaded:
        with torch.no_grad():
            model.emb_C.embedding.weight.copy_(torch.from_numpy(
                vocab.vectors))
    if (cfg.rl_critic_path and os.path.exists(cfg.rl_critic_path)
            and hasattr(model, "critic")):
        install_critic(model, cfg.rl_critic_path)
        log_stderr(f"loaded critic: {cfg.rl_critic_path}")
    for net in (model, wv_model, mv_model):
        mesh_lib.replicate(net, mesh)
    factory = DetrStepFactory if cfg.mode == "DETR" else StepFactory
    sf = factory(cfg, model, wv_model, mv_model,
                 (not glove_loaded) or cfg.unfreeze_word_emb, mesh=mesh)
    return sf, sf.init_state()


def _quiet(msg: str) -> None:
    """The log line of a rank other than 0: dropped."""


def _launch_counts() -> Dict[str, int]:
    from bmhrl_tpu_torch.ops import _cuda

    return dict(_cuda.LAUNCHES)


def train_rl_cap(cfg: Config, max_steps_per_epoch: Optional[int] = None,
                 device="cuda", mesh=None) -> Dict:
    """The whole training procedure on ``device``. Returns, for
    ``cfg.mode == "eval"``, the metrics of each validation phase; for
    "verbose", the ``analyze_batch`` record of each batch of epoch 0 (up to
    ``max_steps_per_epoch``); else
    ``{"best_metric", "state", "start_epoch", "step_factory", "epochs"}``:
    ``epochs`` holds one record per trained epoch (phase, lr, steps, mean
    loss, each step's loss, seconds, the ``StepTimer`` summary, the kernel
    launches, the collectives, the scorer's path). ``mesh``: this rank's
    data-parallel mesh (``device`` is then the mesh's)."""
    from bmhrl_tpu_torch.data.dataset import CaptioningDataset, Prefetcher
    from bmhrl_tpu_torch.train.rewards import make_scorer
    from bmhrl_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint_on_main)
    from bmhrl_tpu_torch.utils.logging import ScalarLogger, log_stderr
    from bmhrl_tpu_torch.utils.profiling import StepTimer

    device = resolve_device(device if mesh is None else mesh.device)
    main = mesh is None or mesh.is_main
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if cfg.mode == "verbose" and mesh is not None and mesh.world > 1:
        raise ValueError("--mode verbose analyses batches in one process: "
                         "run it with one data-parallel rank")

    train_ds = CaptioningDataset(cfg, "train", mesh=mesh)
    val_datasets: List = []
    metas = {"val_1": cfg.val_1_meta_path, "vatex_val": cfg.vatex_meta_path,
             "msrvtt_val": cfg.msrvtt_meta_path}
    for phase, meta in metas.items():
        try:
            if os.path.exists(meta) and reference_json_for(cfg, phase):
                val_datasets.append(
                    CaptioningDataset(cfg, phase, vocab=train_ds.train_vocab,
                                      mesh=mesh))
        except Exception as e:  # missing assets are non-fatal (subset runs)
            log_stderr(f"skipping {phase}: {e}")
    # predicted proposals, evaluated in eval mode only
    if (cfg.mode == "eval" and cfg.val_prop_meta_path
            and os.path.exists(cfg.val_prop_meta_path)):
        val_datasets.append(CaptioningDataset(cfg, "learned_props",
                                              vocab=train_ds.train_vocab,
                                              mesh=mesh))

    vocab = train_ds.train_vocab
    sf, state = make_step_factory(cfg, vocab, device, mesh)
    model, wv_model, mv_model = sf.model, sf.wv_model, sf.mv_model
    scorer = make_scorer(cfg.scorer, vocab.itos,
                         getattr(vocab, "token_lists", []),
                         cfg.rl_gamma_worker, cfg.rl_gamma_manager)

    start_epoch = 0
    if cfg.rl_pretrained_model_dir:
        state = load_checkpoint(cfg.rl_pretrained_model_dir, model, wv_model,
                                mv_model, state)
        log_stderr(f"restored from {cfg.rl_pretrained_model_dir}")
    elif cfg.auto_resume:
        # the data order is epoch-seeded, so the stream resumes as it was
        found = find_latest_checkpoint(cfg.log_dir) if main else None
        if mesh is not None and mesh.world > 1:
            found = mesh.broadcast_object(found)
        if found is not None:
            ckpt_dir, ckpt_epoch = found
            state = load_checkpoint(ckpt_dir, model, wv_model, mv_model,
                                    state)
            start_epoch = ckpt_epoch + 1
            log_stderr(f"auto-resume: restored {ckpt_dir}, continuing at "
                       f"epoch {start_epoch}")
        else:
            log_stderr("auto-resume: no prior checkpoint found; starting "
                       "fresh")

    if not main:  # rank 0 logs
        log_stderr = _quiet  # noqa: F811
    n_params = sum(p.numel() for p in model.parameters())
    if main:
        print(f"Total Number of Parameters: {n_params / 1e6:.2f} Mil.")
    logger = ScalarLogger(cfg.log_path if main else None,
                          f"_{cfg.mode}_{cfg.scorer}")
    logger.add_scalar("debug/param_number", n_params, 0)

    if cfg.mode == "eval":
        results = {ds.phase: eval_model(cfg, sf, state, ds, 0, logger,
                                        reference_json_for(cfg, ds.phase))
                   for ds in val_datasets}
        logger.close()
        return results

    if cfg.mode == "verbose":
        # the diagnostic loss-decomposition pass
        from bmhrl_tpu_torch.train.analyze import analyze_batch

        results = []
        for bi, batch in enumerate(Prefetcher(
                train_ds.batches(0), cfg.prefetch_batches, device)):
            if max_steps_per_epoch is not None and bi >= max_steps_per_epoch:
                break
            results.append(analyze_batch(
                sf, state, scorer, device_batch(batch), batch["captions"],
                vocab.itos, step_seed(cfg.seed, 0, bi)))
        logger.close()
        return results

    is_detr = cfg.mode == "DETR"
    best_metric = 0.0
    epochs_unchanged = 0
    # the warmstart/alternation state at start_epoch, in closed form: the
    # warmstart flag turns off at the END of epoch rl_warmstart_epochs
    # (epochs 0..ws inclusive run warmstart, the reference's off-by-one),
    # and train_worker flips at the end of every epoch
    is_warmstart = (cfg.rl_warmstart_epochs > 0
                    and start_epoch <= cfg.rl_warmstart_epochs)
    train_worker = (cfg.rl_train_worker if start_epoch % 2 == 0
                    else not cfg.rl_train_worker)
    scheduler = (ReduceLROnPlateau() if cfg.scheduler == "reduce_on_plateau"
                 else None)
    lr_scale = 1.0
    timer = StepTimer()
    profiler = None
    if cfg.profile_dir and main:  # the first epoch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler = profile(activities=acts)
        profiler.start()
    records = []

    for epoch in range(start_epoch, cfg.epoch_num):
        if epochs_unchanged == cfg.early_stop_after:
            break
        t0 = time.time()
        lr = (cfg.rl_cap_warmstart_lr if is_warmstart else cfg.rl_cap_lr)
        lr = lr * lr_scale
        n_steps = 0
        loss_terms: List[torch.Tensor] = []  # fetched once per epoch
        # DETR trains the same way in warmstart and RL epochs
        phase_name = ("detr" if is_detr else "warmstart" if is_warmstart
                      else "worker" if train_worker else "manager")
        launches0 = _launch_counts()
        collectives0 = dict(mesh_lib.COLLECTIVES)

        def process(item):
            """Score the pending batch on the host, then dispatch its
            score-dependent update against the current parameters."""
            nonlocal state
            kind, batch, bdev, payload, seed, fetch = item
            with timer.phase("wait"):
                host = fetch()
            if kind == "warmstart":
                aux = payload
                with timer.phase("host_score"):
                    w, m, _ = scorer.delta_both(
                        host["argmax"], batch["captions"],
                        host["token_mask"], host["seg"])
                with timer.phase("value_update"):
                    state, _ = sf.value_warmstart_step(
                        state, aux["wf"], aux["mf"],
                        torch.from_numpy(w).to(device),
                        torch.from_numpy(m).to(device), aux["token_mask"],
                        aux["seg"])
                return
            if kind == "detr":
                roll = payload
                with timer.phase("host_score"):
                    score, _ = scorer.delta_worker(host["sampled"],
                                                   batch["captions"])
                score = torch.from_numpy(score).to(device)
                if cfg.with_reinforce:
                    with timer.phase("update"):
                        state, metrics = sf.reinforce_update(
                            state, bdev, seed, lr, roll["sampled"], score)
                else:
                    with timer.phase("host_match"):
                        tc = sf.match_targets(host["pred_classes"],
                                              host["x_idx"])
                    with timer.phase("update"):
                        state, metrics = sf.detr_update(
                            state, bdev, seed, lr, roll["sampled"], score,
                            torch.from_numpy(tc).to(device))
                loss_terms.append(metrics["loss"])
                return
            roll, step_i = payload
            sampled = host["sampled"]
            with timer.phase("host_score"):
                if train_worker:
                    score, _ = scorer.delta_worker(sampled,
                                                   batch["captions"])
                else:
                    score, _ = scorer.delta_manager(
                        sampled, batch["captions"], host["loss_mask"],
                        host["seg"])
            with timer.phase("update"):
                state, metrics = sf.rl_update(
                    state, bdev, seed, lr, roll,
                    torch.from_numpy(score).to(device), train_worker)
            loss_terms.append(metrics["loss"])
            if step_i % 100 == 0:  # a sample every 100 steps
                hyp = " ".join(vocab.itos[i] for i in sampled[0])
                log_stderr(f"Pred[0]: {hyp}")
                log_stderr(f"Trg[0]: {batch['captions'][0]}")
                log_stderr(f"Score[0] sum: {float(np.sum(score[0])):.3f}")

        pending = None
        batches = iter(Prefetcher(train_ds.batches(epoch),
                                  cfg.prefetch_batches, device))
        with torch.profiler.record_function(
                f"train_loop/epoch_{epoch}_{phase_name}"):
            while (max_steps_per_epoch is None
                   or n_steps < max_steps_per_epoch):
                with timer.phase("data"):
                    batch = next(batches, None)
                if batch is None:
                    break
                with timer.phase("step"):
                    seed = step_seed(cfg.seed, epoch, n_steps)
                    bdev = device_batch(batch)
                    if is_detr:
                        with timer.phase("rollout"):
                            roll = sf.detr_rollout(state, bdev, seed)
                            fetch = to_host({k: roll[k] for k in (
                                "sampled", "pred_classes", "x_idx")})
                        item = ("detr", batch, bdev, roll, seed, fetch)
                    elif is_warmstart:
                        with timer.phase("warmstart"):
                            state, metrics, aux = sf.warmstart_step(
                                state, bdev, seed, lr)
                            fetch = to_host({k: aux[k] for k in (
                                "argmax", "token_mask", "seg")})
                        loss_terms.append(metrics["loss"])
                        item = ("warmstart", batch, bdev, aux, seed, fetch)
                    else:
                        with timer.phase("rollout"):
                            roll = sf.rl_rollout(state, bdev, seed,
                                                 train_worker)
                            fetch = to_host({k: roll[k] for k in (
                                "sampled", "loss_mask", "seg")})
                        item = ("rl", batch, bdev, (roll, n_steps), seed,
                                fetch)
                    if cfg.rl_pipeline:
                        if pending is not None:
                            process(pending)
                        pending = item
                    else:
                        process(item)
                    n_steps += 1
            if pending is not None:
                process(pending)
            step_losses = (torch.stack(loss_terms).tolist()
                           if loss_terms else [])
            epoch_loss = (float(torch.stack(loss_terms).sum())
                          if loss_terms else 0.0)
        train_s = time.time() - t0

        logger.add_scalar("debug/train_loss_epoch",
                          epoch_loss / max(n_steps, 1), epoch)
        logger.add_scalar("debug/lr", lr, epoch)
        if scheduler is not None and val_datasets:
            val_losses = []
            for bi, vb in enumerate(Prefetcher(
                    val_datasets[0].batches(epoch, shuffle=False),
                    cfg.prefetch_batches, device)):
                if bi >= 8:
                    break
                val_losses.append(float(sf.val_loss_step(
                    state, device_batch(vb))))
            if val_losses:
                lr_scale = scheduler.step(float(np.mean(val_losses)))
                logger.add_scalar("debug/val_loss",
                                  float(np.mean(val_losses)), epoch)
        log_stderr(f"epoch {epoch} ({phase_name}) "
                   f"loss={epoch_loss / max(n_steps, 1):.4f} "
                   f"steps={n_steps} time={time.time() - t0:.1f}s")
        summary = timer.summary()
        for name, s in summary.items():
            logger.add_scalar(f"time/{name}_ms", s["mean_ms"], epoch)
        timer.reset()
        if profiler is not None:
            profiler.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(
                cfg.profile_dir, f"train_epoch_{epoch}.json"))
            profiler = None
        launches = _launch_counts()
        records.append({
            "epoch": epoch, "phase": phase_name, "lr": lr,
            "steps": n_steps, "loss": epoch_loss / max(n_steps, 1),
            "step_losses": step_losses,
            "train_s": train_s, "timer": summary,
            "launches": {k: launches[k] - launches0[k] for k in launches},
            "collectives": {k: v - collectives0[k]
                            for k, v in mesh_lib.COLLECTIVES.items()},
            "scorer_path": scorer.path})

        # a checkpoint every 2 epochs before validation starts
        ckpt_root = cfg.model_checkpoint_path
        if ckpt_root and epoch % 2 == 0 and epoch < cfg.one_by_one_starts_at:
            save_checkpoint_on_main(os.path.join(ckpt_root, "checkpoints",
                                         f"E_{epoch}"),
                            model, wv_model, mv_model, state, mesh)
        # validation, and a checkpoint at the best METEOR
        if epoch >= cfg.one_by_one_starts_at and val_datasets:
            metrics_avg = [eval_model(cfg, sf, state, ds, epoch, logger,
                                      reference_json_for(cfg, ds.phase))
                           for ds in val_datasets]
            meteor = metrics_avg[0].get("METEOR", 0.0)
            records[-1]["METEOR"] = meteor
            log_stderr(f"epoch {epoch} METEOR={meteor * 100:.2f}")
            if meteor > best_metric:
                best_metric = meteor
                if ckpt_root:
                    save_checkpoint_on_main(os.path.join(ckpt_root, "checkpoints",
                                                 f"E_{epoch}"),
                                    model, wv_model, mv_model, state, mesh)
                epochs_unchanged = 0
            else:
                epochs_unchanged += 1

        if is_warmstart and epoch > (cfg.rl_warmstart_epochs - 1):
            is_warmstart = False
        train_worker = not train_worker

    if profiler is not None:
        profiler.stop()
    logger.close()
    return {"best_metric": best_metric, "state": state,
            "start_epoch": start_epoch, "step_factory": sf,
            "epochs": records}


def _train_rank(mesh, cfg: Config, max_steps_per_epoch: Optional[int]):
    """One rank of ``train_ranks``: the loop on this rank's mesh; the
    picklable part of its result (no modules, no state)."""
    out = train_rl_cap(cfg, max_steps_per_epoch, mesh=mesh)
    if cfg.mode == "eval":
        return out
    return {k: out[k] for k in ("best_metric", "start_epoch", "epochs")}


def train_ranks(cfg: Config, device="cuda",
                max_steps_per_epoch: Optional[int] = None) -> Dict:
    """``train_rl_cap`` over the data axis of ``cfg.mesh_shape``, on that
    many new processes (``parallel.mesh.spawn``: one card each on CUDA,
    gloo ranks on the CPU). Returns rank 0's result without its modules
    and state (``{"best_metric", "start_epoch", "epochs"}``; the metrics
    in eval mode): the checkpoints hold the parameters."""
    world = mesh_lib.resolve_data(cfg.mesh_shape, device)
    return mesh_lib.spawn(_train_rank, world, device,
                          args=(cfg, max_steps_per_epoch))

