"""Offline captioning through ``serve.CaptionServer.caption``, as
``serve_captions`` runs it.

Set-up writes the mix's feature pool under the run's work directory, makes
the weights on the card from the seed and loads them into the port's
``BMHrlAgent``, and warms up: one request of every bucket pair the mix's
segments fall into, and one full batch of the largest. The window submits chunks of the mix's
segments, each a new order of the same segments drawn from the seed, one
``caption()`` call a chunk, until the window's seconds have passed; whole
chunks count, and the window ends at the chunk's end nearest to its
seconds.

The check: after the window a few of the served batches, drawn from the
seed, and the batch that holds the longest segment, go to the reference
with the tokens the program served, every row of the batch (the goal rule
reads them all). Which request each row holds is found from the features
the program fed the decode (a few values of the first row and the row
counts), matched against the reference's own crops of the pool; the
reference then reads the raw features itself. The row counts are those
the model's source mask keeps (rows whose first feature is not 0), as the
program's masks count them. Number compared: the widest
gap, in log-probability, by which a served token lies below the
reference's best at its position (``gap_max``), over every real row's
positions up to its first </s>.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.harness import window_done
from benchmark.reference import bmhrl as ref

EOS = 3
SPECIALS = ["<unk>", "<blank>", "<s>", "</s>"]
FP_VIDEO, FP_AUDIO = 8, 4  # feature values of a row's fingerprint


def _model(cfg: Dict, device):
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    return BMHrlAgent(
        voc_size=cfg["voc_size"], d_video=cfg["d_vid"], d_audio=cfg["d_aud"],
        d_model=cfg["d_model"], d_model_caps=cfg["d_model_caps"],
        att_heads=cfg["att_heads"], att_layers=cfg["att_layers"],
        dout_p=cfg["dout_p"], d_goal=cfg["d_goal"], d_ff_v=cfg["d_ff_v"],
        d_ff_a=cfg["d_ff_a"], d_ff_c=cfg["d_ff_c"],
        critic_score_threshold=cfg["critic_score_threshold"],
        dtype=getattr(torch, cfg["dtype"]), device=device)


def _server_class():
    from bmhrl_tpu_torch.serve import CaptionServer

    class RecordingServer(CaptionServer):
        """The port's server; each batch's served tokens and the
        fingerprint of the features it decoded are kept on the device for
        the check after the window."""

        log: List = []
        spans = None

        def _decode(self, feats, masks_src):
            with self.spans("serve.decode"):
                tokens = super()._decode(feats, masks_src)
            self.log.append({
                "tokens": tokens,
                "fp_v": feats["rgb"][:, 0, :FP_VIDEO].clone(),
                "fp_a": feats["audio"][:, 0, :FP_AUDIO].clone(),
                "vlen": masks_src["V_mask"].sum(dim=(1, 2)),
                "alen": masks_src["A_mask"].sum(dim=(1, 2))})
            return tokens

    return RecordingServer


def setup(ctx):
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.serve import ClipRequest

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    pool = mix["pool"]
    with ctx.spans("setup.inputs"):
        ctx.feats = traffic.write_pool(pool, mix["size_seed"], ctx.seed,
                                       ctx.workdir, dev)
        dur = traffic.durations(pool, mix["size_seed"])
        ctx.segments = traffic.segments(mix, mix["size_seed"])
        ctx.requests = [ClipRequest(traffic.video_id(v), s, e, float(dur[v]))
                        for v, s, e in ctx.segments]
    with ctx.spans("setup.weights"):
        ctx.params = weights.make_params(ref.param_spec(cfg), ctx.seed, dev)
        probe = torch.randint(4, cfg["voc_size"], (64, cfg["max_len"] + 1),
                              generator=weights.generator(ctx.seed, "probe",
                                                          dev), device=dev)
        ref.center_critic(ctx.params, cfg, probe)
        model = _model(cfg, dev)
        model.load_state_dict(ctx.params, strict=True)
    port_cfg = Config(to_log=False, max_len=cfg["max_len"],
                      video_features_path=f"{ctx.workdir}/i3d",
                      audio_features_path=f"{ctx.workdir}/vggish",
                      d_vid=cfg["d_vid"], d_aud=cfg["d_aud"],
                      pad_video_feats_up_to=cfg["pad_video_to"],
                      pad_audio_feats_up_to=cfg["pad_audio_to"],
                      compute_dtype=cfg["dtype"])
    itos = SPECIALS + [f"w{i}" for i in range(cfg["voc_size"] - 4)]
    server = _server_class()(port_cfg, model, itos, device=dev)
    server.spans = ctx.spans
    server.log = []
    ctx.server = server
    ctx.order = np.random.default_rng(weights.sub_seed(ctx.seed, "order"))
    with ctx.spans("setup.warmup"):
        # one request of every bucket pair, then a full batch of the
        # largest, so each shape and the allocator's peak are met before
        # the window
        _caption(ctx, _warmup_requests(ctx))
    server.log = []


def _warmup_requests(ctx) -> List:
    from bmhrl_tpu_torch.serve import plan_batches
    plan = plan_batches(ctx.requests, ctx.server.cfg, 1)
    first = {}
    for idxs, vb, ab in plan:
        first.setdefault((vb, ab), idxs[0])
    largest = max(first)
    big = [i for idxs, vb, ab in plan if (vb, ab) == largest for i in idxs]
    bs = ctx.traffic["batch_size"]
    big = (big * bs)[:bs]
    return [ctx.requests[i] for i in list(first.values()) + big]


def _caption(ctx, reqs):
    preds, stats = ctx.server.caption(reqs,
                                      batch_size=ctx.traffic["batch_size"])
    missing = sum(seg["sentence"] is None
                  for segs in preds["results"].values() for seg in segs)
    return stats, missing


def window(ctx, seconds: float) -> Dict:
    t0 = time.perf_counter()
    ctx.chunks, clips, failed, attempted = [], 0, 0, 0
    c = ctx.counters
    c.update(rows=0, padded_rows=0, batches=0)
    while True:
        perm = ctx.order.permutation(len(ctx.requests))
        with ctx.spans("serve.caption"):
            stats, missing = _caption(ctx, [ctx.requests[i] for i in perm])
        ctx.chunks.append({"perm": perm, "batches": ctx.server.log})
        ctx.server.log = []
        clips += stats.clips
        attempted += len(perm)
        failed += missing
        c["rows"] += stats.clips + stats.padded_rows
        c["padded_rows"] += stats.padded_rows
        c["batches"] += stats.batches
        if window_done(t0, len(ctx.chunks), seconds):
            break
    return {"done": {"caption_clips_per_s": clips}, "attempted": attempted,
            "failed": failed}


def _served_positions(tokens: torch.Tensor) -> torch.Tensor:
    """(B,) positions of each row whose scores were served: up to its
    first </s>, that one included."""
    L = tokens.shape[1] - 1
    eos = tokens[:, 1:] == EOS
    first = torch.where(eos.any(1), eos.int().argmax(1) + 1,
                        torch.full_like(eos[:, 0], L, dtype=torch.long))
    return first


def _crop(ctx, i: int):
    """The reference's own crop of request i: (rgb, flow, audio) rows."""
    v, s, e = ctx.segments[i]
    rgb, flow, audio = ctx.feats[traffic.video_id(v)]
    dur = ctx.requests[i].duration
    vs, ve = traffic.crop_span(len(rgb), s, e, dur)
    as_, ae = traffic.crop_span(len(audio), s, e, dur)
    cv, ca = ctx.config["pad_video_to"], ctx.config["pad_audio_to"]
    return (rgb[vs:ve][:cv], flow[vs:ve][:cv], audio[as_:ae][:ca])


def _unmasked(x) -> int:
    """Rows of a crop that the model's source mask keeps: those whose first
    feature is not the pad value 0 (a real row can hold an exact 0)."""
    return int(np.count_nonzero(x[:, 0]))


def _fingerprint(rgb, audio) -> bytes:
    return (np.ascontiguousarray(rgb[0, :FP_VIDEO], np.float32).tobytes()
            + np.ascontiguousarray(audio[0, :FP_AUDIO], np.float32).tobytes()
            + np.int64([_unmasked(rgb), _unmasked(audio)]).tobytes())


def _sample(ctx) -> List:
    """(chunk, batch) pairs for the check: the mix's ``check_batches``
    drawn from the seed, and the batch that holds the longest segment."""
    pairs = [(k, j) for k, ch in enumerate(ctx.chunks)
             for j in range(len(ch["batches"]))]
    longest = max(range(len(ctx.segments)),
                  key=lambda i: ctx.segments[i][2] - ctx.segments[i][1])
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, "sample"))
    n = min(ctx.traffic["check_batches"], len(pairs))
    picked = [pairs[int(i)] for i in rng.choice(len(pairs), n,
                                                 replace=False)]
    lv = _unmasked(_crop(ctx, longest)[0])
    for k, j in pairs:
        b = ctx.chunks[k]["batches"][j]
        if int(b["vlen"].max()) == lv and (k, j) not in picked:
            picked.append((k, j))
            break
    return picked


def _reference_batch(ctx, batch, table):
    """The reference's inputs of one served batch, or raise when a row's
    features match no request."""
    fp_v = batch["fp_v"].float().cpu().numpy()
    fp_a = batch["fp_a"].float().cpu().numpy()
    vlen = batch["vlen"].cpu().numpy()
    alen = batch["alen"].cpu().numpy()
    rows = []
    for b in range(len(vlen)):
        if vlen[b] == 0:  # a zero row padding the batch
            rows.append(None)
            continue
        key = (fp_v[b].tobytes() + fp_a[b].tobytes()
               + np.int64([vlen[b], alen[b]]).tobytes())
        if key not in table:
            raise LookupError(f"row {b} of a served batch matches no "
                              "request's features")
        rows.append(table[key])
    crops = [None if i is None else _crop(ctx, i) for i in rows]
    sv = max([len(c[0]) for c in crops if c] + [1])
    sa = max([len(c[2]) for c in crops if c] + [1])
    B, dv, da = len(rows), ctx.config["d_vid"], ctx.config["d_aud"]
    rgb, flow = np.zeros((B, sv, dv), np.float32), np.zeros((B, sv, dv),
                                                            np.float32)
    audio = np.zeros((B, sa, da), np.float32)
    for b, c in enumerate(crops):
        if c:
            rgb[b, :len(c[0])], flow[b, :len(c[1])] = c[0], c[1]
            audio[b, :len(c[2])] = c[2]
    return rows, [torch.from_numpy(x).to(ctx.device)
                  for x in (rgb, flow, audio)]


def check(ctx, control=None) -> Dict[str, float]:
    """{"gap_max": ...}; with ``control`` (a rounding of
    ``reference.precision``) also the control's ``gap_max_control``."""
    # the program's state goes before the reference runs
    records = _sample(ctx)
    ctx.counters["records"] = _mfu_records(ctx)
    del ctx.server
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    gaps, gaps_ctl = [], []
    tables = {}
    for k, j in records:
        if k not in tables:
            tables[k] = {_fingerprint(c[0], c[2]): int(i)
                         for i in ctx.chunks[k]["perm"]
                         for c in [_crop(ctx, int(i))]}
        batch = ctx.chunks[k]["batches"][j]
        try:
            rows, (rgb, flow, audio) = _reference_batch(ctx, batch,
                                                         tables[k])
        except LookupError:
            return {"gap_max": math.inf}
        tokens = batch["tokens"]
        n = _served_positions(tokens)
        real = torch.tensor([r is not None for r in rows],
                            device=tokens.device)
        counted = ((torch.arange(tokens.shape[1] - 1,
                                 device=tokens.device)[None] < n[:, None])
                   & real[:, None])
        out = ref.served_gaps(ctx.params, ctx.config, rgb, flow, audio,
                              tokens.to(ctx.device), counted.to(ctx.device),
                              control)
        gaps.append(out["gap"])
        if control is not None:
            gaps_ctl.append(out["gap_control"])
    values = {"gap_max": float(torch.cat(gaps).max())}
    if control is not None:
        values["gap_max_control"] = float(torch.cat(gaps_ctl).max())
    return values


def _mfu_records(ctx) -> Dict:
    """Per real row of every batch of the window: own video rows, audio
    rows and served positions; and the token steps each batch ran."""
    sv, sa, nt, steps = [], [], [], 0
    for ch in ctx.chunks:
        for b in ch["batches"]:
            real = b["vlen"] > 0
            n = _served_positions(b["tokens"])
            sv.append(b["vlen"][real].cpu())
            sa.append(b["alen"][real].cpu())
            nt.append(n[real].cpu())
            # columns the loop wrote: every row's </s>, or max_len
            steps += int(n.max())
    return {"sv": torch.cat(sv).tolist(), "sa": torch.cat(sa).tolist(),
            "n_tok": torch.cat(nt).tolist(), "token_steps": steps}
