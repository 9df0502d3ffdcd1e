"""Event proposals over whole videos, as ``dense_caption``'s first stage
runs them: ``ProposalDataset.batches`` over full clips padded to the
configuration's lengths, ``ProposalStepFactory.predict``, then
``cli.train_proposals.postprocess`` (top-k, trim, NMS) on the host.

Set-up writes the mix's video pool, makes the weights on the card from the
seed and loads them into the port's ``MultimodalProposalGenerator``, and
proposes one warm-up batch. The window passes over the pool, in an order
drawn from the seed, until the window's seconds have passed; whole batches
count, and the window ends at the batch's end nearest to its seconds.

The check: the predictions of a few batches of the first pass, drawn from
the seed, and of the batch that holds the longest video, kept on the host
as the program returned them, against the reference's over the same videos,
which it loads from the raw pool. Each valid cell gives three errors in the
heads' own coordinates, where an error in the length's exponent is not
magnified by the anchor's length: the centre's error in cells, the error of
the log of the length and the confidence's error. Number compared
(``pred_err_rms_max``): the largest over the checked videos of a video's
root-mean-square error; one wrong video shows in it, and it is steady from
seed to seed. The widest single error (``pred_err_max``), which swings
from seed to seed, is read beside it.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.harness import window_done
from benchmark.reference import proposal as ref


def _model(cfg: Dict, device):
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    return MultimodalProposalGenerator(
        d_vid=cfg["d_vid"], d_aud=cfg["d_aud"], d_model=cfg["d_model"],
        d_model_aud=cfg["d_model_aud"], d_ff_v=cfg["d_ff_v"],
        d_ff_a=cfg["d_ff_a"], att_heads=cfg["att_heads"],
        att_layers=cfg["att_layers"], num_anchors=cfg["num_anchors"],
        dout_p=cfg["dout_p"], dtype=getattr(torch, cfg["dtype"]),
        device=device)


def setup(ctx):
    from bmhrl_tpu_torch.data.proposal import ProposalDataset
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    pool = mix["pool"]
    with ctx.spans("setup.inputs"):
        ctx.feats = traffic.write_pool(pool, mix["size_seed"], ctx.seed,
                                       ctx.workdir, dev)
        ctx.durations = traffic.durations(pool, mix["size_seed"])
        order = np.random.default_rng(
            weights.sub_seed(ctx.seed, "order")).permutation(pool["videos"])
        ctx.video_order = [int(v) for v in order]
        meta = os.path.join(ctx.workdir, "videos.tsv")
        with open(meta, "w") as f:
            f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
            for i, v in enumerate(ctx.video_order):
                d = float(ctx.durations[v])
                f.write(f"{traffic.video_id(v)}\t-\t0.0\t{d}\t{d}\tinfer"
                        f"\t{i}\n")
        ctx.ds = ProposalDataset(
            meta, f"{ctx.workdir}/i3d", f"{ctx.workdir}/vggish",
            pad_video_to=cfg["pad_video_to"],
            pad_audio_to=cfg["pad_audio_to"],
            num_anchors=cfg["num_anchors"], d_vid=cfg["d_vid"],
            d_aud=cfg["d_aud"])
        ctx.ds.anchors = np.asarray(mix["anchors_s"], np.float64)
    with ctx.spans("setup.weights"):
        ctx.params = weights.make_params(ref.param_spec(cfg), ctx.seed, dev)
        model = _model(cfg, dev)
        model.load_state_dict(ctx.params, strict=True)
        ctx.sf = ProposalStepFactory(model, device=dev)
        ctx.state = ctx.sf.init_state()
    with ctx.spans("setup.warmup"):
        _propose(ctx, next(iter(ctx.ds.batches(0, mix["batch_size"],
                                              shuffle=False))))


def _propose(ctx, batch):
    from bmhrl_tpu_torch.cli.train_proposals import postprocess

    mix = ctx.traffic
    with ctx.spans("propose.predict"):
        preds = ctx.sf.predict(ctx.state, batch).cpu().numpy()
    with ctx.spans("propose.postprocess"):
        out = postprocess(preds, batch["durations"], mix["max_props"],
                          mix["nms_tiou"])
    return preds, out


def window(ctx, seconds: float) -> Dict:
    B = ctx.traffic["batch_size"]
    t0 = time.perf_counter()
    ctx.kept, ctx.counters["videos"] = {}, []
    videos = failed = batches = 0
    while True:
        it = iter(ctx.ds.batches(0, B, shuffle=False))
        for j in range(-(-len(ctx.ds) // B)):
            with ctx.spans("propose.load"):
                batch = next(it)
            preds, out = _propose(ctx, batch)
            if batches == j:  # the first pass: the check samples it
                ctx.kept[j] = (batch["video_ids"], preds)
            batches += 1
            videos += len(out)
            failed += len(batch["video_ids"]) - len(out)
            ctx.counters["videos"].extend(
                zip(batch["targets"]["orig_len_video"].tolist(),
                    batch["targets"]["orig_len_audio"].tolist()))
            if window_done(t0, batches, seconds):
                return {"done": {"propose_videos_per_s": videos},
                        "attempted": videos, "failed": failed}


def _sample(ctx):
    """The mix's ``check_batches`` of the first pass drawn from the seed,
    and the batch that holds the longest video."""
    done = sorted(ctx.kept)
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, "sample"))
    picked = {done[int(i)] for i in rng.choice(
        len(done), min(ctx.traffic["check_batches"], len(done)),
        replace=False)}
    B = ctx.traffic["batch_size"]
    longest = int(np.argmax(ctx.durations[ctx.video_order])) // B
    if longest in ctx.kept:
        picked.add(longest)
    return [ctx.kept[j] for j in sorted(picked)]


def check(ctx, control=None) -> Dict[str, float]:
    """{"pred_err_max": ...}; with ``control`` (a rounding of
    ``reference.precision``) also the control's ``pred_err_max_control``."""
    del ctx.sf, ctx.state
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, dev = ctx.config, ctx.device
    anchors = torch.tensor(ctx.traffic["anchors_s"], dtype=torch.float32,
                           device=dev)
    errs, errs_ctl = [], []
    for ids, preds in _sample(ctx):
        V, A, olv, ola, dur = [], [], [], [], []
        for vid in ids:
            rgb, flow, audio = ctx.feats[vid]
            nv = min(len(rgb), cfg["pad_video_to"])
            na = min(len(audio), cfg["pad_audio_to"])
            v = np.zeros((cfg["pad_video_to"], cfg["d_vid"]), np.float32)
            a = np.zeros((cfg["pad_audio_to"], cfg["d_aud"]), np.float32)
            v[:nv] = (rgb + flow)[:nv]
            a[:na] = audio[:na]
            V.append(v)
            A.append(a)
            olv.append(nv)
            ola.append(na)
            dur.append(float(ctx.durations[int(vid[2:])]))
        args = [torch.from_numpy(np.stack(V)).to(dev),
                torch.from_numpy(np.stack(A)).to(dev),
                torch.tensor(olv, device=dev), torch.tensor(ola, device=dev),
                torch.tensor(dur, dtype=torch.float32, device=dev), anchors]
        want = ref.predictions(ctx.params, cfg, *args)
        got = torch.from_numpy(preds).to(dev)
        errs.append(_err(got, want, olv, ola, dur, cfg))
        if control is not None:
            errs_ctl.append(_err(ref.predictions(ctx.params, cfg, *args,
                                                 rnd=control),
                                 want, olv, ola, dur, cfg))
    values = _stats(errs, "")
    if control is not None:
        values.update(_stats(errs_ctl, "_control"))
    return values


def _stats(errs, suffix: str) -> Dict[str, float]:
    """The numbers read from per-video cell errors."""
    cells = torch.cat([e for v in errs for e in v])
    return {f"pred_err_max{suffix}": float(cells.max()),
            f"pred_err_rms_max{suffix}": max(
                float(e.square().mean().sqrt()) for v in errs for e in v)}


def _err(got, want, olv, ola, dur, cfg) -> list:
    """The largest error over the valid cells of a batch, in the heads' own
    coordinates: the centre's error in cells, the log-length's error and
    the confidence's error (module docstring). The shapes must agree."""
    if got.shape != want.shape:
        return [torch.full((1,), float("inf"))]
    K, Sv = cfg["num_anchors"], cfg["pad_video_to"]
    out = []
    for b in range(got.shape[0]):
        dev = got.device
        cells = torch.cat([torch.arange(olv[b] * K),
                           Sv * K + torch.arange(ola[b] * K)]).to(dev)
        n = torch.cat([torch.full((olv[b] * K,), float(olv[b])),
                       torch.full((ola[b] * K,), float(ola[b]))]).to(dev)
        g, w = got[b, cells], want[b, cells]
        centre = ((g[:, 0] + g[:, 1]) - (w[:, 0] + w[:, 1])).abs() / 2
        log_len = (torch.log(g[:, 1] - g[:, 0])
                   - torch.log(w[:, 1] - w[:, 0])).abs()
        e = torch.stack([centre * n / dur[b], log_len,
                         (g[:, 2] - w[:, 2]).abs()]).flatten()
        out.append(torch.nan_to_num(e, nan=float("inf")).cpu())
    return out
