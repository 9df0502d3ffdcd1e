"""Drive the PyTorch/CUDA port (bmhrl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, ends with the verdict

Phases, each of which raises at its first failure:

1. build: compile every kernel of csrc/ (one nvcc per source, in parallel);
   no attention kernel may spill (ptxas -v, every instantiated width);
2. kernels: each kernel at the flagship's shapes against its plain PyTorch
   version on the same card inputs, with timings of the kernel, the plain
   version, one PyTorch library call computing the same function, and the
   card's bound. Flash attention in bf16 at d 128/256 takes the bf16
   tensor-core route and in f32 the 3xTF32 route (``simt``, also bf16 at
   d 384/512; ops.attention.flash_route), each with edge cases (ragged Sq
   and Sk, one key, causal, no mask, d = 128 to 512, 4- and 8-warp
   blocks) and a fully-masked row that must equal mean(V); the 3xTF32 route
   is also checked and timed at the reference decode's own shapes and at
   the f32 flagship's encoder and long-source sites (kernel, plain,
   SDPA, the bound max(bytes / 3.35 TB/s, 3 x operations / 495 TFLOP/s)
   and the CUDA-core bound operations / 67 TFLOP/s), and every block
   geometry it can take is timed at the flagship's sites for B=32 and 16. Folded attention with
   a bf16 memory at draw 128..1024 takes the tensor-core route and with an
   f32 one the 3xTF32 route (ops.attention.folded_route), at the serve's
   audio and video shapes for B=256 and B=32 (the f32 pair recorded), the
   long-source shapes and edge cases of both routes (3xTF32: G = 4, 12,
   32, 64 at draw 64, 128, 300, 1024, 1152 and, in column slabs, 2048,
   2500, 19200, in f32 and bf16, one key,
   S = 37 and 129, cluster blocks without keys), each fully-masked row
   equal to mean(mem); a CUDA graph of one tensor-core call must hold one
   kernel and nothing else. The 3xTF32 folded route also at the f32 beam's
   video call (64 clips, S 128, draw 1024, G = 8, 24, 32, 64: several
   blocks a clip above ``folded_simt_chunk``), within 1e-5, G = 32 timed.
   The critic cells (f32) run over packed weights and are also held
   against the unpacked cell math.
   Kernel times are device times of calls replayed from a CUDA graph;
3. reference: a small f32 model decoded on the card through the kernels
   and on the CPU through the plain versions: identical tokens, and
   probabilities within 1e-4. Its launches are the 3xTF32 flash and
   folded routes' counts (the bf16 serve never takes those routes);
4. serve: the flagship BMHrlAgent (Config's dims, vocabulary 10172, bf16,
   random weights from a seed loaded through the JAX-layout loader)
   answers 64 requests written as .npy files, across several bucket pairs
   with padded tail batches and one clip without features, through
   CaptionServer.caption. This is the main path: the launch counts are
   zeroed just before it and read just after, and every kernel of the bf16
   path must have launched. Then clips/s of greedy decode at B=32 and
   B=256 (Sv=128, Sa=256, 30 tokens), the per-step token agreement of the
   kernels and the plain versions fed the same tokens;
5. decode_modes: every decode mode. The small f32 model on the card and
   on the CPU with the same draws: beam W=3 (length penalty 0 and 1),
   sampled, the full-buffer greedy, beam and exploration decodes, all
   identical; on the card the full-buffer loops give the fast loops'
   tokens. The flagship serves the 64 requests with beam search (W=4,
   length penalty 1) and with sampling (temperature 0.8, top_p 0.9, seed
   0), each a main path with its launch counts zeroed just before and read
   just after (only the tensor-core routes); a second sampled serve with
   the seed repeats the captions; top_k=1 sampling equals greedy; beam
   W=1 agrees with greedy on >= 99% of tokens; each W=4 beam score is the
   sum of its tokens' log-probs under the greedy step (2e-2); the
   full-buffer step fed a fast decode's tokens agrees on >= 95% of steps
   with 8 tensor-core flash launches per token; every loop syncs the host
   once per token (``torch.cuda.set_sync_debug_mode``). Folded attention
   at the beam shape (64 clips, G=32) against the repeated layout (256
   rows, G=8), the library call and the bound; the flagship in f32 decoded
   by beam search at W=4 (G = 32 on the 3xTF32 folded route, launches
   counted) agrees with its plain-version run on >= 99% of tokens;
   clips/s of beam W=4 (B=64), sampled (B=256) and full-buffer greedy
   (B=32) decode;
6. graph: the greedy token as one CUDA graph replay a token
   (``train.decode.TokenGraphs``): the flagship at B=256 in the (32, 64)
   bucket, at a tail of 32 and at B=256 again on other clips (the kept
   graph), and the DETR at B=256, each bit-equal in tokens and
   probabilities to the eager loops (``_fast_loop`` and the graph's body
   called once a token), with one capture for new shapes, none for kept
   ones, one replay a token step, and the eager token's kernel launches
   counted at each replay; a capture's, a kept graph's new start's, a
   replayed token's and an eager token's milliseconds on the host clock;
   the roofline shares of ``folded_attend`` and the critic's cells in
   replays, each replayed device operation tied to the op of the eager
   token's at its place;
7. entry_points: the serving entry points at the flagship's width. A
   train TSV of 10168 words (the CLIs build the flagship's vocabulary of
   10172), a reference .pt written by ``utils.checkpoint.
   export_torch_bmhrl`` from the seed-0 weights and a 64-request proposals
   JSON: ``cli.serve_captions.main`` (greedy and beam W=4, each a main
   path with its launches counted) answers all 64 with the submission of
   a CaptionServer given the same weights through ``load_jax_params``;
   ``cli.single_video.main`` gives the server's caption of the same clip;
   ``--mode AHRL`` and ``--mode VHRL`` serve (main paths: every
   tensor-core kernel and cell launched, no 3xTF32 route); the f32
   flagship (``--compute_dtype float32``) through the same CLI on the 64
   requests, the 3xTF32 routes' main path (their launches and the cells',
   no tensor-core route; words equal to the plain versions' run on >= 99%
   of positions; clips/s beside the bf16 greedy serve); small f32
   AHRL and VHRL models decode identically on card and CPU (greedy,
   sampled, beam W=2, full-buffer); greedy clips/s at B=256 of AHRL, VHRL
   and the bimodal flagship; an AHRL warmstart step at B=16 (ms/step,
   loss falling over 3 steps);
8. train: the training path through ``train.steps.StepFactory``. Flash
   attention's gradient (the autograd Function: kernel forward, the JAX
   package's recompute as backward) against autograd through the plain
   version at the training shapes, bf16 (tensor-core route) and f32
   (3xTF32 route); a small f32 model trained on the card and on the CPU
   with the same draws (two warmstart steps, one RL update per phase):
   losses and updated parameters agree; then the flagship (Config's dims,
   vocabulary 10172, bf16, random weights from seed 0) on synthetic
   batches shaped as bench.py's (Sv=128, Sa=256, 31 caption positions).
   This is the training path's main run: the launch counts are zeroed just
   before it and read just after (ten warmstart steps on one batch, a value
   step, an RL worker and an RL manager step); the flash kernel must launch
   16 times per forward and the critic's cells 6 per caption position.
   Checks: the loss falls, every encoder parameter gets a nonzero gradient,
   the critic never changes, each RL phase leaves the other phase's group
   unchanged. Then ms/step (median of 7 after 3 warm-up steps) of warmstart at
   B=16 and B=64 and of RL worker and manager (rollout + update, zero
   scores) at B=16, an MFU estimate (forward matmul FLOPs counted with the
   plain kernels, times 3, against 989 TFLOP/s bf16), the step's
   forward/backward/optimizer split from CUDA events, and the flash
   forward kernel, backward recompute and
   ``scaled_dot_product_attention`` forward + backward at the B=16 sites;
9. train_loop: ``train_rl_cap`` at the flagship's width on a written
   corpus (the timed runs, the first the main path), its gates and the
   synthetic learning proof;
10. detr: the DETR captioner. A small f32 DETR (default and pre-goal)
   decoded on card and CPU with the same draws in every mode (identical
   tokens) and one ``detr_update`` on each (losses and parameters within
   1e-5); the flagship DETR (``DetrCaption.build``: vocabulary 10172,
   d_model 1024, 3 layers, bf16, random weights from a seed) serving the
   64 requests greedily (a main path: launches zeroed just before and read
   just after; flash and folded attention on the tensor-core routes) and
   with beam W=4, the pre-goal flagship serving 8 (the cell kernels' main
   path); per-step agreement with the plain versions fed the same tokens
   (>= 0.95) and one host sync per token; clips/s of greedy B=32 and
   B=256, beam W=4 at 64 clips and sampled B=256, the bimodal greedy B=256
   in the same call; the training step (rollout + Hungarian match +
   update, B=16, 31 positions: a main run of 3 steps with 12 flash
   launches each, every encoder parameter's gradient through flash,
   ms/step, the device's idle share); ``run_training --mode DETR`` for 2
   epochs of 8 steps (its launches counted) and ``serve_captions --mode
   DETR --checkpoint_dir`` on its checkpoint, equal to the direct server;
11. leftovers: ``train_critic`` on the written corpus (BCE falls; its
   ``critic.cp`` installed gives the trained module's logits through the
   cell kernels, 1e-4) and one ``run_training --mode verbose`` pass;
12. proposals: the event-proposal generator. A small f32 model (2 heads
   of d=128: the 3xTF32 flash route; Sv 300, Sa 800, B 4, one video
   without features) on card and CPU with the same weights and draws:
   predictions (segments relative to their scale) and losses within 1e-5,
   one train_step (dropout on, the clip triggered) to parameters within
   1e-5, under PyTorch's default cuDNN TF32 setting; flash at the
   proposal encoder's four sites (B=8, 4 heads of d=256, 300 and 800 rows,
   bf16) against its plain version (2e-2, a fully-masked row = mean(V)),
   timed with the plain version, SDPA, the bound and the backward
   recompute against SDPA forward + backward; the generator at the CLIs'
   widths (bf16, B=8 at the pads): every encoder parameter's gradient
   through flash, the training main run (10 steps on one batch, launches
   zeroed just before and read just after: 8 ``flash_attention_tc`` a
   forward and nothing else; the loss falls), ms/step, the step's split
   (the f32 heads' share of the forward), FLOPs, the device's idle share;
   ``train_proposals`` on 24 written videos (2 epochs) and ``--emit_only``
   on its checkpoint (the best epoch's proposals again); ``dense_caption``
   over 16 of them with the flagship captioner from a reference .pt: the
   slice's main path (launches zeroed just before and read just after:
   every tensor-core kernel and both cells, no 3xTF32 route), equal to
   the direct predict + postprocess + ``CaptionServer.caption``;
13. export: AOT serving bundles (``serve_export``). The four kernel
   entry points, ``torch.library`` custom ops, pass
   ``torch.library.opcheck`` with CUDA tensors at serving shapes; the
   flagship (seed-0 weights) exported greedy and with beam W=4 for the 64
   requests at B=32 (``setup``, ``head`` and ``body`` programs with a
   dynamic row axis, weights as inputs, ``params.npz``; both bundles kept
   for the mesh phase) and served from the bundle and from the live
   CaptionServer (both row-padding tails to 32), each serve a main path
   with its launches counted: identical submissions and equal launches per
   kernel route; the bundle's loop syncs the host once per token; AHRL,
   DETR and DETR pre-goal (its full-buffer loop exported) bundles on 8
   requests likewise; a JAX bundle is refused. Records: export seconds per
   program, the bytes of ``params.npz`` and of the programs, load seconds,
   greedy clips/s of bundle and live server taking turns (median of 3)
   and their ratio (the head program and the dynamic rows are in it);
14. mesh: data parallelism (``parallel.mesh``) on the one card. A world
   of 1 over NCCL through the production path: ``train_rl_cap`` (B=16, a
   warmstart and a worker epoch of 4 steps) and the flagship's greedy
   ``CaptionServer`` on the 64 requests at B=32, each with and without
   the mesh in turns: bit-equal losses and parameters, identical
   submissions, one host sync per token, ms/step, clips/s and collectives
   per step and per token; the mesh runs are data parallelism's main
   paths (launches zeroed just before and read just after). The export
   phase's greedy bundle served by a world of 1 over NCCL started with
   ``spawn``: the no-mesh bundle's submission and launches. Then two gloo
   ranks sharing the card (``spawn``) against one process: a small f32
   model's steps, decodes and a served tail of 1 padded to 2 (tokens
   identical, 1e-5), and the bf16 flagship's serve (the share of
   identical captions, printed) and its steps fed one process's tokens
   (>= 95% the same choice); on the same ranks the greedy and beam W=4
   bundles (16 rows a rank) against the live server with the same batch
   shapes (identical captions, launches on rank 0 and all-reduces;
   program calls a token, each rank's load seconds, the rig's clips/s),
   and a small f32 bundle at one row a rank against one process;
15. profile: one B=256 greedy decode, one beam W=4 decode of 64 clips and
   one B=16 warmstart step under ``torch.profiler`` (last: a profiled
   process launches more slowly).

Prints the card's name and power limit first, one JSON line per measurement,
a ``kernels`` line, and last the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when there is no CUDA device or the
package is missing. Needs no network; stops every process it starts.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from unittest import mock

import numpy as np

# the port's peak rates on one H100 SXM (dense; NVIDIA data sheet). An f32
# product on the "simt" routes is three tf32 products (3xTF32) on the
# tensor cores: its operations run at most at a third of the tf32 rate
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "3xtf32": 495e12 / 3}

VOC = 10172  # the flagship's vocabulary; its other dims are Config's
SMALL = dict(voc_size=40, d_video=128, d_audio=128, d_model=256,
             d_model_caps=32, att_heads=2, att_layers=2, d_goal=16,
             d_ff_v=64, d_ff_a=64, d_ff_c=64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of one fn() call: ``iters`` calls captured
    in one CUDA graph and replayed, so the host's cost of launching them
    (Python, ctypes, the launch itself) is left out."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() over ``iters`` back-to-back eager calls, on
    the device's clock: the device time, or the host's launch time where
    that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_node_types(fn) -> list:
    """The node types of a CUDA graph that holds one fn() call, read through
    libcuda (CUgraphNodeType: 0 is a kernel)."""
    import ctypes

    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    del graph
    return types


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Kernel:
    """Accumulates one kernel's line of the final ``kernels`` record. Its
    times sum the calls of one unit of the path that launches it: the
    tensor-core flash, the four bf16 encoder sites of one layer of the
    serve at B=256, Sv=128, Sa=256; the 3xTF32 flash, the four f32
    encoder sites of one layer of the reference decode (B=8, d=128,
    Sv=128, Sa=160); the tensor-core folded attention, the audio and video
    calls of one layer's token step of the serve at B=256 (bf16 memory);
    the 3xTF32 folded attention, the same pair in the reference decode
    (B=8, G=4, draw 128, f32); LSTM, the four cells of one token; GRU, the
    two cells of one token (f32, B=256). Times are device times of calls
    replayed from a CUDA graph (``time_ms``)."""

    def __init__(self, name, source, replaces):
        self.rec = dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=0, max_abs_err=0.0,
                        ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="",
                        library_ms=0.0)
        self._bytes_ms = self._ops_ms = 0.0

    def add_main_shape(self, ms, plain_ms, library_ms, nbytes, ops, kind):
        """Add one call at the main path's shape to the summed times."""
        r = self.rec
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += library_ms
        self._bytes_ms += nbytes / PEAK_BYTES * 1e3
        self._ops_ms += ops / PEAK_OPS[kind] * 1e3
        r["bound_ms"] = max(self._bytes_ms, self._ops_ms)
        r["bound_by"] = ("bytes" if self._bytes_ms >= self._ops_ms
                         else "operations")

    def err(self, e):
        self.rec["max_abs_err"] = max(self.rec["max_abs_err"], e)


def host_draws_class():
    """A ``blocks.Draws`` whose generators live on the CPU and whose draws
    are copied to ``device``, so a run on the card takes the CPU run's
    draws (imported here: the script starts without the package)."""
    import torch

    from bmhrl_tpu_torch.models.blocks import Draws

    class HostDraws(Draws):
        def __init__(self, seed, device):
            super().__init__(seed, "cpu")
            self.target = torch.device(device)

        def _draw(self, fn, stream, *args):
            return super()._draw(fn, stream, *args).to(self.target)

    return HostDraws


def check_close(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err} > tol {tol}")
    return err


def folded_times(qe, mem, mask, scale):
    """Folded attention's (kernel, eager kernel, plain, library, bytes,
    ops). Each timed function cycles through copies of its inputs that
    together exceed the 50 MB L2 cache (at most 64 copies), as the decode
    finds the memories cold."""
    import torch

    from bmhrl_tpu_torch.ops import attention as att

    B, G, draw = qe.shape
    S = mem.shape[1]
    nbytes = (2 * B * G * draw * 4 + B * S * draw * mem.element_size()
              + (0 if mask is None else B * S * 4))
    n = min(64, max(1, math.ceil(120e6 / nbytes)))
    sets = [(qe, mem, mask)] + [
        (qe.clone(), mem.clone(), None if mask is None else mask.clone())
        for _ in range(n - 1)]
    negs = [torch.zeros(B, 1, S, device=mem.device, dtype=mem.dtype)
            if mk is None else
            torch.zeros(B, 1, S, device=mem.device, dtype=mem.dtype)
            .masked_fill(~(mk > 0)[:, None, :], -1e9) for _, _, mk in sets]

    def cycle(call):
        state = {"i": 0}

        def run():
            i = state["i"] % n
            state["i"] += 1
            return call(i, *sets[i])
        return run

    def library(i, q, m, mk):
        s = torch.matmul((q * scale).to(m.dtype), m.transpose(1, 2))
        p = torch.softmax((s + negs[i]).float(), dim=-1)
        return torch.matmul(p.to(m.dtype), m)

    iters = 4 * n
    ms = time_ms(cycle(lambda i, q, m, mk: att.folded_attend(
        q, m, mk, scale)), iters=iters)
    ems = eager_ms(cycle(lambda i, q, m, mk: att.folded_attend(
        q, m, mk, scale)), iters=iters)
    pms = time_ms(cycle(lambda i, q, m, mk: att.folded_attend_plain(
        q, m, mk, scale)), iters=iters)
    lms = time_ms(cycle(library), iters=iters)
    return ms, ems, pms, lms, nbytes, 4.0 * B * G * S * draw


# --------------------------------------------------------------------------
def phase_kernels(K):
    import torch
    import torch.nn.functional as Fn

    from bmhrl_tpu_torch.ops import attention as att
    from bmhrl_tpu_torch.ops import critic_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    # ---- flash attention: the 4 encoder sites of one layer at the serving
    # shape (main path), the long-source shape, and edge cases. bf16 at
    # d = 256 takes the tensor-core route (flash_attention_tc), f32 the
    # 3xTF32 route (flash_attention_simt); ops.attention.flash_route.
    H, d = 4, 256
    HD = H * d
    B = 256
    main_sites = [("V<-V", 128, 128), ("A<-A", 256, 256), ("V<-A", 128, 256),
                  ("A<-V", 256, 128)]
    long_sites = [("V<-A long", 300, 800), ("A<-A long", 800, 800)]
    route_rec = {"tc": K["flash_tc"], "simt": K["flash_simt"]}

    def flash_check(tag, q, k, v, mask, Hh, causal, masked_row, tol):
        """Kernel vs plain version; a fully-masked row must be mean(V) over
        its Sk keys. Returns (max error, route)."""
        route = att.flash_route(q.dtype, q.shape[2] // Hh)
        got = att.flash_attention_bsd(q, k, v, mask, Hh, causal)
        want = att.flash_attention_bsd_plain(q, k, v, mask, Hh, causal)
        torch.cuda.synchronize()
        e = check_close(f"flash {tag}", got, want, tol)
        if masked_row is not None:
            mean_v = v[masked_row].float().mean(0).expand_as(got[masked_row])
            e = max(e, check_close(f"flash {tag} masked row = mean(V)",
                                   got[masked_row], mean_v, tol))
        route_rec[route].err(e)
        return e, route

    f32_sites = {}  # the f32 flagship's sites on the 3xTF32 route
    for site, Sq, Sk in main_sites + long_sites:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(B, Sq, HD, dtype=dtype)
            k = randn(B, Sk, HD, dtype=dtype)
            v = randn(B, Sk, HD, dtype=dtype)
            lens = torch.randint(Sk // 2, Sk + 1, (B,), generator=g,
                                 device=dev)
            mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
            mask[1] = False  # one fully-masked row
            e, route = flash_check(f"{site} {TAG[dtype]}", q, k, v, mask, H,
                                   False, 1, TOL[dtype])
            ms = time_ms(lambda: att.flash_attention_bsd(q, k, v, mask, H))
            pms = time_ms(lambda: att.flash_attention_bsd_plain(
                q, k, v, mask, H), iters=5)
            qh, kh, vh = (x.view(B, -1, H, d).transpose(1, 2)
                          for x in (q, k, v))
            m4 = mask[:, None, None, :]
            lms = time_ms(lambda: Fn.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=m4))
            isz = q.element_size()
            nbytes = (2 * B * Sq * HD + 2 * B * Sk * HD) * isz + B * Sk * 4
            ops = 4.0 * B * H * Sq * Sk * d
            kind = "3xtf32" if route == "simt" else TAG[dtype]
            bms, by = bound_ms(nbytes, ops, kind)
            emit({"kernel": f"flash_attention_{route}", "case": site, "B": B,
                  "Sq": Sq, "Sk": Sk, "H": H, "d": d, "dtype": TAG[dtype],
                  "max_abs_err": e, "tol": TOL[dtype], "kernel_ms": ms,
                  "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
                  "bound_by": by})
            if route == "simt":
                f32_sites[site] = dict(
                    Sq=Sq, Sk=Sk, ms=ms, plain_ms=pms, library_ms=lms,
                    bound_ms=bms, bound_by=by,
                    cuda_core_bound_ms=ops / PEAK_OPS["f32"] * 1e3,
                    max_abs_err=e)
            if route == "tc" and "long" not in site:
                route_rec[route].add_main_shape(ms, pms, lms, nbytes, ops,
                                                kind)
            del q, k, v
    K["flash_simt"].rec["f32_flagship_sites"] = f32_sites
    K["flash_simt"].rec["f32_flagship_4_sites"] = {
        key: sum(f32_sites[site][key] for site, _, _ in main_sites)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                    "cuda_core_bound_ms")}

    def geometry_times(q, k, v, mask, Hh):
        """ms of one 3xTF32 flash call with blocks of 8 and of 4 warps (8 only
        where they fit), each held against the plain version;
        flash_simt_warps's choice is named."""
        Bq, Sq, HDq = q.shape
        dq = HDq // Hh
        want = att.flash_attention_bsd_plain(q, k, v, mask, Hh)
        out = {"chosen": att.flash_simt_warps(q.dtype, dq, Bq, Hh, Sq)}
        for w in (8, 4):
            if att.flash_simt_smem(q.dtype, dq, w) > att.MAX_SMEM:
                continue
            with mock.patch.object(att, "flash_simt_warps",
                                   lambda *a, w=w: w):
                got = att.flash_attention_bsd(q, k, v, mask, Hh)
                torch.cuda.synchronize()
                K["flash_simt"].err(check_close(
                    f"flash {w} warps", got, want, TOL[q.dtype]))
                out[f"warps{w}_ms"] = time_ms(
                    lambda: att.flash_attention_bsd(q, k, v, mask, Hh))
        return out

    # flash_simt_warps at the f32 flagship's grids of at most one 8-warp
    # block an SM: the encoder sites of the f32 CLI serve's batches (B=32)
    # and of f32 training (B=16), 8 and 4 warps timed
    for Bg in (32, 16):
        geo = {}
        for site, Sq, Sk in main_sites:
            q, k, v = (randn(Bg, s_, HD) for s_ in (Sq, Sk, Sk))
            lens = torch.randint(Sk // 2, Sk + 1, (Bg,), generator=g,
                                 device=dev)
            mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
            mask[1] = False
            geo[site] = geometry_times(q, k, v, mask, H)
            del q, k, v
        K["flash_simt"].rec[f"f32_flagship_geometry_B{Bg}"] = geo
        emit({"kernel": "flash_attention_simt", "case": "geometry",
              "B": Bg, "H": H, "d": d, "dtype": "f32", "sites": geo})
    # the DETR's memory cross-attention (Sk = 128 memory rows, bf16): the
    # token step of the greedy serve (32 clips, one query each) and of the
    # B=256 greedy rate, the beam step (64 clips, the W = 4 beams of a clip
    # as its queries) and the training decoder (B=16, 31 positions); each
    # with a fully-masked row. Timed beside their own line of the record.
    detr_sites = {}
    for site, Bd, Sq in (("greedy step B=32", 32, 1),
                         ("greedy step B=256", 256, 1),
                         ("beam W=4 step, 64 clips", 64, 4),
                         ("training decoder B=16", 16, 31)):
        Sk = 128
        q = randn(Bd, Sq, HD, dtype=torch.bfloat16)
        k = randn(Bd, Sk, HD, dtype=torch.bfloat16)
        v = randn(Bd, Sk, HD, dtype=torch.bfloat16)
        lens = torch.randint(Sk // 2, Sk + 1, (Bd,), generator=g, device=dev)
        mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
        mask[1] = False
        e, route = flash_check(f"DETR {site} bf16", q, k, v, mask, H, False,
                               1, TOL[torch.bfloat16])
        if route != "tc":
            raise AssertionError(f"flash DETR {site} took route {route}")
        ms = time_ms(lambda: att.flash_attention_bsd(q, k, v, mask, H))
        pms = time_ms(lambda: att.flash_attention_bsd_plain(q, k, v, mask,
                                                            H))
        qh, kh, vh = (x.view(Bd, -1, H, d).transpose(1, 2) for x in (q, k, v))
        m4 = mask[:, None, None, :]
        lms = time_ms(lambda: Fn.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m4))
        nbytes = (2 * Bd * Sq * HD + 2 * Bd * Sk * HD) * 2 + Bd * Sk * 4
        ops = 4.0 * Bd * H * Sq * Sk * d
        bms, by = bound_ms(nbytes, ops, "bf16")
        detr_sites[site] = dict(B=Bd, Sq=Sq, Sk=Sk, ms=ms, plain_ms=pms,
                                library_ms=lms, bound_ms=bms, bound_by=by,
                                max_abs_err=e)
        emit({"kernel": "flash_attention_tc", "case": f"DETR {site}",
              "B": Bd, "Sq": Sq, "Sk": Sk, "H": H, "d": d, "dtype": "bf16",
              "max_abs_err": e, "tol": TOL[torch.bfloat16], "kernel_ms": ms,
              "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
              "bound_by": by})
        del q, k, v
    K["flash_tc"].rec["detr_cross_attention"] = detr_sites
    # the 3xTF32 route's own path: the four encoder sites of one layer of
    # the reference phase's small f32 decode (B = 8, 2 heads of d = 128,
    # Sv = 128, Sa = 160), each with a fully-masked row
    Hr, dr, Br = 2, 128, 8
    for site, Sq, Sk in (("V<-V", 128, 128), ("A<-A", 160, 160),
                         ("V<-A", 128, 160), ("A<-V", 160, 128)):
        q, k, v = (randn(Br, s, Hr * dr) for s in (Sq, Sk, Sk))
        lens = torch.randint(Sk // 2, Sk + 1, (Br,), generator=g, device=dev)
        mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
        mask[5] = False
        e, route = flash_check(f"reference {site} f32", q, k, v, mask, Hr,
                               False, 5, TOL[torch.float32])
        ms = time_ms(lambda: att.flash_attention_bsd(q, k, v, mask, Hr))
        pms = time_ms(lambda: att.flash_attention_bsd_plain(q, k, v, mask,
                                                            Hr))
        qh, kh, vh = (x.view(Br, -1, Hr, dr).transpose(1, 2)
                      for x in (q, k, v))
        m4 = mask[:, None, None, :]
        lms = time_ms(lambda: Fn.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m4))
        nbytes = (2 * Br * Sq + 2 * Br * Sk) * Hr * dr * 4 + Br * Sk * 4
        ops = 4.0 * Br * Hr * Sq * Sk * dr
        bms, by = bound_ms(nbytes, ops, "3xtf32")
        emit({"kernel": f"flash_attention_{route}",
              "case": f"reference {site}", "B": Br, "Sq": Sq, "Sk": Sk,
              "H": Hr, "d": dr, "dtype": "f32", "max_abs_err": e,
              "tol": TOL[torch.float32], "kernel_ms": ms, "plain_ms": pms,
              "library_ms": lms, "bound_ms": bms, "bound_by": by,
              "warps": att.flash_simt_warps(q.dtype, dr, Br, Hr, Sq)})
        route_rec[route].add_main_shape(ms, pms, lms, nbytes, ops, "3xtf32")
        if site == "V<-V":
            K["flash_simt"].rec["reference_VV_geometry"] = geometry_times(
                q, k, v, mask, Hr)
        K["flash_simt"].rec["cuda_core_bound_ms"] = (
            K["flash_simt"].rec.get("cuda_core_bound_ms", 0.0)
            + ops / PEAK_OPS["f32"] * 1e3)
    # edge cases, each with a fully-masked row where there is a mask: Sq and
    # Sk not multiples of the tiles (tensor core: 128 queries, 64 keys;
    # 3xTF32: 16 keys a warp, 16-128 queries a block), one key, causal, no
    # mask, d = 128 to 512 (bf16 at 128 and 256 on the tensor-core route).
    # At B = 4 the 3xTF32 route takes 4-warp blocks at d <= 256 (its grid
    # is small), 8 at d 384 and bf16 d 512, 4 at f32 d 512
    for Sq, Sk, causal, use_mask, dh in (
            (37, 130, False, True, 256), (65, 129, False, True, 256),
            (300, 300, True, True, 256), (64, 129, False, False, 256),
            (300, 800, False, True, 256), (65, 300, False, True, 128),
            (37, 800, True, True, 128), (300, 130, False, True, 128),
            (65, 130, False, True, 512), (1, 1, False, True, 128),
            (37, 20, True, True, 128), (300, 1, False, True, 256),
            (65, 20, False, True, 256), (16, 33, True, True, 384),
            (100, 17, False, True, 512), (1, 130, True, True, 512),
            (129, 257, True, False, 384), (200, 45, False, True, 512)):
        Hh = HD // dh
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(4, s, HD, dtype=dtype) for s in (Sq, Sk, Sk))
            mask, masked_row = None, None
            if use_mask:
                mask = torch.rand(4, Sk, generator=g, device=dev) > 0.3
                mask[2] = False
                masked_row = 2
            e, route = flash_check("edge", q, k, v, mask, Hh, causal,
                                   masked_row, TOL[dtype])
            emit({"kernel": f"flash_attention_{route}", "case": "edge",
                  "Sq": Sq, "Sk": Sk, "d": dh, "causal": causal,
                  "mask": use_mask, "dtype": TAG[dtype], "max_abs_err": e,
                  "tol": TOL[dtype], "warps":
                  att.flash_simt_warps(dtype, dh, 4, Hh, Sq)
                  if route == "simt" else None})

    # ---- folded attention: both branches of one layer-step (G = 2 stacks x
    # 4 heads) at the serving shapes, B = 256 and 32, and the long-source
    # shapes. bf16 memory takes the tensor-core route (folded_attend_tc), f32
    # the 3xTF32 route (folded_attend_simt); ops.attention.folded_route.
    folded_rec = {"tc": K["folded_tc"], "simt": K["folded_simt"]}

    def folded_case(B, G, S, draw, dtype, use_mask=True, qscale=0.05):
        """Inputs of one folded call; row B - 1 is fully masked where there
        is a mask (unless B = 1)."""
        qe = randn(B, G, draw, scale=qscale)
        mem = randn(B, S, draw, dtype=dtype)
        if not use_mask:
            return qe, mem, None
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])
        if B > 1:
            mask[B - 1] = False
        return qe, mem, mask.to(torch.int32)

    def folded_check(tag, qe, mem, mask, scale):
        """Kernel vs plain version within 1e-4; a fully-masked row must be
        mean(mem) over its own S keys. Returns (max error, route)."""
        B, G, draw = qe.shape
        route = att.folded_route(mem.dtype, draw)
        got = att.folded_attend(qe, mem, mask, scale)
        want = att.folded_attend_plain(qe, mem, mask, scale)
        torch.cuda.synchronize()
        e = check_close(f"folded {tag}", got, want, 1e-4)
        if mask is not None and B > 1:
            e = max(e, check_close(
                f"folded {tag} masked row = mean(mem)", got[B - 1],
                mem[B - 1].float().mean(0).expand(G, -1), 1e-4))
        folded_rec[route].err(e)
        return e, route

    def folded_vs_f64(qe, mem, mask, scale):
        """Largest errors of the kernel and of the f32 plain version against
        the same function in float64."""
        s_ = (qe.double() * scale) @ mem.double().transpose(1, 2)
        s_ = s_.masked_fill(~(mask > 0)[:, None, :], att.NEG_INF)
        p_ = torch.exp(s_ - s_.amax(-1, keepdim=True))
        ref = (p_ @ mem.double()) / p_.sum(-1, keepdim=True)
        got = att.folded_attend(qe, mem, mask, scale)
        want = att.folded_attend_plain(qe, mem, mask, scale)
        return {"kernel_vs_f64": (got.double() - ref).abs().max().item(),
                "plain_vs_f64": (want.double() - ref).abs().max().item()}

    G = 8
    scale = 1.0 / math.sqrt(d)
    for Bf in (B, 32):
        pair = dict(kernel_ms=0.0, eager_ms=0.0, plain_ms=0.0,
                    library_ms=0.0, bound_ms=0.0)
        # the f32 greedy decode's pair on the 3xTF32 route
        f32_pair = dict(kernel_ms=0.0, plain_ms=0.0, library_ms=0.0,
                        bound_ms=0.0, cuda_core_bound_ms=0.0)
        for case, S, draw in (("V", 128, 1024), ("A", 256, 128),
                              ("V long", 300, 1024), ("A long", 800, 128)):
            for dtype in (torch.float32, torch.bfloat16):
                qe, mem, mask_i = folded_case(Bf, G, S, draw, dtype)
                e, route = folded_check(f"{case} B={Bf} {TAG[dtype]}", qe,
                                        mem, mask_i, scale)
                ms, ems, pms, lms, nbytes, ops = folded_times(qe, mem, mask_i,
                                                              scale)
                bms, by = bound_ms(nbytes, ops,
                                   "3xtf32" if route == "simt" else "f32")
                emit({"kernel": f"folded_attend_{route}", "case": case,
                      "B": Bf, "G": G, "S": S, "draw": draw,
                      "dtype": TAG[dtype],
                      "split": att.folded_split(Bf, S) if route == "tc"
                      else att.folded_simt_split(
                          Bf * -(-G // att.folded_simt_chunk(draw)), S),
                      "max_abs_err": e, "tol": 1e-4,
                      "kernel_ms": ms, "eager_ms": ems, "plain_ms": pms,
                      "library_ms": lms, "bound_ms": bms, "bound_by": by})
                if route == "simt" and "long" not in case:
                    for key, v in (("kernel_ms", ms), ("plain_ms", pms),
                                   ("library_ms", lms), ("bound_ms", bms),
                                   ("cuda_core_bound_ms",
                                    ops / PEAK_OPS["f32"] * 1e3)):
                        f32_pair[key] += v
                if route == "tc" and "long" not in case:
                    for key, v in (("kernel_ms", ms), ("eager_ms", ems),
                                   ("plain_ms", pms), ("library_ms", lms),
                                   ("bound_ms", bms)):
                        pair[key] += v
                    if Bf == B:
                        K["folded_tc"].add_main_shape(ms, pms, lms, nbytes,
                                                      ops, "f32")
                del qe, mem, mask_i
        emit({"kernel": "folded_attend_tc", "case": "A + V pair", "B": Bf,
              **pair})
        emit({"kernel": "folded_attend_simt", "case": "f32 A + V pair",
              "B": Bf, **f32_pair})
        K["folded_simt"].rec[f"f32_greedy_pair_B{Bf}"] = f32_pair
    # the 3xTF32 route's own path: the audio and video calls of one
    # layer-step of the reference phase's small f32 decode (B = 8, G = 2
    # stacks x 2 heads, draw 128, Sv = 128, Sa = 160), each with a
    # fully-masked row
    for case, S in (("reference V", 128), ("reference A", 160)):
        qe, mem, mask_i = folded_case(8, 4, S, 128, torch.float32)
        e, route = folded_check(case, qe, mem, mask_i, 1.0 / math.sqrt(128))
        ms, ems, pms, lms, nbytes, ops = folded_times(qe, mem, mask_i,
                                                      1.0 / math.sqrt(128))
        bms, by = bound_ms(nbytes, ops, "3xtf32")
        emit({"kernel": f"folded_attend_{route}", "case": case, "B": 8,
              "G": 4, "S": S, "draw": 128, "dtype": "f32",
              "split": att.folded_simt_split(8, S),
              "max_abs_err": e, "tol": 1e-4, "kernel_ms": ms,
              "eager_ms": ems, "plain_ms": pms, "library_ms": lms,
              "bound_ms": bms, "bound_by": by})
        K["folded_simt"].add_main_shape(ms, pms, lms, nbytes, ops, "3xtf32")
        # folded_simt_split's choice (8 blocks a clip) against 4
        with mock.patch.object(att, "folded_simt_split", lambda b, s: 4):
            K["folded_simt"].rec[f"{case}_split4_ms"] = folded_times(
                qe, mem, mask_i, 1.0 / math.sqrt(128))[0]
        K["folded_simt"].rec["cuda_core_bound_ms"] = (
            K["folded_simt"].rec.get("cuda_core_bound_ms", 0.0)
            + ops / PEAK_OPS["f32"] * 1e3)
    # the 3xTF32 route at the f32 beam's video call: 64 clips, S 128, draw
    # 1024, G = 2 stacks x 4 heads x W beams for W = 1, 3, 4, 8; above
    # ops.attention.folded_simt_chunk(1024) = 16 queries a clip takes
    # several blocks. Within 1e-5 of the plain version; G = 32 (W = 4) is
    # timed
    for Gb in (8, 24, 32, 64):
        qe, mem, mask_i = folded_case(64, Gb, 128, 1024, torch.float32)
        got = att.folded_attend(qe, mem, mask_i, scale)
        want = att.folded_attend_plain(qe, mem, mask_i, scale)
        torch.cuda.synchronize()
        if att.folded_route(mem.dtype, 1024) != "simt":
            raise AssertionError("an f32 memory left the 3xTF32 route")
        e = check_close(f"folded f32 G={Gb}", got, want, 1e-5)
        e = max(e, check_close(f"folded f32 G={Gb} masked row = mean(mem)",
                               got[63], mem[63].mean(0).expand(Gb, -1),
                               1e-5))
        K["folded_simt"].err(e)
        rec = {"G": Gb, "chunk": att.folded_simt_chunk(1024),
               "max_abs_err": e, "tol": 1e-5}
        if Gb == 32:
            ms, ems, pms, lms, nbytes, ops = folded_times(qe, mem, mask_i,
                                                          scale)
            bms, by = bound_ms(nbytes, ops, "3xtf32")
            # folded_simt_split's choice (1 at 128 blocks) against 2
            with mock.patch.object(att, "folded_simt_split", lambda b, s: 2):
                split2 = folded_times(qe, mem, mask_i, scale)[0]
            rec.update(kernel_ms=ms, eager_ms=ems, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by,
                       cuda_core_bound_ms=ops / PEAK_OPS["f32"] * 1e3,
                       split=att.folded_simt_split(
                           64 * -(-Gb // att.folded_simt_chunk(1024)), 128),
                       split2_ms=split2)
            K["folded_simt"].rec["f32_beam_V_B64_G32"] = rec
        emit({"kernel": "folded_attend_simt", "case": "f32 beam V", "B": 64,
              "S": 128, "draw": 1024, **rec})
        del qe, mem, mask_i, got, want
    # 3xTF32 edge cases, f32 and bf16 (bf16 at draw 128 and 1024 takes the
    # tensor-core route), each with a fully-masked row: G = 4, 12, 32, 64
    # (ragged and several query blocks) at draw 64, 128, 300 (rows not
    # 16-byte aligned in bf16), 1024, 1152 (8-query blocks), 2048 (two
    # column slabs), 2500 (two slabs, the last ragged, bf16 rows 8-byte
    # aligned) and 19200 (12 slabs) over S = 129 keys (3 clips split over 8
    # cluster blocks: 3 of them without keys); one key and S = 37 (not a
    # multiple of 16) at G = 12
    for Ge in (4, 12, 32, 64):
        for draw in (64, 128, 300, 1024, 1152, 2048, 2500, 19200):
            for dtype in (torch.float32, torch.bfloat16):
                for S in ((129, 1, 37) if Ge == 12 else (129,)):
                    qe, mem, mask_i = folded_case(3, Ge, S, draw, dtype,
                                                  qscale=0.3)
                    e, route = folded_check("edge", qe, mem, mask_i,
                                            1.0 / 16)
                    rec = {"kernel": f"folded_attend_{route}", "case": "edge",
                           "B": 3, "G": Ge, "S": S, "draw": draw,
                           "dtype": TAG[dtype], "split":
                           att.folded_split(3, S) if route == "tc" else
                           att.folded_simt_split(
                               3 * -(-Ge // att.folded_simt_chunk(draw))
                               * att.folded_simt_slabs(draw), S),
                           "max_abs_err": e, "tol": 1e-4}
                    if draw > 1664:
                        # several column slabs: kernel and plain version
                        # each against float64
                        rec.update(folded_vs_f64(qe, mem, mask_i, 1.0 / 16))
                    emit(rec)
    # tensor-core edge cases, each with a fully-masked row where there is a
    # mask: one key, S not a multiple of 16, blocks of the cluster with no
    # keys (S = 129 over 4, 260 over 8, 300 over 8), long S, B = 1, G = 4,
    # 12 (a ragged query chunk) and 32, no mask, draw 128 to 1024
    for Be, Ge, S, draw, use_mask in (
            (1, 8, 1, 1024, False), (2, 8, 1, 128, True),
            (4, 8, 20, 128, True), (2, 8, 129, 384, True),
            (2, 8, 260, 128, True), (2, 32, 300, 1024, False),
            (3, 4, 800, 128, True), (1, 8, 300, 1024, False),
            (5, 12, 129, 1024, True), (64, 8, 128, 1024, True),
            (7, 32, 800, 512, True)):
        qe, mem, mask_i = folded_case(Be, Ge, S, draw, torch.bfloat16,
                                      use_mask, qscale=0.3)
        e, route = folded_check("edge", qe, mem, mask_i, 1.0 / 16)
        if route != "tc":
            raise AssertionError(f"folded edge case took the {route} route")
        emit({"kernel": "folded_attend_tc", "case": "edge", "B": Be,
              "G": Ge, "S": S, "draw": draw, "mask": use_mask,
              "split": att.folded_split(Be, S), "max_abs_err": e,
              "tol": 1e-4})
    # views, taken with their strides: q_eff every other query of a wider
    # tensor, mem the first 128 rows of a 136-row memory
    qe, mem, mask_i = folded_case(4, 16, 136, 1024, torch.bfloat16,
                                  qscale=0.3)
    qe, mem, mask_i = qe[:, ::2], mem[:, :128], mask_i[:, :128].contiguous()
    mask_i[3] = 0
    e, route = folded_check("strided views", qe, mem, mask_i, 1.0 / 16)
    emit({"kernel": f"folded_attend_{route}", "case": "edge, strided views",
          "q_stride": list(qe.stride()), "mem_stride": list(mem.stride()),
          "max_abs_err": e, "tol": 1e-4})
    del qe, mem, mask_i
    # one tensor-core call (the serve's video call) is one kernel launch: no
    # scale, cast or copy kernel beside it
    qe, mem, mask_i = folded_case(B, G, 128, 1024, torch.bfloat16)
    types = graph_node_types(lambda: att.folded_attend(qe, mem, mask_i,
                                                       scale))
    emit({"kernel": "folded_attend_tc", "case": "graph of one call",
          "node_types": types})
    if types != [0]:
        raise AssertionError(f"one folded_attend_tc call is {types}")
    del qe, mem, mask_i
    # ---- critic cells: the 4 LSTM and 2 GRU cells of one token (f32), over
    # weights packed once (not timed: a decode packs once per call)
    def cell_inputs(n_gates, Bc, Kin, Hc):
        bound = 1.0 / math.sqrt(Hc)
        return (randn(Bc, Kin), randn(Bc, Hc, scale=0.5),
                randn(Bc, Hc, scale=0.5), randn(n_gates * Hc, Kin, scale=bound),
                randn(n_gates * Hc, Hc, scale=bound),
                randn(n_gates * Hc, scale=bound),
                randn(n_gates * Hc, scale=bound))

    def cell_fns(name, x, h, c, w_ih, w_hh, b_ih, b_hh):
        """(kernel, packed plain version, unpacked plain version) closures."""
        if name == "lstm_cell":
            p = ck.pack_lstm(w_ih, w_hh, b_ih + b_hh)
            return (lambda: ck.lstm_cell_packed(x, h, c, p),
                    lambda: ck.lstm_cell_packed_plain(x, h, c, p),
                    lambda: ck.lstm_cell_plain(x, h, c, w_ih, w_hh,
                                               b_ih + b_hh))
        p = ck.pack_gru(w_ih, w_hh, b_ih, b_hh)
        return (lambda: (ck.gru_cell_packed(x, h, p),),
                lambda: (ck.gru_cell_packed_plain(x, h, p),),
                lambda: (ck.gru_cell_plain(x, h, w_ih, w_hh, b_ih, b_hh),))

    def cell_check(name, fns):
        run, plain, unpacked = fns
        got, want, want_u = run(), plain(), unpacked()
        torch.cuda.synchronize()
        return max(max(check_close(f"{name} {i}", a, b, 1e-5),
                       check_close(f"{name} {i} vs unpacked", a, u, 1e-5))
                   for i, (a, b, u) in enumerate(zip(got, want, want_u)))

    Hc = 600
    for name, n_gates, Kin, layers in (("lstm_cell", 4, 300, 1),
                                       ("lstm_cell", 4, 600, 3),
                                       ("gru_cell", 3, 600, 2)):
        for Bc in (B, 32):
            x, h, c, w_ih, w_hh, b_ih, b_hh = cell_inputs(n_gates, Bc, Kin,
                                                          Hc)
            fns = cell_fns(name, x, h, c, w_ih, w_hh, b_ih, b_hh)
            e = cell_check(name, fns)
            lstm = name == "lstm_cell"
            cell = (torch.nn.LSTMCell if lstm else torch.nn.GRUCell)(
                Kin, Hc, device=dev)
            with torch.no_grad():
                cell.weight_ih.copy_(w_ih)
                cell.weight_hh.copy_(w_hh)
                cell.bias_ih.copy_(b_ih)
                cell.bias_hh.copy_(b_hh)
                lib_call = ((lambda: cell(x, (h, c))) if lstm
                            else (lambda: cell(x, h)))
                check_close(f"{name} vs torch.nn cell", lib_call()[0]
                            if lstm else lib_call(), fns[0]()[0], 1e-5)
                lms = time_ms(lib_call)
            K[name].err(e)
            ms = time_ms(fns[0])
            pms = time_ms(fns[1])
            out_elems = (2 if lstm else 1) * Bc * Hc
            in_elems = Bc * (Kin + (2 if lstm else 1) * Hc)
            nbytes = 4.0 * (n_gates * Hc * (Kin + Hc) + 2 * n_gates * Hc
                            + in_elems + out_elems)
            ops = 2.0 * Bc * n_gates * Hc * (Kin + Hc)
            bms, by = bound_ms(nbytes, ops, "f32")
            emit({"kernel": name, "case": f"K={Kin} x{layers} per token",
                  "B": Bc, "K": Kin, "H": Hc, "dtype": "f32",
                  "max_abs_err": e, "tol": 1e-5, "kernel_ms": ms,
                  "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
                  "bound_by": by})
            if Bc == B:
                for _ in range(layers):
                    K[name].add_main_shape(ms, pms, lms, nbytes, ops, "f32")
    # ragged edges: H not a multiple of the 8-unit tile, K and H not of the
    # 32-row contraction tile, K % 4 != 0 (4-byte activation copies), B not
    # a multiple of the 128-row tile
    for Bc, Kin, Hc in ((3, 75, 150), (64, 20, 20), (1, 300, 600),
                        (129, 37, 21)):
        for name, n_gates in (("lstm_cell", 4), ("gru_cell", 3)):
            e = cell_check(name, cell_fns(name, *cell_inputs(n_gates, Bc, Kin,
                                                             Hc)))
            K[name].err(e)
            emit({"kernel": name, "case": "edge", "B": Bc, "K": Kin, "H": Hc,
                  "max_abs_err": e, "tol": 1e-5})


# --------------------------------------------------------------------------
def build_model(kwargs, device, seed=0):
    """A ``BMHrlAgent(**kwargs)`` on ``device`` with random weights from
    ``seed``, loaded through the JAX-layout loader."""
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.weights import (load_jax_params,
                                         random_jax_layout_params)

    model = BMHrlAgent(**kwargs, device=device)
    load_jax_params(model, random_jax_layout_params(kwargs, seed))
    return model.eval().requires_grad_(False)


def make_feats(B, Sv, Sa, d_v, d_a, device, seed=0):
    import torch

    rng = np.random.RandomState(seed)
    f = {"rgb": rng.rand(B, Sv, d_v), "flow": rng.rand(B, Sv, d_v),
         "audio": rng.rand(B, Sa, d_a)}
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in f.items()}


def phase_reference(K):
    """Small f32 model: kernels on the card vs plain versions on the CPU.
    f32 attention takes the 3xTF32 flash and folded routes, so this is
    the run whose launches count for flash_attention_simt and
    folded_attend_simt (the bf16 serve never takes those routes)."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import decode

    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(dict(SMALL, dtype=torch.float32), device, seed=3)
        feats = make_feats(8, 128, 160, 128, 128, device, seed=3)
        feats["audio"][2, 90:] = 0.0     # ragged audio
        feats["rgb"][5] = 0.0            # a zero-feature (fully masked) row
        _cuda.reset_launches()
        tok, prob = decode(model, feats, make_masks(feats), 12, 2, 3, 1)
        out[device] = (tok.cpu(), prob.cpu())
        if device == "cuda":
            launches = dict(_cuda.LAUNCHES)
    for name in ("flash_attention_simt", "folded_attend_simt"):
        K[name].rec["launches"] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"the f32 decode never launched {name}")
    same = bool(torch.equal(out["cuda"][0], out["cpu"][0]))
    perr = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    emit({"phase": "reference", "dims": "small", "dtype": "f32",
          "tokens_identical": same, "prob_max_abs_err": perr, "tol": 1e-4,
          "launches": launches})
    if not same or perr > 1e-4:
        raise AssertionError("card decode disagrees with the CPU reference")


@contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions (for comparing
    a whole decode on the card)."""
    from bmhrl_tpu_torch.ops import attention as att
    from bmhrl_tpu_torch.ops import critic_kernels as ck

    with mock.patch.object(att, "flash_attention_bsd",
                           att.flash_attention_bsd_plain), \
            mock.patch.object(att, "folded_attend", att.folded_attend_plain), \
            mock.patch.object(ck, "lstm_cell_packed",
                              ck.lstm_cell_packed_plain), \
            mock.patch.object(ck, "gru_cell_packed",
                              ck.gru_cell_packed_plain):
        yield


def write_requests(root, seed=0):
    """64 requests as .npy files under ``root``: 40 in the (128, 256)
    bucket pair (a full batch of 32 and a tail of 8), 12 in (224, 512) and
    11 in (300, 800) (tails padded to 16 with zero rows), and one with no
    feature files (zero features: fully masked)."""
    from bmhrl_tpu_torch.serve import ClipRequest

    rng = np.random.RandomState(seed)
    vdir, adir = os.path.join(root, "i3d"), os.path.join(root, "vggish")
    os.makedirs(vdir)
    os.makedirs(adir)
    reqs = []
    for i in range(64):
        vid = f"v{i:03d}"
        Tv, Ta = (100, 240) if i <= 40 else (200, 500) if i <= 52 \
            else (300, 800)
        if i != 7:
            for kind in ("rgb", "flow"):
                np.save(os.path.join(vdir, f"{vid}_{kind}.npy"),
                        rng.rand(Tv, 1024).astype(np.float32))
            np.save(os.path.join(adir, f"{vid}.npy"),
                    rng.rand(Ta, 128).astype(np.float32))
        reqs.append(ClipRequest(vid, 0.0, 10.0, 10.0))
    return vdir, adir, reqs


def phase_serve(K):
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, PAD, SPECIALS
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.serve import CaptionServer
    from bmhrl_tpu_torch.train.decode import decode

    cfg = Config()  # the flagship: d_model 1024, 4 heads, 2 layers, bf16
    t0 = time.perf_counter()
    model = build_model(cfg.agent_kwargs(VOC), "cuda")
    emit({"phase": "serve", "model_build_s": time.perf_counter() - t0,
          "params": sum(p.numel() for p in model.parameters())})
    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]

    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        cfg = cfg.replace(video_features_path=vdir, audio_features_path=adir)
        server = CaptionServer(cfg, model, itos, device="cuda")
        server.caption(reqs[:3], batch_size=32)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        preds, stats = server.caption(reqs, batch_size=32)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    sents = [s["sentence"] for segs in preds["results"].values()
             for s in segs]
    emit({"phase": "serve", "requests": len(reqs), "answered": len(sents),
          "empty": sum(1 for s in sents if not s),
          "stats": stats.summary(), "launches": launches,
          "example": sents[:3]})
    if len(sents) != len(reqs) or not all(sents):
        raise AssertionError("a request got no sentence")
    if stats.padded_rows == 0:
        raise AssertionError("the run had no padded tail batch")
    # every kernel of the bf16 serving path launched; the 3xTF32 flash
    # and folded routes are not on it (their launches are counted in the
    # reference phase)
    for name in ("flash_attention_simt", "folded_attend_simt"):
        if launches.pop(name):
            raise AssertionError(f"the bf16 serve took the 3xTF32 route "
                                 f"{name}")
    for name, n in launches.items():
        K[name].rec["launches"] = n
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # greedy decode throughput at the bench's serving shapes (full 30
    # tokens: end_idx -1 never stops early, as bench.py measures)
    for B in (32, 256):
        feats = make_feats(B, 128, 256, 1024, 128, "cuda", seed=B)
        masks = make_masks(feats)
        run = lambda: decode(model, feats, masks, 30, BOS, -1, PAD)  # noqa
        run()
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            samples.append(B / (time.perf_counter() - t))
        emit({"phase": "throughput", "B": B, "Sv": 128, "Sa": 256,
              "max_len": 30, "clips_per_s": statistics.median(samples),
              "samples": samples})

    # the same decode through the plain versions on the card
    feats = make_feats(64, 128, 256, 1024, 128, "cuda", seed=7)
    masks = make_masks(feats)
    tok_k, prob_k = decode(model, feats, masks, 30, BOS, -1, PAD)
    with plain_kernels():
        tok_p, prob_p = decode(model, feats, masks, 30, BOS, -1, PAD)
    if not torch.isfinite(prob_k).all() or prob_k[:, 1:].min() <= 0:
        raise AssertionError("non-finite or zero chosen-token probabilities")
    free = float((tok_k == tok_p).float()[:, 1:].mean())
    forced, regret = forced_agreement(model, feats, masks, tok_p)
    emit({"phase": "plain_vs_kernels", "B": 64, "dtype": "bf16",
          "token_agreement": forced, "min_required": 0.95,
          "max_logprob_gap_where_they_differ": regret,
          "free_running_token_agreement": free})
    if forced < 0.95:
        raise AssertionError(f"token agreement {forced} < 0.95")
    return model


def forced_agreement(model, feats, masks, tokens):
    """Per-step argmax agreement of the kernel and plain decode steps fed
    the same tokens (the plain run's). A free-running comparison lets one
    bf16 near-tie change every later token of its row; feeding both the
    same tokens counts each step once. Also returns the largest log-prob
    gap, under the kernel path, between the two choices where they differ
    (small: the flips are near-ties)."""
    import torch

    B, L = tokens.shape
    V = feats["rgb"] + feats["flow"]
    with torch.no_grad():
        mem_k = model.encode(V, feats["audio"], masks)
        with plain_kernels():
            mem_p = model.encode(V, feats["audio"], masks)
        ck, vk, step_k = model.fast_setup(*mem_k, masks, B, L)
        cp, vp, step_p = model.fast_setup(*mem_p, masks, B, L)
        same, regret = [], 0.0
        for t in range(L - 1):
            tok_t = tokens[:, t]
            for valid in (vk, vp):
                valid[:, t] = tok_t != 1
                valid[:, 0] = True
            pos = torch.tensor(t, device=tok_t.device)
            lk, ck = step_k(tok_t, pos, ck, vk)
            with plain_kernels():
                lp, cp = step_p(tok_t, pos, cp, vp)
            ak, ap = lk.argmax(-1), lp.argmax(-1)
            same.append(ak == ap)
            gap = lk.gather(1, ak[:, None]) - lk.gather(1, ap[:, None])
            regret = max(regret, float(gap.max()))
    return float(torch.stack(same).float().mean()), regret


# --------------------------------------------------------------------------
def small_modes_card_vs_cpu():
    """The small f32 model decoded in every mode on the card (kernels) and
    on the CPU (plain versions), the same draws fed to both: beam W=3 at
    length penalty 0 and 1, sampled (temperature 0.8, top_k 5, top_p 0.9),
    the full-buffer greedy, beam and exploration decodes. Identical tokens,
    probabilities and scores within 1e-4; on the card the full-buffer
    greedy and beam decodes give the fast loops' tokens."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode

    HostDraws = host_draws_class()
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(dict(SMALL, dtype=torch.float32), device, seed=3)
        feats = make_feats(8, 128, 160, 128, 128, device, seed=3)
        feats["audio"][2, 90:] = 0.0     # ragged audio
        feats["rgb"][5] = 0.0            # a zero-feature (fully masked) row
        masks = make_masks(feats)
        args = (model, feats, masks, 12, 2, 3, 1)
        _cuda.reset_launches()
        runs = {
            "fast_greedy": decode(*args),
            "beam_lp0": beam_decode(*args, beam_width=3),
            "beam_lp1": beam_decode(*args, beam_width=3, length_penalty=1.0),
            "sampled": decode(*args, greedy=False,
                              draws=HostDraws(5, device), temperature=0.8,
                              top_k=5, top_p=0.9),
            "full_greedy": decode(*args, use_fast=False),
            "full_beam": beam_decode(*args, beam_width=3, use_fast=False),
            "full_explore": decode(*args, exploration=True,
                                   draws=HostDraws(6, device))}
        out[device] = {k: (t.cpu(), p.cpu()) for k, (t, p) in runs.items()}
        if device == "cuda":
            launches = dict(_cuda.LAUNCHES)
    res = {}
    for k, (tok, p) in out["cuda"].items():
        tok_h, p_h = out["cpu"][k]
        res[k] = {"tokens_identical": bool(torch.equal(tok, tok_h)),
                  "max_abs_err": float((p - p_h).abs().max())}
    card = out["cuda"]
    res["card_full_greedy_eq_fast"] = bool(torch.equal(
        card["full_greedy"][0], card["fast_greedy"][0]))
    res["card_full_beam_eq_fast"] = bool(torch.equal(
        card["full_beam"][0], card["beam_lp0"][0]))
    emit({"phase": "decode_modes", "check": "small_card_vs_cpu",
          "dtype": "f32", "results": res, "tol": 1e-4,
          "launches": launches})
    bad = [k for k, v in res.items() if v is False or isinstance(v, dict) and (
        not v["tokens_identical"] or not v["max_abs_err"] <= 1e-4)]
    if bad:
        raise AssertionError(f"decode modes, card vs CPU: {bad}")


def score_gap(model, feats, masks, tokens, scores, end_idx, rows_per_clip):
    """Largest |beam score - sum of its tokens' log-probs| (up to and
    including </s>) under the fast step fed the beam's tokens, each clip's
    tokens on ``rows_per_clip`` rows: 1 is the greedy layout; W is the
    beam loop's (the W beams of a clip on one folded call), where the step
    computes each row as the beam loop did, so a parent gather that moved
    any cache wrongly shows above bf16 rounding."""
    import torch

    tokens = tokens.repeat_interleave(rows_per_clip, 0)
    scores = scores.repeat_interleave(rows_per_clip, 0)
    B, L = tokens.shape
    with torch.no_grad():
        Va, Av = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                              masks)
        caches, valid, step = model.fast_setup(Va, Av, masks, B, L,
                                               beam_share=rows_per_clip)
        total = torch.zeros(B, device=tokens.device)
        ended = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        for t in range(L - 1):
            valid[:, t] = tokens[:, t] != 1
            valid[:, 0] = True
            logp, caches = step(tokens[:, t],
                                torch.tensor(t, device=tokens.device),
                                caches, valid)
            total += torch.where(ended, 0.0, logp.gather(
                1, tokens[:, t + 1, None])[:, 0])
            ended |= tokens[:, t + 1] == end_idx
    return float((scores - total).abs().max())


def full_buffer_forced(model, feats, masks, tokens):
    """Per-step argmax agreement of the full-buffer token
    (``train.decode.full_step``, the production loop's, on
    ``full_state``'s start) with ``tokens`` (a fast decode's), the buffer
    fed those tokens (it starts with <s>), and the flash launches of the
    steps (the encoder's and the memory projections' excluded)."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.decode import full_state, full_step

    B, L = tokens.shape
    with torch.no_grad():
        Va, Av = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                              masks)
        caches, valid, inv = full_state(model, Va, Av, masks, B, L)
        positions = torch.arange(L, device=tokens.device)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        same = []
        for t in range(L - 1):
            logp, caches = full_step(model, tokens[:, t], positions[t],
                                     caches, valid, inv)
            same.append(logp.argmax(-1) == tokens[:, t + 1])
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    return float(torch.stack(same).float().mean()), launches


def folded_beam_shape(K):
    """K3 at the beam serve's shape: B=64 clips, G = 2 stacks x 4 heads x
    4 beams = 32, the audio (S 256, draw 128) and video (S 128, draw 1024)
    calls of one layer's token step, a fully-masked row; against the
    repeated layout (256 rows of G=8, each clip's memory copied per beam)
    and the library call, with the bound counting the memory once."""
    import torch

    from bmhrl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    Bc, W, G = 64, 4, 32
    scale = 1.0 / math.sqrt(256)
    pair = dict(kernel_ms=0.0, split1_ms=0.0, repeated_ms=0.0, plain_ms=0.0,
                library_ms=0.0, bound_ms=0.0, repeated_bound_ms=0.0)
    calls = {}
    for case, S, draw in (("A", 256, 128), ("V", 128, 1024)):
        qe = torch.randn(Bc, G, draw, generator=g, device=dev) * 0.05
        mem = torch.randn(Bc, S, draw, generator=g, device=dev).to(
            torch.bfloat16)
        lens = torch.randint(1, S + 1, (Bc,), generator=g, device=dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])
        mask[Bc - 1] = False
        mask = mask.to(torch.int32)
        if att.folded_route(mem.dtype, draw) != "tc":
            raise AssertionError("the beam shape left the tensor-core route")
        got = att.folded_attend(qe, mem, mask, scale)
        want = att.folded_attend_plain(qe, mem, mask, scale)
        torch.cuda.synchronize()
        e = check_close(f"folded beam {case}", got, want, 1e-4)
        e = max(e, check_close(f"folded beam {case} masked row = mean(mem)",
                               got[Bc - 1], mem[Bc - 1].float().mean(0)
                               .expand(G, -1), 1e-4))
        K["folded_tc"].err(e)
        # the same queries with the memory repeated per beam
        q_rep = qe.reshape(Bc * W, G // W, draw)
        mem_rep = mem.repeat_interleave(W, 0)
        mask_rep = mask.repeat_interleave(W, 0)
        e_rep = check_close(f"folded beam {case} repeated layout",
                            att.folded_attend(q_rep, mem_rep, mask_rep,
                                              scale).reshape(Bc, G, draw),
                            got, 1e-4)
        ms, _, pms, lms, nbytes, ops = folded_times(qe, mem, mask, scale)
        rms, _, _, _, rbytes, _ = folded_times(q_rep, mem_rep, mask_rep,
                                               scale)
        # folded_split counts clips only (tuned at G = 8): the shared call
        # also at one block per clip and query chunk, as the repeated one
        with mock.patch.object(att, "folded_split", lambda B, S: 1):
            ms_split1 = folded_times(qe, mem, mask, scale)[0]
        bms, by = bound_ms(nbytes, ops, "f32")
        rbms, _ = bound_ms(rbytes, ops, "f32")
        calls[case] = {"S": S, "draw": draw, "split": att.folded_split(Bc, S),
                       "repeated_split": att.folded_split(Bc * W, S),
                       "max_abs_err": e, "repeated_vs_shared_err": e_rep,
                       "kernel_ms": ms, "split1_ms": ms_split1,
                       "repeated_ms": rms, "plain_ms": pms,
                       "library_ms": lms, "bytes": nbytes,
                       "repeated_bytes": rbytes, "bound_ms": bms,
                       "bound_by": by, "repeated_bound_ms": rbms}
        emit({"kernel": "folded_attend_tc", "case": f"beam {case}",
              "clips": Bc, "G": G, **calls[case]})
        for key, v in (("kernel_ms", ms), ("split1_ms", ms_split1),
                       ("repeated_ms", rms),
                       ("plain_ms", pms), ("library_ms", lms),
                       ("bound_ms", bms), ("repeated_bound_ms", rbms)):
            pair[key] += v
        del qe, mem, mask, q_rep, mem_rep, mask_rep
    emit({"kernel": "folded_attend_tc", "case": "beam A + V pair",
          "clips": Bc, "G": G, **pair})
    K["folded_tc"].rec["beam_W4_B64_pair"] = pair


def f32_beam_flagship(K):
    """The flagship in f32 (``--compute_dtype float32``) decoded by beam
    search at W=4 (4 clips, Sv 128, Sa 256, 30 tokens): the W beams fold
    into the 3xTF32 folded route's query groups, G = 2 x 4 x 4 = 32 at
    the 1024-wide video memory, which takes two blocks a clip
    (``folded_simt_chunk``). Its launches are counted; its tokens agree
    with the same decode through the plain versions on >= 99% of
    positions."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops import attention as att
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode

    model = build_model(Config(compute_dtype="float32").agent_kwargs(VOC),
                        "cuda")
    feats = make_feats(4, 128, 256, 1024, 128, "cuda", seed=17)
    masks = make_masks(feats)
    args = (model, feats, masks, 30, BOS, EOS, PAD)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    tok_k, score_k = beam_decode(*args, beam_width=4)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    with plain_kernels():
        tok_p, score_p = beam_decode(*args, beam_width=4)
    agree = float((tok_k == tok_p)[:, 1:].float().mean())
    emit({"phase": "decode_modes", "check": "f32 flagship beam W=4",
          "clips": 4, "G_video": 32,
          "folded_simt_chunk": att.folded_simt_chunk(1024),
          "token_agreement_with_plain": agree, "min_required": 0.99,
          "score_max_abs_diff": float((score_k - score_p).abs().max()),
          "launches": launches, "tokens": tok_k[:, :12].tolist()})
    if agree < 0.99 or not torch.isfinite(score_k).all():
        raise AssertionError(f"f32 beam W=4: agreement {agree}")
    if launches["folded_attend_simt"] <= 0 or launches["folded_attend_tc"]:
        raise AssertionError(f"f32 beam W=4 folded launches: {launches}")
    K["folded_simt"].rec["launches_f32_beam_W4"] = launches[
        "folded_attend_simt"]
    del model


def syncs_per_token(run):
    """Host syncs per generated token of ``run(max_len)``: the device syncs
    that ``torch.cuda.set_sync_debug_mode`` reports in a 30-token run less
    those of a 10-token run, over 20 (the set-up's own syncs cancel)."""
    import torch

    def syncs(max_len):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(max_len)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        where = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                at = f"{os.path.basename(w.filename)}:{w.lineno}"
                where[at] = where.get(at, 0) + 1
        return where

    # the fewer of two runs each: a first call may sync once more (lazy
    # set-up in torch), which is not a per-token sync
    long, short = (min((syncs(n) for _ in range(2)),
                       key=lambda w: sum(w.values())) for n in (30, 10))
    return ((sum(long.values()) - sum(short.values())) / 20,
            {at: n - short.get(at, 0) for at, n in long.items()
             if n != short.get(at, 0)})


def throughput(run, clips, **what):
    """Median clips/s of 3 timed run() calls after one warm-up."""
    import torch

    run()
    samples = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        samples.append(clips / (time.perf_counter() - t))
    emit({"phase": "throughput", **what, "Sv": 128, "Sa": 256,
          "max_len": 30, "clips_per_s": statistics.median(samples),
          "samples": samples})


def phase_decode_modes(K, model):
    """Every decode mode: the small f32 model card vs CPU; the flagship
    (``model``) serving with beam search and with sampling (each a main
    path: launch counts zeroed just before and read just after), the
    sampled, beam and full-buffer checks, K3 at the beam shape, and
    throughput of beam, sampled and full-buffer decode."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD, SPECIALS
    from bmhrl_tpu_torch.models.blocks import Draws
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.serve import CaptionServer
    from bmhrl_tpu_torch.train.decode import beam_decode, decode

    small_modes_card_vs_cpu()
    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]
    options = {"beam": dict(beam_width=4, length_penalty=1.0),
               "sample": dict(sample=True, temperature=0.8, top_p=0.9,
                              sample_seed=0)}
    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        cfg = Config().replace(video_features_path=vdir,
                               audio_features_path=adir)
        captions = {}
        for mode, opts in options.items():
            server = CaptionServer(cfg, model, itos, device="cuda", **opts)
            server.caption(reqs[:3], batch_size=32)  # warm-up
            server = CaptionServer(cfg, model, itos, device="cuda", **opts)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            preds, stats = server.caption(reqs, batch_size=32)
            torch.cuda.synchronize()
            launches = dict(_cuda.LAUNCHES)
            sents = [s["sentence"] for segs in preds["results"].values()
                     for s in segs]
            captions[mode] = sents
            emit({"phase": "decode_modes", "serve": mode, "options": opts,
                  "requests": len(reqs), "answered": len(sents),
                  "empty": sum(1 for s in sents if not s),
                  "stats": stats.summary(), "launches": launches,
                  "example": sents[:3]})
            if len(sents) != len(reqs) or not all(sents):
                raise AssertionError(f"{mode} serve: a request got no "
                                     "sentence")
            for name in ("flash_attention_simt", "folded_attend_simt"):
                if launches.pop(name):
                    raise AssertionError(f"the bf16 {mode} serve took the "
                                         f"3xTF32 route {name}")
            for name, n in launches.items():
                K[name].rec[f"launches_{mode}_serve"] = n
                if n <= 0:
                    raise AssertionError(f"{name} never launched in the "
                                         f"{mode} serve")
        again, _ = CaptionServer(cfg, model, itos, device="cuda",
                                 **options["sample"]).caption(reqs,
                                                              batch_size=32)
    repeat = [s["sentence"] for segs in again["results"].values()
              for s in segs] == captions["sample"]
    emit({"phase": "decode_modes", "check": "sampled serve repeats with "
          "its seed", "identical": repeat,
          "differs_from_beam": sum(a != b for a, b in zip(
              captions["sample"], captions["beam"]))})
    if not repeat:
        raise AssertionError("two sampled serves with one seed differ")

    # the flagship's decode checks at the bench's shapes (B=64 clips,
    # Sv=128, Sa=256, 30 tokens)
    feats = make_feats(64, 128, 256, 1024, 128, "cuda", seed=13)
    masks = make_masks(feats)
    args = (model, feats, masks, 30, BOS)
    greedy, _ = decode(*args, -1, PAD)
    top1, _ = decode(*args, -1, PAD, greedy=False, draws=Draws(1, "cuda"),
                     top_k=1)
    beam1, _ = beam_decode(*args, -1, PAD, beam_width=1)
    beam1_agree = int((beam1 == greedy)[:, 1:].sum())
    beam4, scores = beam_decode(*args, EOS, PAD, beam_width=4)
    # the step at the beam's own row layout is the gate; the greedy
    # layout's GEMMs of another shape round bf16 otherwise, which the
    # report shows beside it
    gap = score_gap(model, feats, masks, beam4, scores, EOS, 4)
    gap_greedy_layout = score_gap(model, feats, masks, beam4, scores, EOS, 1)
    fast, _ = decode(*args, -1, PAD)
    forced, launches = full_buffer_forced(model, feats, masks, fast)
    per_token = launches["flash_attention_tc"] / 30
    checks = {"sampled_top_k_1_eq_greedy": bool(torch.equal(top1, greedy)),
              "beam1_tokens_equal_greedy": beam1_agree,
              "beam1_tokens": greedy[:, 1:].numel(),
              "beam4_score_max_abs_gap": gap, "score_tol": 2e-2,
              "beam4_score_gap_greedy_layout": gap_greedy_layout,
              "full_buffer_forced_agreement": forced, "min_required": 0.95,
              "full_buffer_flash_tc_per_token": per_token,
              "full_buffer_step_launches": launches}
    emit({"phase": "decode_modes", "check": "flagship", "B": 64,
          "dtype": "bf16", **checks})
    if not checks["sampled_top_k_1_eq_greedy"]:
        raise AssertionError("top_k=1 sampling differs from greedy")
    if beam1_agree < 0.99 * greedy[:, 1:].numel():
        raise AssertionError(f"beam W=1 agrees with greedy on only "
                             f"{beam1_agree} tokens")
    if not gap <= 2e-2:
        raise AssertionError(f"beam scores off the summed log-probs by "
                             f"{gap}")
    if forced < 0.95 or per_token != 8:
        raise AssertionError(f"full-buffer step: agreement {forced}, "
                             f"{per_token} flash launches per token")
    K["flash_tc"].rec["full_buffer_per_token"] = per_token
    # each loop syncs the host once per token (its done.all()); no gather,
    # filter or draw may add one
    f8 = make_feats(8, 128, 256, 1024, 128, "cuda", seed=8)
    m8 = make_masks(f8)
    syncs = {
        "greedy": syncs_per_token(lambda n: decode(
            model, f8, m8, n, BOS, -1, PAD)),
        "sampled": syncs_per_token(lambda n: decode(
            model, f8, m8, n, BOS, -1, PAD, greedy=False,
            draws=Draws(2, "cuda"), top_k=5, top_p=0.9)),
        "beam": syncs_per_token(lambda n: beam_decode(
            model, f8, m8, n, BOS, -1, PAD, beam_width=4)),
        "full_buffer_explore": syncs_per_token(lambda n: decode(
            model, f8, m8, n, BOS, -1, PAD, exploration=True,
            draws=Draws(3, "cuda"))),
        "full_buffer_beam": syncs_per_token(lambda n: beam_decode(
            model, f8, m8, n, BOS, -1, PAD, beam_width=4, use_fast=False))}
    emit({"phase": "decode_modes", "check": "host syncs per token",
          "B": 8, "per_token": {k: v[0] for k, v in syncs.items()},
          "extra_syncs_of_20_tokens_by_line": {k: v[1]
                                               for k, v in syncs.items()}})
    if any(v[0] != 1 for v in syncs.values()):
        raise AssertionError(f"host syncs per token: {syncs}")
    del feats, masks, f8, m8

    folded_beam_shape(K)
    f32_beam_flagship(K)

    # throughput at the bench's shapes, 30 tokens, no early stop
    f64 = make_feats(64, 128, 256, 1024, 128, "cuda", seed=64)
    m64 = make_masks(f64)
    throughput(lambda: beam_decode(model, f64, m64, 30, BOS, -1, PAD,
                                   beam_width=4), 64, mode="beam W=4",
               B=64)
    del f64, m64
    f256 = make_feats(256, 128, 256, 1024, 128, "cuda", seed=256)
    m256 = make_masks(f256)
    draws = Draws(0, "cuda")
    throughput(lambda: decode(model, f256, m256, 30, BOS, -1, PAD,
                              greedy=False, draws=draws, temperature=0.8,
                              top_p=0.9), 256, mode="sampled", B=256)
    del f256, m256
    f32 = make_feats(32, 128, 256, 1024, 128, "cuda", seed=32)
    m32 = make_masks(f32)
    throughput(lambda: decode(model, f32, m32, 30, BOS, -1, PAD,
                              use_fast=False), 32,
               mode="full-buffer greedy", B=32)


UNI_SMALL = dict(voc_size=40, d_m1=128, d_ff_m1=64, d_model=256,
                 d_model_caps=32, att_heads=2, att_layers=2, d_goal=16)


def write_train_tsv(path, n_words):
    """A train meta TSV whose captions hold ``n_words`` distinct words, ten
    to a caption: the CLIs build a vocabulary of n_words + 4 entries."""
    words = [f"w{i}" for i in range(n_words)]
    with open(path, "w") as f:
        f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
        for j in range(0, n_words, 10):
            f.write(f"t{j}\t{' '.join(words[j:j + 10])}\t0.0\t5.0\t10.0\t"
                    f"train\t{j}\n")


def run_cli(main, argv):
    """``main(argv)`` with its printed lines captured, its launches counted
    (zeroed just before, read just after): (result, lines, launches)."""
    import io

    import torch

    from bmhrl_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = main(argv)
    torch.cuda.synchronize()
    return result, out.getvalue().splitlines(), dict(_cuda.LAUNCHES)


def check_serve_launches(what, launches):
    """Every kernel of the bf16 serving path launched, no 3xTF32 route."""
    bad = {n: v for n, v in launches.items()
           if (v <= 0) != n.endswith("_simt")}
    if bad:
        raise AssertionError(f"{what} launches: {launches}")


def f32_cli_serve(K, main, argv, root):
    """The f32 flagship (``--compute_dtype float32``) through the serving
    CLI on the 64 requests, greedy at B=32: a main path of the 3xTF32
    routes (launches zeroed just before and read just after: flash and
    folded attention on their ``simt`` routes and both cells, no
    tensor-core route), its words against the same CLI run with the plain
    versions (``plain_kernels``) on >= 99% of positions, its clips/s beside
    the bf16 CLI serve run just before it (the same weights and requests).
    """
    words, stats, launches = {}, {}, {}
    for how, dtype in (("bf16", "bfloat16"), ("kernels", "float32"),
                       ("plain", "float32")):
        out = os.path.join(root, f"sub_{how}.json")
        with plain_kernels() if how == "plain" else contextlib.nullcontext():
            st, _, launches[how] = run_cli(main, argv + [
                "--out", out, "--compute_dtype", dtype])
        stats[how] = st.summary()
        with open(out) as f:
            words[how] = [s["sentence"].split()
                          for _, segs in sorted(json.load(f)["results"]
                                                .items()) for s in segs]
    same = total = 0
    for a, b in zip(words["kernels"], words["plain"]):
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
    agree = same / max(total, 1)
    got = launches["kernels"]
    emit({"phase": "entry_points", "cli": "serve_captions --compute_dtype "
          "float32", "answered": len(words["kernels"]),
          "word_agreement_with_plain": agree, "min_required": 0.99,
          "positions": total, "stats": stats["kernels"],
          "plain_stats": stats["plain"], "launches": got,
          "clips_per_sec_f32": stats["kernels"]["clips_per_sec"],
          "clips_per_sec_bf16_same_call": stats["bf16"]["clips_per_sec"],
          "example": [" ".join(w) for w in words["kernels"][:3]]})
    if len(words["kernels"]) != 64 or not all(words["kernels"]):
        raise AssertionError("the f32 CLI serve left a request unanswered")
    if (got["flash_attention_tc"] or got["folded_attend_tc"]
            or min(got["flash_attention_simt"], got["folded_attend_simt"],
                   got["lstm_cell"], got["gru_cell"]) <= 0):
        raise AssertionError(f"f32 CLI serve launches: {got}")
    if agree < 0.99:
        raise AssertionError(f"f32 CLI serve agrees with plain on {agree}")
    for name, n in got.items():
        K[name].rec["launches_cli_f32_serve"] = n


def small_unimodal_card_vs_cpu():
    """Small f32 AHRL and VHRL models decoded on the card (kernels) and on
    the CPU (plain versions), the same draws fed to both: greedy, sampled
    (temperature 0.8, top_k 5, top_p 0.9), beam W=2 and the full-buffer
    greedy decode. Identical tokens, probabilities and scores within 1e-4;
    the card run launches the 3xTF32 flash and folded routes."""
    import torch

    from bmhrl_tpu_torch.models.unimodal import UnimodalAgent
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode
    from bmhrl_tpu_torch.weights import (load_jax_params,
                                         random_jax_layout_params)

    HostDraws = host_draws_class()
    for modality in ("audio", "video"):
        dims = dict(UNI_SMALL, modality=modality)
        tree = random_jax_layout_params(dims, seed=3)
        out = {}
        for device in ("cuda", "cpu"):
            model = load_jax_params(UnimodalAgent(
                **dims, dtype=torch.float32, device=device), tree).eval()
            feats = make_feats(8, 128, 160, 128, 128, device, seed=3)
            feats["audio"][2, 90:] = 0.0     # ragged audio
            feats["rgb"][5] = 0.0            # a zero-feature video row
            feats["audio"][6] = 0.0          # a zero-feature audio row
            args = (model, feats, make_masks(feats), 12, 2, 3, 1)
            _cuda.reset_launches()
            runs = {"fast_greedy": decode(*args),
                    "sampled": decode(*args, greedy=False,
                                      draws=HostDraws(5, device),
                                      temperature=0.8, top_k=5, top_p=0.9),
                    "beam_W2": beam_decode(*args, beam_width=2),
                    "full_greedy": decode(*args, use_fast=False)}
            out[device] = {k: (t.cpu(), p.cpu()) for k, (t, p) in runs.items()}
            if device == "cuda":
                launches = dict(_cuda.LAUNCHES)
        res = {k: {"tokens_identical": bool(torch.equal(t, out["cpu"][k][0])),
                   "max_abs_err": float((p - out["cpu"][k][1]).abs().max())}
               for k, (t, p) in out["cuda"].items()}
        emit({"phase": "entry_points", "check": "small_unimodal_card_vs_cpu",
              "modality": modality, "dtype": "f32", "results": res,
              "tol": 1e-4, "launches": launches})
        bad = [k for k, v in res.items() if not v["tokens_identical"]
               or not v["max_abs_err"] <= 1e-4]
        if bad or not (launches["flash_attention_simt"] > 0
                       and launches["folded_attend_simt"] > 0):
            raise AssertionError(f"unimodal {modality}, card vs CPU: {bad}, "
                                 f"launches {launches}")


def unimodal_warmstart(K, cfg):
    """The AHRL flagship (d_model 1024, 4 heads, 2 layers, bf16, random
    weights from seed 0) trained by ``StepFactory``: three warmstart steps
    on one B=16 batch (launches counted; the loss finite and falling), then
    ms/step (median of 5 after 2 warm-up steps)."""
    import torch

    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.models.unimodal import AudioAgent
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.steps import StepFactory
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = AudioAgent.build(cfg, VOC, "cuda")
    load_jax_params(model, random_module_params(model, 0))
    nets = [cls(cfg.d_model_caps, device="cuda") for cls in (
        BMWorkerValueFunction, BMManagerValueFunction)]
    for i, net in enumerate(nets):
        load_jax_params(net, random_module_params(net, 1 + i))
    sf = StepFactory(cfg, model, *nets, emb_trainable=True)
    state = sf.init_state()
    batch = make_train_batch(16, seed=1)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses = []
    for i in range(3):
        state, m, _ = sf.warmstart_step(state, batch, i,
                                        cfg.rl_cap_warmstart_lr)
        losses.append(m["loss"].item())
    launches = dict(_cuda.LAUNCHES)

    def ws():
        nonlocal state
        state, _, _ = sf.warmstart_step(state, batch, 7,
                                        cfg.rl_cap_warmstart_lr)

    ms, samples = step_ms(ws, n=5, warmup=2)
    emit({"phase": "entry_points", "check": "AHRL warmstart", "B": 16,
          "Sa": 256, "losses": losses, "launches": launches,
          "ms_per_step": ms, "samples": samples})
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"AHRL warmstart loss did not fall: {losses}")
    if (launches["flash_attention_tc"] <= 0 or launches["lstm_cell"] <= 0
            or launches["gru_cell"] <= 0):
        raise AssertionError(f"AHRL warmstart launches: {launches}")
    for name, n in launches.items():
        K[name].rec["launches_ahrl_train"] = n


def phase_entry_points(K, model):
    """The serving entry points at the flagship's width: the port's
    ``serve_captions`` CLI from a reference ``.pt`` (greedy and beam W=4)
    against a CaptionServer given the same weights, ``single_video`` against
    the server on the same clip, the AHRL and VHRL CLI serves, the small f32
    unimodal decodes card vs CPU, unimodal and bimodal greedy clips/s and
    an AHRL warmstart step. ``model``: the serve phase's flagship (seed 0
    weights, loaded directly)."""
    import torch

    from bmhrl_tpu_torch.cli import serve_captions, single_video
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, PAD, build_vocab_from_tsv
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest
    from bmhrl_tpu_torch.train.decode import decode
    from bmhrl_tpu_torch.utils.checkpoint import export_torch_bmhrl
    from bmhrl_tpu_torch.weights import random_jax_layout_params

    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        tsv = os.path.join(root, "train.csv")
        write_train_tsv(tsv, VOC - 4)
        vocab = build_vocab_from_tsv(tsv)
        if len(vocab) != VOC:
            raise AssertionError(f"vocabulary of {len(vocab)} != {VOC}")
        pt = os.path.join(root, "bm_hrl_agent.pt")
        t0 = time.perf_counter()
        export_torch_bmhrl(random_jax_layout_params(cfg.agent_kwargs(VOC), 0),
                           pt)
        export_s = time.perf_counter() - t0
        props = os.path.join(root, "proposals.json")
        with open(props, "w") as f:
            json.dump({r.video_id: {"duration": r.duration,
                                    "timestamps": [[r.start, r.end]]}
                       for r in reqs}, f)
        base = ["--proposals", props, "--video_features_path", vdir,
                "--audio_features_path", adir, "--train_meta_path", tsv,
                "--batch_size", "32", "--device", "cuda"]
        cfg = cfg.replace(video_features_path=vdir, audio_features_path=adir)

        # the flagship CLI from the .pt vs the server with the weights
        # loaded directly: the same submissions
        for mode, extra in (("greedy", []), ("beam W=4",
                                             ["--beam_width", "4"])):
            out = os.path.join(root, f"sub_{len(extra)}.json")
            t0 = time.perf_counter()
            stats, lines, launches = run_cli(serve_captions.main, base + [
                "--torch_checkpoint", pt, "--out", out] + extra)
            cli_s = time.perf_counter() - t0
            with open(out) as f:
                got = json.load(f)
            want, _ = CaptionServer(
                cfg, model, vocab.itos, device="cuda",
                beam_width=4 if extra else 1).caption(reqs, batch_size=32)
            sents = [s["sentence"] for segs in got["results"].values()
                     for s in segs]
            emit({"phase": "entry_points", "cli": "serve_captions",
                  "mode": mode, "weights": ".pt (export_torch_bmhrl)",
                  "pt_export_s": export_s, "cli_s": cli_s,
                  "stats": stats.summary(),
                  "answered": len(sents), "equal_to_direct_server":
                  got == want, "printed": lines, "launches": launches,
                  "example": sents[:3]})
            if len(sents) != len(reqs) or not all(sents) or got != want:
                raise AssertionError(f"serve_captions {mode}: answered "
                                     f"{len(sents)}, equal {got == want}")
            check_serve_launches(f"serve_captions {mode}", launches)
            key = "launches_cli_serve" if not extra else "launches_cli_beam"
            for name, n in launches.items():
                K[name].rec[key] = n

        f32_cli_serve(K, serve_captions.main, base + [
            "--torch_checkpoint", pt], root)

        # single_video on a clip whose lengths are its buckets' (128, 256):
        # the server runs the same shapes at B=1
        cdir = os.path.join(root, "clip")
        os.makedirs(cdir)
        rng = np.random.RandomState(9)
        for name, shape in (("c_rgb", (128, 1024)), ("c_flow", (128, 1024)),
                            ("c", (256, 128))):
            np.save(os.path.join(cdir, f"{name}.npy"),
                    rng.rand(*shape).astype(np.float32))
        sentence, lines, launches = run_cli(single_video.main, [
            "--rgb", os.path.join(cdir, "c_rgb.npy"), "--flow",
            os.path.join(cdir, "c_flow.npy"), "--audio",
            os.path.join(cdir, "c.npy"), "--train_meta_path", tsv,
            "--torch_checkpoint", pt, "--device", "cuda"])
        one, _ = CaptionServer(cfg, model, vocab.itos, device="cuda").caption(
            [ClipRequest("c", 0.0, 10.0, 10.0, cdir, cdir)], batch_size=1)
        want = one["results"]["c"][0]["sentence"]
        emit({"phase": "entry_points", "cli": "single_video",
              "sentence": sentence, "server_sentence": want,
              "printed": lines, "launches": launches})
        if not sentence or sentence != want:
            raise AssertionError(f"single_video {sentence!r} != server "
                                 f"{want!r}")

        # the unimodal family through the CLI, greedy, flagship width
        # (random weights from seed 0)
        for mode in ("AHRL", "VHRL"):
            out = os.path.join(root, f"sub_{mode}.json")
            stats, lines, launches = run_cli(serve_captions.main, base + [
                "--mode", mode, "--out", out])
            with open(out) as f:
                sents = [s["sentence"] for segs in json.load(f)[
                    "results"].values() for s in segs]
            emit({"phase": "entry_points", "cli": "serve_captions",
                  "mode": mode, "answered": len(sents),
                  "stats": stats.summary(), "launches": launches,
                  "example": sents[:3]})
            if len(sents) != len(reqs) or not all(sents):
                raise AssertionError(f"{mode} serve: a request got no "
                                     "sentence")
            check_serve_launches(f"{mode} serve", launches)
            for name, n in launches.items():
                K[name].rec[f"launches_{mode.lower()}_serve"] = n

    small_unimodal_card_vs_cpu()

    # greedy clips/s at B=256 (Sv 128, Sa 256, 30 tokens, no early stop):
    # the bimodal flagship beside AHRL and VHRL, in this call
    f256 = make_feats(256, 128, 256, 1024, 128, "cuda", seed=256)
    m256 = make_masks(f256)
    throughput(lambda: decode(model, f256, m256, 30, BOS, -1, PAD), 256,
               mode="greedy BMHRL", B=256)
    for mode in ("AHRL", "VHRL"):
        uni = serve_captions.load_captioner(Config(mode=mode), VOC, None,
                                            "cuda")
        throughput(lambda: decode(uni, f256, m256, 30, BOS, -1, PAD), 256,
                   mode=f"greedy {mode}", B=256)
        del uni
    del f256, m256
    torch.cuda.empty_cache()
    unimodal_warmstart(K, Config(mode="AHRL"))


def graphed_vs_eager(model, feats, masks, max_len, graphs, what,
                     captures_wanted=1):
    """One greedy decode replayed from a CUDA graph (``graphs``) against
    the eager loops on the same inputs: the old host loop
    (``_fast_loop``) and the graph's body called once a token; tokens and
    probabilities bit-equal, ``captures_wanted`` captures (1 for new
    shapes, 0 where ``graphs`` keeps a graph of them), one replay a token
    step. Times each decode on the host clock, synchronised."""
    import torch

    from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.decode import _fast_loop, decode

    B = feats["rgb"].shape[0]

    def old_loop():
        Va, Av = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                              masks)
        return _fast_loop(*model.fast_setup(Va, Av, masks, B, max_len + 1),
                          B, max_len, BOS, EOS, PAD, True, None,
                          (1.0, 0, 0.0))

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        (want_t, want_p), old_s = timed(old_loop)
        _cuda.reset_launches()
        (body_t, body_p), body_s = timed(lambda: decode(
            model, feats, masks, max_len, BOS, EOS, PAD))
        eager = dict(_cuda.LAUNCHES)
        # a first capture runs one token eagerly before it
        warm = graphs.stream is None
        before = (graphs.captures, graphs.replays)
        _cuda.reset_launches()
        (got_t, got_p), graph_s = timed(lambda: decode(
            model, feats, masks, max_len, BOS, EOS, PAD, graphs=graphs))
        graphed = dict(_cuda.LAUNCHES)
    captures = graphs.captures - before[0]
    replays = graphs.replays - before[1]
    eos = want_t[:, 1:] == EOS
    steps = int(torch.where(eos.any(1), eos.int().argmax(1) + 1,
                            max_len).max())
    rec = {"phase": "graph", "what": what, "B": B,
           "Sv": feats["rgb"].shape[1], "Sa": feats["audio"].shape[1],
           "token_steps": steps, "captures": captures, "replays": replays,
           "tokens_equal": bool(torch.equal(got_t, want_t)),
           "probs_equal": bool(torch.equal(got_p, want_p)),
           "body_tokens_equal": bool(torch.equal(body_t, want_t)),
           "body_probs_equal": bool(torch.equal(body_p, want_p)),
           "decode_s": {"old_loop": old_s, "body_eager": body_s,
                        "graphed": graph_s},
           "launches": {"body_eager": eager, "graphed": graphed}}
    emit(rec)
    if not (rec["tokens_equal"] and rec["probs_equal"]
            and rec["body_tokens_equal"] and rec["body_probs_equal"]):
        raise AssertionError(f"graphed greedy decode differs: {rec}")
    if captures != captures_wanted or replays != steps:
        raise AssertionError(f"{captures} captures, {replays} replays for "
                             f"{steps} token steps")
    # the replays count the launches of the kernels they run
    if (not eager["folded_attend_tc"]
            or any(n % steps or graphed[k] != n // steps * (steps + warm)
                   for k, n in eager.items())):
        raise AssertionError(f"launches of {steps} eager tokens {eager}, "
                             f"graphed (warm-up token: {warm}) {graphed}")
    return rec


def replayed_rooflines(model, graphs, feats, masks, max_len, tokens=10):
    """The roofline shares of ``bmhrl::folded_attend`` and of the critic's
    cells (``bmhrl::lstm_cell_packed`` and ``gru_cell_packed``) in CUDA
    graph replays, read as the benchmark reads them from eager calls
    (``benchmark.roofline``'s least time of every call over the device
    time under it). ``tokens`` eager greedy tokens under the profiler tie
    each device operation to the ``bmhrl::`` op that launched it; then
    ``tokens`` replays of the graph of the same shapes, from the same
    start, run the same operations in the same order (checked by name
    where an op launched them), and each replayed operation takes the op
    of the eager operation at its place in the token. Returns and emits
    both shares, eager and replayed, with the device milliseconds a
    token."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import roofline
    from bmhrl_tpu_torch.data.vocab import BOS, PAD
    from bmhrl_tpu_torch.train.decode import greedy_state, greedy_token

    cost = {"bmhrl::folded_attend": roofline.folded_attend_s,
            "bmhrl::lstm_cell_packed": roofline.lstm_cell_s,
            "bmhrl::gru_cell_packed": roofline.gru_cell_s}
    group = {"bmhrl::folded_attend": "folded_attend",
             "bmhrl::lstm_cell_packed": "critic_cells",
             "bmhrl::gru_cell_packed": "critic_cells"}
    B = feats["rgb"].shape[0]
    cpu = torch.autograd.DeviceType.CPU

    def device_ops(prof):
        """The device operations in order of start: (name, ns, op) with
        op (name, shapes) of the ``bmhrl::`` call that launched it."""
        cpu_at, calls, device = {}, {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cpu:
                annotation = (e.is_user_annotation()
                              if hasattr(e, "is_user_annotation") else
                              "annotation" in e.activity_type())
                if not annotation:
                    device.append((e.start_ns(), e.end_ns(), e.name(),
                                   e.linked_correlation_id()))
                continue
            tid = e.start_thread_id()
            cpu_at[e.correlation_id()] = (tid, e.start_ns())
            if e.name() in cost:
                calls.setdefault(tid, []).append(
                    (e.start_ns(), e.end_ns(), e.name(), e.shapes()))
        for c in calls.values():
            c.sort()
        out = []
        for s, t, name, corr in sorted(device):
            op, at = None, cpu_at.get(corr)
            if at is not None and at[0] in calls:
                c = calls[at[0]]
                i = bisect.bisect_right([x[0] for x in c], at[1]) - 1
                if i >= 0 and c[i][1] >= at[1]:
                    op = (c[i][2], c[i][3])
            out.append((name, t - s, op))
        return out

    def profiled(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(tokens):
                run()
            torch.cuda.synchronize()
        return device_ops(prof)

    with torch.no_grad():
        Va, Av = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                              masks)

        def fresh():
            return greedy_state(*model.fast_state(Va, Av, masks, B,
                                                  max_len + 1),
                                B, max_len, BOS, PAD)

        def token_on(state):
            return lambda: greedy_token(state, model.fast_step, -1, PAD)

        eager = profiled(token_on(fresh()))
        _, replay = graphs.bind(fresh(), token_on, "rooflines")
        replayed = profiled(replay)
    k = len(eager) // tokens
    if len(eager) != k * tokens or len(replayed) != len(eager):
        raise AssertionError(f"{len(eager)} eager and {len(replayed)} "
                             f"replayed device operations in {tokens} "
                             "tokens")
    places = [op for _, _, op in eager[:k]]
    unlike = [i for i, (a, b) in enumerate(zip(eager, replayed))
              if a[0] != b[0]]
    if any(places[i % k] for i in unlike) or any(
            (op is None) != (places[i % k] is None)
            or (op and op[0] != places[i % k][0])
            for i, (_, _, op) in enumerate(eager)):
        raise AssertionError("the replayed token's operations are not the "
                             "eager token's where an op launched them")
    rec = {"phase": "graph", "what": "rooflines", "B": B,
           "Sv": feats["rgb"].shape[1], "Sa": feats["audio"].shape[1],
           "tokens": tokens, "device_ops_a_token": k,
           "names_unlike_elsewhere": len(unlike)}
    for g in sorted(set(group.values())):
        least = sum(cost[op[0]](op[1]) for _, _, op in eager
                    if op and group[op[0]] == g)
        for how, ops in (("eager", eager), ("replayed", replayed)):
            ns = sum(d for i, (_, d, _) in enumerate(ops)
                     if places[i % k] and group[places[i % k][0]] == g)
            rec[f"{g}_roofline_{how}"] = 100.0 * least / (ns / 1e9)
            rec[f"{g}_device_ms_a_token_{how}"] = ns / 1e6 / tokens
    for how, ops in (("eager", eager), ("replayed", replayed)):
        rec[f"device_ms_a_token_{how}"] = sum(d for _, d, _ in ops) / 1e6 \
            / tokens
    emit(rec)
    return rec


def phase_graph(K):
    """The greedy token as one CUDA graph replay a token: the flagship at
    B=256 in the (32, 64) bucket, at a power-of-2 tail (B=32) and at B=256
    again on other clips (the kept graph), through one ``TokenGraphs`` (its
    first capture warms the capture stream), and the DETR at B=256
    through its own; each bit-equal to the eager loops
    (``graphed_vs_eager``). Then, on the host clock, a capture, a kept
    graph taking a new start, a replayed token and an eager token; and the
    rooflines of ``folded_attend`` and the cells in replays
    (``replayed_rooflines``)."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, PAD
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import (TokenGraphs, decode,
                                              greedy_state, greedy_token)

    cfg = Config()
    model = build_model(cfg.agent_kwargs(VOC), "cuda")
    graphs = TokenGraphs()
    for B, seed, new in ((256, 256, 1), (32, 32, 1), (256, 11, 0)):
        feats = make_feats(B, 32, 64, 1024, 128, "cuda", seed=seed)
        graphed_vs_eager(model, feats, make_masks(feats), cfg.max_len,
                         graphs, f"flagship B={B} seed {seed}", new)

    # at B=256, (32, 64): a capture, a kept graph taking a new start, a
    # replayed token, an eager token, and the graphed decode of 30 tokens
    feats = make_feats(256, 32, 64, 1024, 128, "cuda", seed=3)
    masks = make_masks(feats)
    with torch.no_grad():
        Va, Av = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                              masks)

        def fresh():
            return greedy_state(*model.fast_state(Va, Av, masks, 256,
                                                  cfg.max_len + 1),
                                256, cfg.max_len, BOS, PAD)

        def token_on(state):
            return lambda: greedy_token(state, model.fast_step, -1, PAD)

        def host_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), out

        caps, binds, replay, eager = [], [], [], []
        for i in range(5):
            caps.append(host_ms(lambda: graphs.bind(fresh(), token_on,
                                                    ("timing", i)))[0])
            start = fresh()
            ms, (_, run) = host_ms(lambda: graphs.bind(start, token_on,
                                                       ("timing", i)))
            binds.append(ms)
            replay += [host_ms(run)[0] for _ in range(10)]
            own = token_on(fresh())
            eager += [host_ms(own)[0] for _ in range(5)]
        loops = [host_ms(lambda: decode(model, feats, masks, cfg.max_len,
                                        BOS, -1, PAD, graphs=graphs))[0]
                 for _ in range(3)]
    emit({"phase": "graph", "B": 256, "Sv": 32, "Sa": 64,
          "capture_ms": caps, "kept_graph_new_start_ms": binds,
          "replayed_token_ms_median": statistics.median(replay),
          "eager_token_ms_median": statistics.median(eager),
          "graphed_decode_30_tokens_ms": loops,
          "captures": graphs.captures, "replays": graphs.replays,
          "kept_graphs_bytes": graphs.nbytes()})
    replayed_rooflines(model, graphs, feats, masks, cfg.max_len)
    del model, graphs
    torch.cuda.empty_cache()

    detr = build_detr(dict(voc_size=VOC), "cuda").eval().requires_grad_(
        False)
    feats = detr_feats(256, 1024, "cuda", seed=256, Sv=32, Sa=64)
    graphed_vs_eager(detr, feats, make_masks(feats), cfg.max_len,
                     TokenGraphs(), "DETR B=256")
    del detr
    torch.cuda.empty_cache()


def device_groups(prof):
    """Device ms and launches of a profile by group: each kernel of csrc/,
    cuBLAS/CUTLASS GEMMs, everything else."""
    import torch

    kernels = ("flash_tc_kernel", "flash_simt_kernel", "folded_tc_kernel",
               "folded_kernel", "lstm_cell_kernel", "gru_cell_kernel")
    groups = dict.fromkeys(kernels + ("gemm", "other"), 0.0)
    counts = dict.fromkeys(groups, 0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        name = evt.key.lower()
        key = next((g for g in kernels if g in name), None)
        if key is None:
            key = "gemm" if ("gemm" in name or "sm90" in name
                             or "cutlass" in name) else "other"
        groups[key] += us / 1e3
        counts[key] += evt.count
    return groups, counts


def profile_decode(model, B=256, beam_width=0):
    """Device time of one greedy decode (B=256, Sv=128, Sa=256, 30 tokens;
    with ``beam_width``, a beam decode of B clips) by kernel group, and
    the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bmhrl_tpu_torch.data.vocab import BOS, PAD
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode

    feats = make_feats(B, 128, 256, 1024, 128, "cuda", seed=11)
    masks = make_masks(feats)

    def run():
        if beam_width:
            return beam_decode(model, feats, masks, 30, BOS, -1, PAD,
                               beam_width=beam_width)
        return decode(model, feats, masks, 30, BOS, -1, PAD)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, counts = device_groups(prof)
    busy = sum(groups.values())
    # the bf16 decode takes the tensor-core folded route: one launch per
    # branch, layer and token, for all beams of a clip
    folded_per_batch = 2 * model.att_layers * 30
    if busy and (counts["folded_tc_kernel"] != folded_per_batch
                 or counts["folded_kernel"]):
        raise AssertionError(f"folded launches in a decode: {counts}")
    emit({"phase": "profile", "B": B, "beam_width": beam_width or None,
          "Sv": 128, "Sa": 256, "tokens": 30,
          "wall_ms": wall_ms, "device_ms": groups, "device_busy_ms": busy,
          "device_idle_share": (1 - busy / wall_ms) if busy else None,
          "device_launches": sum(counts.values()),
          "device_launches_by_group": counts,
          "note": None if busy else "not measured: no device time traced"})


# --------------------------------------------------------------------------
def make_train_batch(B, Sv=128, Sa=256, Lc=31, voc=VOC, d_v=1024, d_a=128,
                     device="cuda", seed=0):
    """A synthetic training batch shaped as bench.py's: random features,
    captions of <s>, 19 random words, </s> and pads (Lc + 1 ids)."""
    import torch

    rng = np.random.RandomState(seed)
    cap = np.full((B, Lc + 1), 1, np.int64)
    cap[:, 0] = 2
    n = min(19, Lc - 2)
    cap[:, 1:1 + n] = rng.randint(4, voc, (B, n))
    cap[:, 1 + n] = 3
    f = {"rgb": rng.rand(B, Sv, d_v), "flow": rng.rand(B, Sv, d_v),
         "audio": rng.rand(B, Sa, d_a)}
    batch = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in f.items()}
    batch["caption_idx"] = torch.tensor(cap, device=device)
    return batch


def build_trainer(kwargs, device, seed=0):
    """A StepFactory over ``build_model(kwargs, device, seed)`` and two
    value functions with random weights from the next seeds, and its
    initial state."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.train.steps import StepFactory
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = build_model(kwargs, device, seed)
    nets = []
    for i, cls in enumerate((BMWorkerValueFunction, BMManagerValueFunction)):
        net = cls(kwargs["d_model_caps"], device=device)
        nets.append(load_jax_params(net, random_module_params(net,
                                                              seed + 1 + i)))
    sf = StepFactory(Config(), model, *nets, emb_trainable=True)
    torch.cuda.synchronize()
    return sf, sf.init_state()


def flash_grad_checks(K):
    """The autograd Function (kernel forward, recompute backward) against
    autograd through the plain version at the training shapes: bf16 at
    B=16, 4 heads of d=256 (tensor-core route; Sq 31 against Sk 128 and
    256, Sq = Sk 128, 256, 300, 800) and f32 at the reference decode's
    B=8, 2 heads of d=128 (3xTF32 route). As in the model, q, k and v
    are column views of one merged projection where Sq = Sk (self
    attention), and k and v of one merged K/V projection otherwise; the
    gradients compared are those of the merged leaves. Row 1 is fully
    masked. The forwards must agree within the serving check's absolute
    tolerance, the masked row equal mean(V). The JAX recompute gives that
    row's q and k a gradient (uniform p, ds = p (dp - mean dp)) where
    autograd through the -1e9 fill gives zero, so its dq and dk are left
    out of the comparison; its dv (mean of g over the row's queries, as
    the forward's mean(V)) is in it."""
    import torch

    from bmhrl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    rec = {"tc": K["flash_tc"], "simt": K["flash_simt"]}
    cases = [(torch.bfloat16, 16, 4, 256, sq, sk) for sq, sk in (
        (31, 128), (31, 256), (128, 128), (256, 256), (300, 300),
        (800, 800))]
    cases += [(torch.float32, 8, 2, 128, sq, sk) for sq, sk in (
        (31, 128), (31, 160), (128, 128), (160, 160), (128, 160))]
    for dtype, B, H, d, Sq, Sk in cases:
        HD = H * d

        def merged(S, scales):
            x = torch.randn(B, S, len(scales) * HD, generator=g, device=dev)
            col = torch.tensor(scales, device=dev).repeat_interleave(HD)
            return (x * col).to(dtype)

        self_att = Sq == Sk
        if self_att:  # one merged Q/K/V projection
            leaves = [merged(Sq, (0.3, 1.0, 1.0))]
        else:  # q alone, one merged K/V projection
            leaves = [merged(Sq, (0.3,)), merged(Sk, (1.0, 1.0))]

        def qkv(ts):
            if self_att:
                return ts[0].split(HD, dim=-1)
            return (ts[0], *ts[1].split(HD, dim=-1))

        go = merged(Sq, (1.0,))
        lens = torch.randint(Sk // 2, Sk + 1, (B,), generator=g, device=dev)
        mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
        mask[1] = False
        route = att.flash_route(dtype, d)
        outs, grads, fns = [], [], []
        for fn in (att.flash_attention_bsd, att.flash_attention_bsd_plain):
            ins = [t.clone().requires_grad_() for t in leaves]
            out = fn(*qkv(ins), mask, H)
            fns.append(type(out.grad_fn).__name__)
            outs.append(out.detach())
            grads.append(dict(zip("qkv", qkv(
                torch.autograd.grad(out, ins, go)))))
        if fns[0] != "FlashAttentionBSDBackward":
            raise AssertionError(f"flash attention under autograd took "
                                 f"{fns[0]}, not the Function")
        tag = f"{route} {Sq}x{Sk}"
        fwd_err = check_close(f"flash train forward {tag}", *outs,
                              TOL[dtype])
        mean_v = qkv(leaves)[2][1].float().mean(0).expand_as(outs[0][1])
        fwd_err = max(fwd_err, check_close(
            f"flash train forward {tag} masked row = mean(V)", outs[0][1],
            mean_v, TOL[dtype]))
        rec[route].err(fwd_err)
        r = rec[route].rec
        r["train_fwd_max_abs_err"] = max(r.get("train_fwd_max_abs_err", 0.0),
                                         fwd_err)
        keep = torch.ones(B, dtype=torch.bool, device=dev)
        keep[1] = False
        errs = {}
        for name in "qkv":
            a, b = grads[0][name], grads[1][name]
            if name != "v":
                a, b = a[keep], b[keep]
            scale = float(b.float().abs().max())
            tol = REL[dtype] * scale
            errs[name] = check_close(f"flash grad d{name} {tag}", a, b,
                                     tol) / scale
        emit({"check": "flash_grad", "route": route, "dtype": str(dtype),
              "B": B, "H": H, "d": d, "Sq": Sq, "Sk": Sk,
              "inputs": "merged QKV views" if self_att
              else "q + merged KV views",
              "fwd_max_abs_err": fwd_err, "fwd_tol": TOL[dtype],
              "rel_err_of_max_abs": errs, "tol": REL[dtype],
              "masked_row_dq_norm": float(grads[0]["q"][1].float().norm())})


def train_card_vs_cpu():
    """A small f32 model (2 heads of d=128: the 3xTF32 flash route)
    trained on the card and on the CPU with the same draws (generators on
    the host): two warmstart steps, one RL rollout + update per phase.
    Losses within 1e-4 relative, every parameter within 1e-5."""
    import torch

    out = {}
    score = torch.from_numpy(np.random.RandomState(5).rand(4, 8)
                             .astype(np.float32))
    for device in ("cuda", "cpu"):
        HostDraws = host_draws_class()
        sf, state = build_trainer(dict(SMALL, dtype=torch.float32), device,
                                  seed=3)
        batch = make_train_batch(4, 128, 160, Lc=8, voc=SMALL["voc_size"],
                                 d_v=128, d_a=128, device=device, seed=3)
        losses = []
        for s in range(2):
            state, m, _ = sf.warmstart_step(state, batch, s, 1e-4,
                                            draws=HostDraws(s, device))
            losses.append(m["loss"].item())
        for tw in (True, False):
            roll = sf.rl_rollout(state, batch, 0, tw,
                                 draws=HostDraws(10 + tw, device))
            state, m = sf.rl_update(state, batch, 0, 1e-4, roll,
                                    score.to(device), tw,
                                    draws=HostDraws(10 + tw, device))
            losses += [m["loss"].item(), m["value_loss"].item()]
        params = {f"{tag}.{n}": p.detach().cpu() for tag, mod in (
            ("cap", sf.model), ("wv", sf.wv_model), ("mv", sf.mv_model))
            for n, p in mod.named_parameters()}
        out[device] = (np.array(losses), params)
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    loss_err = float(np.max(np.abs(lc - lh) / np.abs(lh)))
    param_err = max(float((pc[n] - ph[n]).abs().max()) for n in ph)
    emit({"check": "train_card_vs_cpu", "dims": "small", "dtype": "f32",
          "losses_cuda": lc.tolist(), "losses_cpu": lh.tolist(),
          "loss_rel_err": loss_err, "loss_tol": 1e-4,
          "param_max_abs_err": param_err, "param_tol": 1e-5})
    if not loss_err <= 1e-4 or not param_err <= 1e-5:
        raise AssertionError("training on the card disagrees with the CPU")


def step_ms(fn, n=7, warmup=3):
    """Median wall ms of fn() (each ended by a device sync) over n calls
    after ``warmup`` calls, and the samples."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t) * 1e3)
    return statistics.median(samples), samples


def forward_flops(model, batch):
    """Matmul FLOPs of one deterministic teacher-forced forward, counted by
    ``torch.utils.flop_counter`` over the plain versions of the kernels:
    (all, the frozen critic's share)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from bmhrl_tpu_torch.ops.masking import make_masks

    x_idx = batch["caption_idx"][:, :-1]
    masks = make_masks(batch, x_idx)
    critic = []
    with torch.no_grad(), plain_kernels(), \
            FlopCounterMode(display=False) as counter:
        hooks = [model.critic.register_forward_pre_hook(
                     lambda *a: critic.append(-counter.get_total_flops())),
                 model.critic.register_forward_hook(
                     lambda *a: critic.append(counter.get_total_flops()))]
        try:
            model(batch["rgb"] + batch["flow"], batch["audio"], x_idx, masks)
        finally:
            for h in hooks:
                h.remove()
    return counter.get_total_flops(), sum(critic)


def step_split(sf, state, batch):
    """Device-timeline ms of one warmstart step's forward, backward
    (``steps._grads`` of the captioner) and optimizer update, from CUDA
    events, and of the whole step."""
    import torch

    from bmhrl_tpu_torch.train import steps

    ev = {k: torch.cuda.Event(enable_timing=True) for k in (
        "start", "fwd0", "fwd1", "bwd0", "bwd1", "opt0", "opt1", "end")}
    grads, update = steps._grads, sf.cap_optim.update

    def timed(a, b, fn):
        def run(*args, **kw):
            ev[a].record()
            out = fn(*args, **kw)
            ev[b].record()
            return out
        return run

    hooks = [sf.model.register_forward_pre_hook(
                 lambda *a: ev["fwd0"].record()),
             sf.model.register_forward_hook(lambda *a: ev["fwd1"].record())]
    try:
        with mock.patch.object(steps, "_grads",
                               timed("bwd0", "bwd1", grads)), \
                mock.patch.object(sf.cap_optim, "update",
                                  timed("opt0", "opt1", update)):
            ev["start"].record()
            state, _, _ = sf.warmstart_step(state, batch, 99, 1e-4)
            ev["end"].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return state, {"forward_ms": ev["fwd0"].elapsed_time(ev["fwd1"]),
                   "backward_ms": ev["bwd0"].elapsed_time(ev["bwd1"]),
                   "optimizer_ms": ev["opt0"].elapsed_time(ev["opt1"]),
                   "step_ms": ev["start"].elapsed_time(ev["end"])}


def flash_train_times(K, B=16, Sv=128, Sa=256, Lc=31, layers=2):
    """The flash sites of one warmstart step at B=16 (4 heads of d=256,
    bf16): per forward, each encoder layer's four (Sq, Sk in Sv, Sa) and
    each fusion layer's two (31 caption queries against Sa and Sv) in both
    stacks. Kernel forward and backward recompute as device time of CUDA
    graph replays; the port's forward + backward and
    ``scaled_dot_product_attention``'s forward + backward as eager calls
    (autograd), both ways the same. Sums over one step go on the
    tensor-core flash record."""
    import torch
    import torch.nn.functional as Fn

    from bmhrl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    H, d = 4, 256
    HD = H * d
    sites = [("enc V<-V", Sv, Sv, layers), ("enc A<-A", Sa, Sa, layers),
             ("enc V<-A", Sv, Sa, layers), ("enc A<-V", Sa, Sv, layers),
             ("fus C<-A", Lc, Sa, 2 * layers), ("fus C<-V", Lc, Sv,
                                                2 * layers)]
    total = dict(fwd_ms=0.0, bwd_recompute_ms=0.0, fwd_bwd_eager_ms=0.0,
                 sdpa_fwd_bwd_eager_ms=0.0, plain_fwd_ms=0.0, bound_ms=0.0)
    for site, Sq, Sk, per_step in sites:
        def rnd(S, scale=1.0):
            return (torch.randn(B, S, HD, generator=g, device=dev)
                    * scale).to(torch.bfloat16)
        q, k, v, go = rnd(Sq, 0.3), rnd(Sk), rnd(Sk), rnd(Sq)
        lens = torch.randint(Sk // 2, Sk + 1, (B,), generator=g, device=dev)
        mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
        fwd = time_ms(lambda: att.flash_attention_bsd(q, k, v, mask, H))
        bwd = time_ms(lambda: att.flash_attention_bsd_bwd(q, k, v, mask, go,
                                                          H))
        plain = time_ms(lambda: att.flash_attention_bsd_plain(q, k, v, mask,
                                                              H))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def port_fb():
            out = att.flash_attention_bsd(qg, kg, vg, mask, H)
            return torch.autograd.grad(out, (qg, kg, vg), go)

        qh, kh, vh = (t.view(B, -1, H, d).transpose(1, 2).detach()
                      .requires_grad_() for t in (q, k, v))
        goh = go.view(B, Sq, H, d).transpose(1, 2)
        m4 = mask[:, None, None, :]

        def sdpa_fb():
            out = Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4)
            return torch.autograd.grad(out, (qh, kh, vh), goh)

        fb = eager_ms(port_fb, iters=10)
        lfb = eager_ms(sdpa_fb, iters=10)
        # bound of forward + backward: q, k, v, g, mask read and o, dq, dk,
        # dv written once; 4 (forward) + 8 (backward) B H Sq Sk d
        # operations of bf16 products
        nbytes = (3 * B * Sq * HD + 3 * B * Sk * HD) * 2 + B * Sk * 4
        bms, by = bound_ms(nbytes, 12.0 * B * H * Sq * Sk * d, "bf16")
        emit({"kernel": "flash_attention_tc", "case": f"train {site}",
              "B": B, "Sq": Sq, "Sk": Sk, "per_step": per_step,
              "fwd_ms": fwd, "bwd_recompute_ms": bwd, "plain_fwd_ms": plain,
              "fwd_bwd_eager_ms": fb, "sdpa_fwd_bwd_eager_ms": lfb,
              "fwd_bwd_bound_ms": bms, "bound_by": by})
        for key, val in (("fwd_ms", fwd), ("bwd_recompute_ms", bwd),
                         ("fwd_bwd_eager_ms", fb),
                         ("sdpa_fwd_bwd_eager_ms", lfb),
                         ("plain_fwd_ms", plain), ("bound_ms", bms)):
            total[key] += per_step * val
    emit({"kernel": "flash_attention_tc", "case": "train: sum of one "
          "warmstart step's sites", "B": B, **total})
    K["flash_tc"].rec["train_step_B16"] = total


def phase_train(K):
    """Flash gradients, card vs CPU, then the flagship's training path (its
    main run counted), checks and timings. Returns (StepFactory, state,
    B=16 batch) for the profile phase."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.models.blocks import Draws
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train import losses as L

    flash_grad_checks(K)
    train_card_vs_cpu()
    cfg = Config()
    t0 = time.perf_counter()
    sf, state = build_trainer(cfg.agent_kwargs(VOC), "cuda")
    model = sf.model
    emit({"phase": "train", "model_build_s": time.perf_counter() - t0,
          "params": sum(p.numel() for p in model.parameters())})
    b16 = make_train_batch(16, seed=1)
    Lc = b16["caption_idx"].shape[1] - 1

    # every encoder parameter gets a nonzero gradient through a training
    # forward (the step's own computation, with its draws)
    x_idx = b16["caption_idx"][:, :-1]
    pred = model(b16["rgb"] + b16["flow"], b16["audio"], x_idx,
                 make_masks(b16, x_idx), exploration=True,
                 deterministic=False, draws=Draws(0, "cuda"))[0]
    loss = L.label_smoothing(pred, b16["caption_idx"][:, 1:], cfg.smoothing,
                             1).sum()
    enc = {n: p for n, p in model.named_parameters()
           if n.startswith("bm_enc")}
    gmax = {n: float(gr.abs().max()) for n, gr in zip(
        enc, torch.autograd.grad(loss, list(enc.values())))}
    zero = [n for n, m in gmax.items() if not m > 0]
    emit({"check": "encoder_gradients", "params": len(gmax),
          "zero_or_nonfinite": zero, "min_max_abs": min(gmax.values())})
    if zero:
        raise AssertionError(f"encoder parameters without gradient: {zero}")
    del pred, loss

    # ---- the training path's main run, counted
    groups = sf.groups

    def snapshot(group):
        return {n: p.detach().clone() for n, p in sf.cap_params.items()
                if groups[n] == group}

    def unchanged(snap):
        return all(torch.equal(sf.cap_params[n], p) for n, p in snap.items())

    critic0 = snapshot("frozen")
    zeros = torch.zeros(16, Lc, device="cuda")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses = []
    for i in range(10):
        state, m, aux = sf.warmstart_step(state, b16, i,
                                          cfg.rl_cap_warmstart_lr)
        losses.append(m["loss"])
    state, vm = sf.value_warmstart_step(state, aux["wf"], aux["mf"], zeros,
                                        zeros, aux["token_mask"], aux["seg"])
    moved = {}
    for tw, other in ((True, "manager"), (False, "worker")):
        snap = snapshot(other)
        own = snapshot("worker" if tw else "manager")
        roll = sf.rl_rollout(state, b16, 100 + tw, tw)
        state, rm = sf.rl_update(state, b16, 100 + tw, cfg.rl_cap_lr, roll,
                                 zeros, tw)
        torch.cuda.synchronize()
        if not unchanged(snap):
            raise AssertionError(f"an RL {'worker' if tw else 'manager'} "
                                 f"update changed the {other} group")
        moved["worker" if tw else "manager"] = not unchanged(own)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    losses = [x.item() for x in losses]
    forwards = 10 + 2 * 2  # warmstart steps, then rollout + update twice
    # flash sites of one forward: each encoder layer's 4 attentions and
    # each fusion layer's 2 cross-attentions in both stacks (the caption
    # self-attention and the goal attention take the plain path)
    flash_per_fwd = (4 + 2 * 2) * model.att_layers
    emit({"phase": "train", "main_run": "10 warmstart + value + RL worker "
          "+ RL manager, B=16", "losses": losses,
          "value_losses": [vm["wv_loss"].item(), vm["mv_loss"].item()],
          "rl_loss_last": rm["loss"].item(), "launches": launches,
          "forwards": forwards, "flash_tc_per_forward_expected":
          flash_per_fwd, "own_group_moved": moved})
    if not all(math.isfinite(x) for x in losses) or not \
            losses[-1] < losses[0]:
        raise AssertionError(f"warmstart loss did not fall: {losses}")
    if not unchanged(critic0):
        raise AssertionError("training changed the frozen critic")
    if not all(moved.values()):
        raise AssertionError(f"an RL phase left its own group: {moved}")
    want = {"flash_attention_tc": flash_per_fwd * forwards,
            "lstm_cell": 4 * Lc * forwards, "gru_cell": 2 * Lc * forwards,
            "flash_attention_simt": 0, "folded_attend_tc": 0,
            "folded_attend_simt": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    for name, n in launches.items():
        K[name].rec["launches_train"] = n

    # ---- timings
    out = {}
    b64 = make_train_batch(64, seed=2)
    for B, batch in ((16, b16), (64, b64)):
        def ws():
            nonlocal state
            state, _, _ = sf.warmstart_step(state, batch, 7,
                                            cfg.rl_cap_warmstart_lr)
        out[f"warmstart_B{B}"] = step_ms(ws)
    del b64
    for name, tw in (("rl_worker_B16", True), ("rl_manager_B16", False)):
        def rl():
            nonlocal state
            roll = sf.rl_rollout(state, b16, 7, tw)
            state, _ = sf.rl_update(state, b16, 7, cfg.rl_cap_lr, roll,
                                    zeros, tw)
        out[name] = step_ms(rl)
    # forward matmuls x 3 (forward and backward), but the frozen critic's
    # once: it runs under no_grad and has no backward
    fwd_flops, critic_flops = forward_flops(model, b16)
    flops16 = 3 * (fwd_flops - critic_flops) + critic_flops
    state, split = step_split(sf, state, b16)
    ms16 = out["warmstart_B16"][0]
    emit({"phase": "train", "ms_per_step": {k: v[0] for k, v in out.items()},
          "samples": {k: v[1] for k, v in out.items()},
          "clips_per_s": {k: int(k.split("_B")[1]) * 1e3 / v[0]
                          for k, v in out.items()},
          "warmstart_B16_flops": flops16,
          "forward_flops": fwd_flops, "critic_forward_flops": critic_flops,
          "warmstart_B16_mfu": flops16 / (ms16 / 1e3) / PEAK_OPS["bf16"],
          "warmstart_B16_split": split})
    torch.cuda.empty_cache()
    flash_train_times(K)
    return sf, state, b16


# --------------------------------------------------------------------------
def write_loop_corpus(root, n_words=VOC - 4, clips=32, seed=0):
    """A training corpus at the flagship's vocabulary: train captions of
    ten words cover ``n_words`` distinct words (a vocabulary of n_words + 4
    with the specials); the rows cycle over ``clips`` clips whose features
    (256 video and 512 audio frames, cropped to their first half by the
    rows' spans) give batches of Sv=128 and Sa=256, the bench's shapes; a
    validation split of 32 rows with its reference JSON. Returns the paths
    a Config needs."""
    rng = np.random.RandomState(seed)
    vdir, adir = os.path.join(root, "i3d"), os.path.join(root, "vggish")
    os.makedirs(vdir)
    os.makedirs(adir)
    for c in range(clips):
        for kind in ("rgb", "flow"):
            np.save(os.path.join(vdir, f"c{c}_{kind}.npy"),
                    rng.rand(256, 1024).astype(np.float32))
        np.save(os.path.join(adir, f"c{c}.npy"),
                rng.rand(512, 128).astype(np.float32))
    words = [f"w{i}" for i in range(n_words)]
    header = "video_id\tcaption\tstart\tend\tduration\tphase\tidx\n"
    paths = {"video_features_path": vdir, "audio_features_path": adir,
             "train": os.path.join(root, "train.csv"),
             "val_1": os.path.join(root, "val_1.csv"),
             "ref": os.path.join(root, "val_1_ref.json")}
    with open(paths["train"], "w") as f:
        f.write(header)
        for j in range(0, n_words, 10):
            f.write(f"c{(j // 10) % clips}\t{' '.join(words[j:j + 10])}\t"
                    f"0.0\t5.0\t10.0\ttrain\t{j}\n")
    refs = {}
    with open(paths["val_1"], "w") as f:
        f.write(header)
        for j in range(32):
            cap = " ".join(words[10 * j: 10 * j + 10])
            f.write(f"c{j % clips}\t{cap}\t0.0\t5.0\t10.0\tval_1\t{j}\n")
            refs.setdefault(f"c{j % clips}", {
                "duration": 10.0, "timestamps": [], "sentences": []})
            refs[f"c{j % clips}"]["timestamps"].append([0.0, 5.0])
            refs[f"c{j % clips}"]["sentences"].append(cap)
    with open(paths["ref"], "w") as f:
        json.dump(refs, f)
    return paths


def loop_config(paths, **kw):
    """The flagship's Config (bf16, random weights from seed 0) on a
    corpus of ``write_loop_corpus``: B=16, the METEOR scorer, no pretrained
    critic, no logging unless asked."""
    from bmhrl_tpu_torch.config import Config

    fields = dict(train_meta_path=paths["train"],
                  val_1_meta_path=paths["val_1"],
                  vatex_meta_path=paths["val_1"] + ".absent",
                  msrvtt_meta_path=paths["val_1"] + ".absent",
                  video_features_path=paths["video_features_path"],
                  audio_features_path=paths["audio_features_path"],
                  reference_paths=(paths["ref"],) * 4,
                  rl_critic_path=paths["ref"] + ".absent", B=16,
                  scorer="METEOR", to_log=False, seed=0)
    fields.update(kw)
    return Config(**fields)


LOOP_STEPS = 8  # steps per epoch of the timed loop runs


def loop_records(run, pipeline, data, out):
    """One JSON line per trained epoch of a loop run: ms/step through the
    loop (median), the StepTimer split (mean ms per phase), kernel launches
    per step, the scorer's path and ms per batch."""
    for r in out["epochs"]:
        t = r["timer"]
        emit({"phase": "train_loop", "run": run, "rl_pipeline": pipeline,
              "data": data, "epoch": r["epoch"], "what": r["phase"], "steps": r["steps"],
              "loss": r["loss"], "ms_per_step": t["step"]["p50_ms"],
              "split_mean_ms": {k: v["mean_ms"] for k, v in t.items()},
              "launches_per_step": {k: v / r["steps"]
                                    for k, v in r["launches"].items()},
              "scorer_path": r["scorer_path"],
              "host_score_ms": t["host_score"]["mean_ms"],
              "METEOR": r.get("METEOR")})


def params_and_state(sf, state):
    """Every tensor of a trainer (parameters, Adam moments) and the Adam
    counts, copied to the host."""
    out = {}
    for k, m in (("cap", sf.model), ("wv", sf.wv_model),
                 ("mv", sf.mv_model)):
        out.update({f"{k}.{n}": p.detach().cpu().clone()
                    for n, p in m.named_parameters()})
        opt = getattr(state, f"{k}_opt")
        out.update({f"{k}_opt.mu.{n}": v.cpu().clone()
                    for n, v in opt.mu.items()})
        out.update({f"{k}_opt.nu.{n}": v.cpu().clone()
                    for n, v in opt.nu.items()})
        out[f"{k}_opt.count"] = dict(opt.count)
    return out


def assert_same_tensors(what, a, b):
    import torch

    if a.keys() != b.keys():
        raise AssertionError(f"{what}: different tensors")
    bad = [k for k in a if (a[k] != b[k] if isinstance(a[k], dict)
                            else not torch.equal(a[k], b[k]))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} differ, e.g. {bad[:3]}")


def hand_steps(cfg, steps, train_worker=None):
    """Epoch 0 of ``cfg`` by calling the steps by hand in the reference's
    order (each step's host score and update before the next step), with
    the loop's seeds and batches. ``train_worker`` None: a warmstart
    epoch."""
    import torch

    from bmhrl_tpu_torch.data.dataset import CaptioningDataset
    from bmhrl_tpu_torch.train.loop import make_step_factory, step_seed
    from bmhrl_tpu_torch.train.rewards import make_scorer

    ds = CaptioningDataset(cfg, "train")
    sf, state = make_step_factory(cfg, ds.train_vocab, "cuda")
    scorer = make_scorer(cfg.scorer, ds.train_vocab.itos,
                         ds.train_vocab.token_lists, cfg.rl_gamma_worker,
                         cfg.rl_gamma_manager)

    def dev(x):
        return torch.from_numpy(x).to("cuda")

    for i, batch in enumerate(ds.batches(0)):
        if i == steps:
            break
        b = {k: dev(batch[k]) for k in ("rgb", "flow", "audio")}
        b["caption_idx"] = dev(batch["caption_idx"]).long()
        seed = step_seed(cfg.seed, 0, i)
        if train_worker is None:
            state, _, aux = sf.warmstart_step(state, b, seed,
                                              cfg.rl_cap_warmstart_lr)
            w, m, _ = scorer.delta_both(
                aux["argmax"].cpu().numpy(), batch["captions"],
                aux["token_mask"].cpu().numpy(), aux["seg"].cpu().numpy())
            state, _ = sf.value_warmstart_step(
                state, aux["wf"], aux["mf"], dev(w), dev(m),
                aux["token_mask"], aux["seg"])
        else:
            roll = sf.rl_rollout(state, b, seed, train_worker)
            score, _ = scorer.delta_worker(roll["sampled"].cpu().numpy(),
                                           batch["captions"])
            state, _ = sf.rl_update(state, b, seed, cfg.rl_cap_lr, roll,
                                    dev(score), train_worker)
    torch.cuda.synchronize()
    return params_and_state(sf, state)


def loop_gates(paths, root):
    """With rl_pipeline off, one warmstart epoch and one worker epoch of
    the loop leave bit for bit the tensors of the steps called by hand;
    auto-resume restores every tensor of a checkpoint and continues at the
    next epoch in its phase."""
    import torch

    from bmhrl_tpu_torch.train.loop import train_rl_cap
    from bmhrl_tpu_torch.utils import checkpoint

    steps = 3
    for ws, tw in ((1, None), (0, True)):
        cfg = loop_config(paths, epoch_num=1, rl_warmstart_epochs=ws,
                          one_by_one_starts_at=1, rl_pipeline=False)
        out = train_rl_cap(cfg, max_steps_per_epoch=steps, device="cuda")
        got = params_and_state(out["step_factory"], out["state"])
        del out
        want = hand_steps(cfg, steps, tw)
        assert_same_tensors(f"loop vs hand-called steps (warmstart epochs "
                            f"{ws})", got, want)
        emit({"phase": "train_loop", "gate": "loop = hand-called steps",
              "epoch": "warmstart" if tw is None else "worker",
              "steps": steps, "tensors": len(got), "equal": True})
        del got, want
        torch.cuda.empty_cache()

    # a worker epoch, its checkpoint, then a restore and the next epoch
    log_dir = os.path.join(root, "log")
    cfg = loop_config(paths, epoch_num=1, rl_warmstart_epochs=0,
                      one_by_one_starts_at=5, to_log=True, log_dir=log_dir)
    saved = {}
    real_save = checkpoint.save_checkpoint

    def spy(path, model, wv, mv, state):
        t0 = time.perf_counter()
        real_save(path, model, wv, mv, state)
        saved[os.path.basename(path)] = time.perf_counter() - t0

    with mock.patch.object(checkpoint, "save_checkpoint", spy):
        out = train_rl_cap(cfg, max_steps_per_epoch=steps, device="cuda")
    trained = params_and_state(out["step_factory"], out["state"])
    del out
    back = train_rl_cap(cfg.replace(auto_resume=True), device="cuda")
    if back["start_epoch"] != 1 or back["epochs"] or set(saved) != {"E_0"}:
        raise AssertionError(f"auto-resume: start {back['start_epoch']}, "
                             f"saved {sorted(saved)}")
    assert_same_tensors("auto-resume", params_and_state(
        back["step_factory"], back["state"]), trained)
    del back
    more = train_rl_cap(cfg.replace(auto_resume=True, epoch_num=2),
                        max_steps_per_epoch=steps, device="cuda")
    nxt = [(r["epoch"], r["phase"]) for r in more["epochs"]]
    if nxt != [(1, "manager")]:
        raise AssertionError(f"auto-resume continued with {nxt}")
    emit({"phase": "train_loop", "gate": "auto-resume",
          "tensors": len(trained), "restored_equal": True,
          "continued": nxt, "checkpoint_save_s": saved["E_0"]})
    del more, trained
    shutil.rmtree(log_dir)
    torch.cuda.empty_cache()


def learning_proof(root, epochs=24, warmstart=8):
    """The port's synthetic_proof procedure at the flagship's width: the
    held-out METEOR after training against the untrained model's (mode
    eval on the same init). Logging (checkpoints, submissions) is off."""
    from types import SimpleNamespace

    from bmhrl_tpu_torch.cli.synthetic_proof import build_config
    from bmhrl_tpu_torch.train.loop import train_rl_cap
    from bmhrl_tpu_torch.utils.synthetic import generate

    paths = generate(os.path.join(root, "syn"), clips_per_class=16,
                     val_per_class=2, noise=0.4, seed=0)
    args = SimpleNamespace(small=False, B=16, mesh_data=1, scorer="CIDER",
                           epochs=epochs, warmstart=warmstart, eval_from=0,
                           seed=0, out=os.path.join(root, "syn"))
    cfg = build_config(paths, args).replace(to_log=False)
    base = train_rl_cap(cfg.replace(mode="eval"), device="cuda")
    base = base["val_1"]["METEOR"]
    t0 = time.perf_counter()
    out = train_rl_cap(cfg, device="cuda")
    seconds = time.perf_counter() - t0
    margin = out["best_metric"] - base
    emit({"phase": "train_loop", "what": "synthetic proof", "epochs": epochs,
          "warmstart_epochs": warmstart, "seconds": seconds,
          "untrained_METEOR": base, "best_METEOR": out["best_metric"],
          "margin": margin,
          "METEOR_by_epoch": [r.get("METEOR") for r in out["epochs"]],
          "loss_by_epoch": [r["loss"] for r in out["epochs"]]})
    if not margin > 0:
        raise AssertionError(f"synthetic proof: best METEOR "
                             f"{out['best_metric']} <= untrained {base}")


def phase_train_loop(K):
    """The training loop at the flagship's width (its timed runs, the
    first one the main path with launches counted), its gates and the
    learning proof. Returns the corpus paths for the profile phase."""
    import torch

    from bmhrl_tpu_torch.data.dataset import CaptioningDataset
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.loop import train_rl_cap

    root = tempfile.mkdtemp()
    paths = write_loop_corpus(root)
    cfg = loop_config(paths, epoch_num=4, rl_warmstart_epochs=1,
                      one_by_one_starts_at=3)
    # the same batches, read before the run: the loop without its feature
    # files and their loading thread
    ds = CaptioningDataset(cfg, "train")
    ahead = {e: list(itertools.islice(ds.batches(e), LOOP_STEPS))
             for e in range(cfg.epoch_num)}
    real_batches = CaptioningDataset.batches

    def read_ahead(self, epoch, *args, **kw):
        if self.phase == "train":
            return iter(ahead[epoch])
        return real_batches(self, epoch, *args, **kw)

    # pipeline on and off: from files in turns of both orders (on, off, off,
    # on: the order's own effect cancels), read ahead one turn (the
    # script's time limit holds the mesh phase too)
    runs = [(True, "files"), (False, "files"), (False, "files"),
            (True, "files"), (True, "read ahead"), (False, "read ahead")]
    for run, (pipeline, data) in enumerate(runs):
        torch.cuda.synchronize()
        if run == 0:
            _cuda.reset_launches()
        t0 = time.perf_counter()
        with (mock.patch.object(CaptioningDataset, "batches", read_ahead)
              if data == "read ahead" else contextlib.nullcontext()):
            out = train_rl_cap(cfg.replace(rl_pipeline=pipeline),
                               max_steps_per_epoch=LOOP_STEPS,
                               device="cuda")
        torch.cuda.synchronize()
        if run == 0:
            launches = dict(_cuda.LAUNCHES)
            for name, n in launches.items():
                K[name].rec["launches_train_loop"] = n
            # the bf16 path: every tensor-core kernel and both cells
            # (validation decodes through the folded kernel), no 3xTF32
            # route
            bad = {n: v for n, v in launches.items()
                   if (v <= 0) != n.endswith("_simt")}
            if bad:
                raise AssertionError(f"training loop launches: {launches}")
            emit({"phase": "train_loop", "main_path_launches": launches})
        emit({"phase": "train_loop", "run": run, "rl_pipeline": pipeline,
              "data": data, "seconds": time.perf_counter() - t0,
              "val_METEOR": out["best_metric"]})
        loop_records(run, pipeline, data, out)
        paths_ok = {r["scorer_path"] for r in out["epochs"]}
        if paths_ok != {"native"}:
            raise AssertionError(f"reward scorer paths: {paths_ok}")
        del out
        torch.cuda.empty_cache()
    loop_gates(paths, root)
    learning_proof(root)
    return paths


# --------------------------------------------------------------------------
DETR_SMALL = dict(voc_size=40, d_model=256, d_model_caps=32, d_goal=16,
                  nhead=2, num_layers=2, n_time=2, dim_ff=64, d_video=128)


def build_detr(kwargs, device, seed=0, dout_p=0.1, flax_init=False):
    """A ``DetrCaption(**kwargs)`` on ``device`` with random weights from
    ``seed`` (the flax initialisers' values with ``flax_init``)."""
    from bmhrl_tpu_torch.models.detr import DetrCaption
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = DetrCaption(**kwargs, dout_p=dout_p, device=device)
    load_jax_params(model, random_module_params(model, seed, flax_init))
    return model


def detr_feats(B, d_v, device, seed, Sv=128, Sa=256):
    """Features whose clips each carry a pattern of their own (uniform
    noise alone averages to one memory for every clip)."""
    import torch

    f = make_feats(B, Sv, Sa, d_v, 128, "cpu", seed=seed)
    rng = np.random.RandomState(seed + 1)
    f["rgb"] += 3.0 * torch.from_numpy(rng.randn(B, 1, d_v).astype(
        np.float32))
    return {k: v.to(device) for k, v in f.items()}


def small_detr_card_vs_cpu():
    """The small f32 DETR (default and pre-goal) decoded on the card
    (kernels: the 3xTF32 flash and folded routes) and on the CPU (plain
    versions) with the same draws, in every mode: identical tokens. Then
    one ``detr_update`` on each device from the same state and inputs:
    losses and parameters within 1e-5. It runs with cuDNN's TF32 at
    PyTorch's default (on): the model's f32 convolutions must not depend on
    the caller's setting."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode
    from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the small DETR check runs under PyTorch's "
                             "default cuDNN setting (TF32 on)")
    HostDraws = host_draws_class()
    out = {}
    for device in ("cuda", "cpu"):
        res = {}
        for pg in (False, True):
            model = build_detr(dict(DETR_SMALL, dtype=torch.float32,
                                    pre_goal_attention=pg), device, seed=4)
            model.eval().requires_grad_(False)
            with torch.no_grad():
                model.linear.bias[EOS] += 1.5  # some captions end early
            feats = detr_feats(8, 128, device, seed=4, Sa=160)
            feats["rgb"][5] = 0.0  # a clip without features
            masks = make_masks(feats)
            args = (model, feats, masks, 12, BOS, EOS, PAD)
            modes = {"greedy": lambda: decode(*args)[0],
                     "beam4": lambda: beam_decode(*args, beam_width=4)[0]}
            if not pg:
                modes["sampled"] = lambda: decode(
                    *args, greedy=False, draws=HostDraws(3, device),
                    top_k=5)[0]
                modes["full_greedy"] = lambda: decode(*args,
                                                      use_fast=False)[0]
            for name, run in modes.items():
                res[f"{'pre_goal_' if pg else ''}{name}"] = run().cpu()
        out[device] = res
    # one training step, dropout 0, from the same state and inputs: the
    # CPU rollout's samples and Hungarian targets go to both devices (an
    # assignment's near-tie could otherwise differ)
    upd = {}
    for device in ("cpu", "cuda"):
        model = build_detr(dict(DETR_SMALL, dtype=torch.float32), device,
                           seed=5, dout_p=0.0)
        nets = [load_jax_params(cls(32, device=device),
                                random_module_params(cls(32, device="meta"),
                                                     6 + i))
                for i, cls in enumerate((BMWorkerValueFunction,
                                         BMManagerValueFunction))]
        sf = DetrStepFactory(Config(grad_clip=0.5), model, *nets, True)
        state = sf.init_state()
        batch = make_train_batch(4, Sv=128, Sa=160, Lc=8, voc=40, d_v=128,
                                 device="cpu", seed=5)
        batch = {k: v.to(device) for k, v in batch.items()}
        if device == "cpu":
            roll = sf.detr_rollout(state, batch, 1, HostDraws(1, device))
            sampled = roll["sampled"]
            tc = torch.from_numpy(sf.match_targets(roll["pred_classes"],
                                                   roll["x_idx"]))
            score = torch.from_numpy(np.random.RandomState(2).rand(
                4, 8).astype(np.float32))
        _, m = sf.detr_update(state, batch, 1, 1e-4, sampled.to(device),
                              score.to(device), tc.to(device),
                              HostDraws(1, device))
        upd[device] = ({k: float(v) for k, v in m.items()},
                       {n: p.detach().cpu() for n, p in
                        model.named_parameters()})
    same = {k: bool(torch.equal(out["cuda"][k], out["cpu"][k]))
            for k in out["cuda"]}
    (lc, pc), (lp, pp) = upd["cuda"], upd["cpu"]
    loss_err = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lc}
    param_err = max(float((pc[n] - pp[n]).abs().max()) for n in pc)
    emit({"phase": "detr", "check": "small_card_vs_cpu", "dtype": "f32",
          "tokens_identical": same, "update_losses": lc,
          "update_loss_rel_err": loss_err,
          "update_param_max_abs_err": param_err, "tol": 1e-5})
    if (not all(same.values()) or max(loss_err.values()) > 1e-5
            or param_err > 1e-5):
        raise AssertionError("the small DETR disagrees card vs CPU")


def detr_serve(model, reqs, cfg, itos, what, K, **opts):
    """A serve of ``reqs`` by the DETR ``model`` as a main path (launches
    zeroed just before, read just after); returns (sentences, launches)."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.serve import CaptionServer

    CaptionServer(cfg, model, itos, device="cuda", **opts).caption(
        reqs[:3], batch_size=32)  # warm-up
    server = CaptionServer(cfg, model, itos, device="cuda", **opts)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    preds, stats = server.caption(reqs, batch_size=32)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    sents = [s["sentence"] for segs in preds["results"].values()
             for s in segs]
    emit({"phase": "detr", "serve": what, "options": opts,
          "requests": len(reqs), "answered": len(sents),
          "stats": stats.summary(), "launches": launches,
          "example": sents[:3]})
    if len(sents) != len(reqs):
        raise AssertionError(f"DETR {what} serve: a request got no answer")
    for name, n in launches.items():
        K[name].rec[f"launches_detr_{what}_serve"] = n
    return sents, launches


def detr_train(K, cfg):
    """The flagship DETR's training steps at B=16 (Sv=128, Sa=256, 31
    positions): the main run (3 rollout + match + update steps, launches
    counted), the encoder's gradients through flash, ms/step and the
    device's idle share of a step."""
    import torch

    from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                              BMWorkerValueFunction)
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train import losses as L
    from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    from bmhrl_tpu_torch.models.detr import DetrCaption

    model = DetrCaption.build(cfg, VOC, "cuda")
    load_jax_params(model, random_module_params(model, 0, flax_init=True))
    nets = [load_jax_params(cls(300, device="cuda"), random_module_params(
        cls(300, device="meta"), 1 + i, flax_init=True))
        for i, cls in enumerate((BMWorkerValueFunction,
                                 BMManagerValueFunction))]
    sf = DetrStepFactory(cfg, model, *nets, emb_trainable=True)
    state = sf.init_state()
    batch = make_train_batch(16, seed=21)
    # every encoder parameter gets a gradient through flash attention
    d = sf.draws(0)
    V, A, x_idx, y_idx, masks = sf._prep(batch, d)
    out = model(V, A, x_idx, masks, deterministic=False, draws=d)
    enc = {n: p for n, p in model.named_parameters()
           if n.startswith("encoder.")}
    grads = torch.autograd.grad(out[0].float().mean(), list(enc.values()))
    zero = [n for n, g in zip(enc, grads) if not float(g.abs().sum()) > 0]
    if zero:
        raise AssertionError(f"encoder parameters without gradient: {zero}")
    del out, grads

    def step(seed):
        nonlocal state
        roll = sf.detr_rollout(state, batch, seed)
        host = {k: roll[k].cpu().numpy() for k in ("sampled",
                                                     "pred_classes",
                                                     "x_idx")}
        tc = torch.from_numpy(sf.match_targets(host["pred_classes"],
                                               host["x_idx"])).cuda()
        score = torch.from_numpy(
            (host["sampled"] % 7 == 0).astype(np.float32)).cuda()
        state, m = sf.detr_update(state, batch, seed, 1e-4, roll["sampled"],
                                  score, tc)
        return m

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses = [step(s) for s in range(3)]
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    for name, n in launches.items():
        K[name].rec["launches_detr_train"] = n
    moved = sum(not torch.equal(before[n], p)
                for n, p in model.named_parameters())
    finite = all(torch.isfinite(p).all() for p in model.parameters())
    emit({"phase": "detr", "train_main_run": "3 steps (rollout + Hungarian "
          "match + detr_update), B=16", "launches": launches,
          "losses": [{k: float(v) for k, v in m.items()} for m in losses],
          "params_moved": moved, "params": len(before),
          "all_finite": finite})
    # 6 flash sites a forward (3 encoder self-attentions, 3 decoder
    # memory cross-attentions) x 2 forwards a step
    if launches["flash_attention_tc"] != 3 * 2 * 6 or not finite:
        raise AssertionError(f"DETR training launches {launches}")
    if launches["flash_attention_simt"] or launches["folded_attend_tc"]:
        raise AssertionError(f"DETR training took another route: "
                             f"{launches}")
    ms, samples = step_ms(lambda: step(7))
    # the device's idle share of one step
    from torch.profiler import ProfilerActivity, profile

    step(8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("detr_step"):
            step(9)
        torch.cuda.synchronize()
    (_, wall, busy, n), = span_busy(prof, "detr_step")
    emit({"phase": "detr", "what": "train step", "B": 16, "Sv": 128,
          "Sa": 256, "positions": 31, "ms_per_step": ms, "samples": samples,
          "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall, "device_launches": n})
    del sf, state, model
    torch.cuda.empty_cache()


def detr_loop_and_cli(K, itos_reqs):
    """``run_training --mode DETR`` for 2 epochs of 8 steps on the written
    corpus (the loop's main path, launches counted), then
    ``serve_captions --mode DETR --checkpoint_dir`` on its epoch-0
    checkpoint: the submissions of the direct server over the same
    weights."""
    import torch

    from bmhrl_tpu_torch.cli import run_training as pcli
    from bmhrl_tpu_torch.cli import serve_captions as pserve
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.serve import CaptionServer
    from bmhrl_tpu_torch.train.loop import build_model
    from bmhrl_tpu_torch.utils.checkpoint import load_model_params

    root = tempfile.mkdtemp()
    paths = write_loop_corpus(root)
    argv = ["--device", "cuda", "--mode", "DETR", "--train_meta_path",
            paths["train"], "--val_1_meta_path", paths["val_1"],
            "--vatex_meta_path", paths["val_1"] + ".absent",
            "--msrvtt_meta_path", paths["val_1"] + ".absent",
            "--video_features_path", paths["video_features_path"],
            "--audio_features_path", paths["audio_features_path"],
            "--reference_paths", *(paths["ref"],) * 4, "--rl_critic_path",
            paths["ref"] + ".absent", "--B", "16", "--scorer", "METEOR",
            "--log_dir", os.path.join(root, "log"), "--epoch_num", "2",
            "--max_steps_per_epoch", str(LOOP_STEPS),
            "--one_by_one_starts_at", "1"]
    t0 = time.perf_counter()
    out, _, launches = run_cli(pcli.main, argv)
    emit({"phase": "detr", "loop": "run_training --mode DETR",
          "seconds": time.perf_counter() - t0, "launches": launches,
          "epochs": [{k: r[k] for k in ("epoch", "phase", "steps", "loss",
                                        "train_s")}
                     | {"ms_per_step": {n: s["p50_ms"] for n, s in
                                        r["timer"].items()
                                        if "p50_ms" in s}}
                     for r in out["epochs"]]})
    for name, n in launches.items():
        K[name].rec["launches_detr_loop"] = n
    if ([(r["phase"], r["steps"]) for r in out["epochs"]]
            != [("detr", LOOP_STEPS)] * 2
            or not all(math.isfinite(r["loss"]) for r in out["epochs"])):
        raise AssertionError(f"DETR loop records {out['epochs']}")
    if launches["flash_attention_tc"] <= 0 or launches["folded_attend_tc"] \
            <= 0:
        raise AssertionError(f"DETR loop launches {launches}")
    ckpt = os.path.join(out["step_factory"].cfg.model_checkpoint_path,
                        "checkpoints", "E_0")
    del out
    torch.cuda.empty_cache()

    vdir, adir, reqs = itos_reqs
    sub = os.path.join(root, "detr_sub.json")
    _, lines, cli_launches = run_cli(pserve.main, [
        "--meta", paths["val_1"], "--video_features_path",
        paths["video_features_path"], "--audio_features_path",
        paths["audio_features_path"], "--train_meta_path", paths["train"],
        "--mode", "DETR", "--checkpoint_dir", ckpt, "--batch_size", "32",
        "--out", sub])
    cfg = Config(mode="DETR", to_log=False,
                 video_features_path=paths["video_features_path"],
                 audio_features_path=paths["audio_features_path"])
    vocab = build_vocab_from_tsv(paths["train"])
    model = load_model_params(ckpt, build_model(cfg, len(vocab), "cuda"))
    from bmhrl_tpu_torch.serve import read_meta_tsv

    want, _ = CaptionServer(cfg, model.eval().requires_grad_(False),
                            vocab.itos, device="cuda").caption(
        read_meta_tsv(paths["val_1"]), batch_size=32)
    got = json.load(open(sub))
    emit({"phase": "detr", "cli": "serve_captions --mode DETR "
          "--checkpoint_dir", "requests": 32, "equal_to_direct_server":
          got == want, "launches": cli_launches, "stats": lines[-1]})
    if got != want:
        raise AssertionError("the DETR CLI's submissions differ from the "
                             "direct server's")
    shutil.rmtree(root, ignore_errors=True)


def phase_detr(K, bimodal):
    """The DETR captioner: small f32 card = CPU; the flagship (bf16,
    vocabulary 10172, random weights) serving the 64 requests greedily
    (the main path) and with beam W=4, the pre-goal flagship serving 8
    requests (the cell kernels' main path), per-step agreement with the
    plain versions, host syncs per token, clips/s beside the bimodal
    flagship's greedy B=256; training steps; the loop and the CLI."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import BOS, PAD, SPECIALS
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import beam_decode, decode

    small_detr_card_vs_cpu()
    cfg = Config(mode="DETR")
    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]
    model = build_detr(dict(voc_size=VOC), "cuda")
    model.eval().requires_grad_(False)
    emit({"phase": "detr", "params": sum(p.numel()
                                         for p in model.parameters())})
    root = tempfile.mkdtemp()
    vdir, adir, reqs = write_requests(root)
    scfg = cfg.replace(video_features_path=vdir, audio_features_path=adir)
    _, launches = detr_serve(model, reqs, scfg, itos, "greedy", K)
    if (launches["flash_attention_tc"] <= 0
            or launches["folded_attend_tc"] <= 0
            or launches["flash_attention_simt"]
            or launches["folded_attend_simt"]):
        raise AssertionError(f"DETR greedy serve launches {launches}")
    detr_serve(model, reqs, scfg, itos, "beam", K, beam_width=4,
               length_penalty=1.0)
    pg = build_detr(dict(voc_size=VOC, pre_goal_attention=True), "cuda",
                    seed=1).eval().requires_grad_(False)
    _, launches = detr_serve(pg, reqs[:8], scfg, itos, "pre_goal", K)
    if launches["lstm_cell"] <= 0 or launches["gru_cell"] <= 0:
        raise AssertionError(f"pre-goal serve launches {launches}")
    del pg
    torch.cuda.empty_cache()

    # K3 at the object attention of the DETR's token step (B=256 clips,
    # G = 4 heads, S = 100 objects, draw 256, bf16 objects, no mask)
    from bmhrl_tpu_torch.ops import attention as att

    gen = torch.Generator("cuda").manual_seed(5)
    qe = torch.randn(256, 4, 256, device="cuda", generator=gen)
    mem = torch.randn(256, 100, 256, device="cuda",
                      generator=gen).to(torch.bfloat16)
    scale = 1.0 / 16.0
    err = check_close("folded DETR objects",
                      att.folded_attend(qe, mem, None, scale),
                      att.folded_attend_plain(qe, mem, None, scale), 1e-4)
    ms, ems, pms, lms, nbytes, ops = folded_times(qe, mem, None, scale)
    bms, by = bound_ms(nbytes, ops, "f32")
    rec = dict(ms=ms, eager_ms=ems, plain_ms=pms, library_ms=lms,
               bound_ms=bms, bound_by=by, max_abs_err=err)
    K["folded_tc"].rec["detr_objects_B256_G4_S100"] = rec
    K["folded_tc"].err(err)
    emit({"kernel": "folded_attend_tc", "case": "DETR objects, B=256, G=4, "
          "S=100, draw=256", **rec})

    feats = detr_feats(64, 1024, "cuda", seed=31)
    masks = make_masks(feats)
    tok_k, prob_k = decode(model, feats, masks, 30, BOS, -1, PAD)
    with plain_kernels():
        tok_p, _ = decode(model, feats, masks, 30, BOS, -1, PAD)
    forced, regret = forced_agreement(model, feats, masks, tok_p)
    per_token, where = syncs_per_token(
        lambda n: decode(model, feats, masks, n, BOS, -1, PAD))
    emit({"phase": "detr", "check": "plain_vs_kernels", "B": 64,
          "token_agreement": forced, "min_required": 0.95,
          "max_logprob_gap_where_they_differ": regret,
          "free_running_token_agreement": float(
              (tok_k == tok_p).float()[:, 1:].mean()),
          "host_syncs_per_token": per_token, "sync_sites": where})
    if forced < 0.95 or not torch.isfinite(prob_k).all():
        raise AssertionError(f"DETR token agreement {forced}")
    if abs(per_token - 1.0) > 1e-9:
        raise AssertionError(f"DETR greedy syncs {per_token} per token")

    for B in (32, 256):
        feats = detr_feats(B, 1024, "cuda", seed=B)
        masks = make_masks(feats)
        throughput(lambda: decode(model, feats, masks, 30, BOS, -1, PAD), B,
                   model="DETR", mode="greedy", B=B)
        if B == 256:
            throughput(lambda: decode(bimodal, feats, masks, 30, BOS, -1,
                                      PAD), B, model="BMHRL",
                       mode="greedy", B=B)
            throughput(lambda: decode(model, feats, masks, 30, BOS, -1, PAD,
                                      greedy=False), B, model="DETR",
                       mode="sampled", B=B)
    feats = detr_feats(64, 1024, "cuda", seed=64)
    masks = make_masks(feats)
    throughput(lambda: beam_decode(model, feats, masks, 30, BOS, -1, PAD,
                                   beam_width=4), 64, model="DETR",
               mode="beam W=4", B=64)
    del model
    torch.cuda.empty_cache()
    detr_train(K, cfg)
    detr_loop_and_cli(K, (vdir, adir, reqs))
    shutil.rmtree(root, ignore_errors=True)


def phase_leftovers(K):
    """``train_critic`` on a generated corpus (its ``critic.cp`` installed
    into the flagship's critic gives the trained module's logits through
    the cell kernels) and one ``run_training --mode verbose`` pass."""
    import torch

    from bmhrl_tpu_torch.cli import run_training as pcli
    from bmhrl_tpu_torch.cli import train_critic as tcli
    from bmhrl_tpu_torch.models.critic import SegmentCritic
    from bmhrl_tpu_torch.utils.checkpoint import (export_torch_critic,
                                                  install_critic)

    root = tempfile.mkdtemp()
    paths = write_loop_corpus(root)
    args = tcli.build_parser().parse_args([
        "--corpus_json", paths["ref"], "--train_meta_path", paths["train"],
        "--epochs", "4", "--batch_size", "8", "--lr", "1e-3",
        "--device", "cuda"])
    t0 = time.perf_counter()
    trained, bces = tcli.train(args)
    out = export_torch_critic(trained.critic, os.path.join(root, "c.cp"))
    holder = torch.nn.Module()
    holder.critic = SegmentCritic(300, "cuda")
    install_critic(holder, out)
    tokens = torch.randint(4, 1000, (16, 24), device="cuda")
    with torch.no_grad():
        emb = trained.emb(tokens)
        want = trained.critic.logits_trainable(emb)
        got = holder.critic(emb)  # the frozen forward: cell kernels
    err = float((got - want).abs().max())
    emit({"phase": "leftovers", "cli": "train_critic", "epochs": 4,
          "bce": bces, "seconds": time.perf_counter() - t0,
          "installed_vs_trained_logits_max_abs_err": err, "tol": 1e-4})
    if not bces[-1] < bces[0] or err > 1e-4:
        raise AssertionError("critic pretraining did not learn or its "
                             "critic.cp does not reproduce it")
    recs, _, launches = run_cli(pcli.main, [
        "--device", "cuda", "--mode", "verbose", "--train_meta_path",
        paths["train"], "--val_1_meta_path", paths["val_1"] + ".absent",
        "--vatex_meta_path", paths["val_1"] + ".absent",
        "--msrvtt_meta_path", paths["val_1"] + ".absent",
        "--video_features_path", paths["video_features_path"],
        "--audio_features_path", paths["audio_features_path"],
        "--rl_critic_path", out, "--B", "16", "--scorer", "METEOR",
        "--dont_log", "--max_steps_per_epoch", "1"])
    emit({"phase": "leftovers", "cli": "run_training --mode verbose",
          "batches": len(recs), "launches": launches,
          "plain_sum": float(recs[0]["plain"].sum()),
          "biased_sum": float(recs[0]["biased"].sum())})
    if len(recs) != 1 or not np.isfinite(recs[0]["biased"]).all():
        raise AssertionError("the verbose pass failed")
    shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# the proposal generator: a small f32 model for the card-vs-CPU check, and
# the CLIs' widths (MultimodalProposalGenerator's defaults) for the rest
PROP_SMALL = dict(d_vid=256, d_aud=128, d_model=256, d_model_aud=128,
                  d_ff_v=256, d_ff_a=128, att_heads=2, att_layers=2,
                  num_anchors=10)
PROP_ANCHORS = np.asarray([2.0, 4.5, 8.0, 12.5, 18.0, 25.0, 34.0, 46.0,
                           62.0, 85.0], np.float32)


def proposal_batch(B, Sv, Sa, d_v, d_a, seed, missing_row):
    """A batch shaped as ``ProposalDataset.make_batch``'s: 30-180 s videos,
    features over ragged original lengths, 1-4 events a video with their
    YOLO targets (``models.proposal.yolo_targets``); ``missing_row`` is a
    video without feature files (one zero row, original length 1)."""
    from bmhrl_tpu_torch.models.proposal import yolo_targets

    rng = np.random.RandomState(seed)
    dur = rng.uniform(30, 180, B).astype(np.float32)
    olv = rng.randint(Sv // 3, Sv + 1, B).astype(np.int32)
    ola = rng.randint(Sa // 3, Sa + 1, B).astype(np.int32)
    olv[missing_row] = ola[missing_row] = 1
    V = rng.rand(B, Sv, d_v).astype(np.float32)
    A = rng.rand(B, Sa, d_a).astype(np.float32)
    V[missing_row] = A[missing_row] = 0.0
    for b in range(B):
        V[b, olv[b]:] = 0.0
        A[b, ola[b]:] = 0.0
    gts = [np.sort(rng.uniform(0, d, (rng.randint(1, 5), 2)), 1)
           for d in dur]

    def targets(ol, S):
        per = [yolo_targets(g, float(d), int(o), S, PROP_ANCHORS)
               for g, d, o in zip(gts, dur, ol)]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    return {"feature_stacks": {"V": V, "A": A},
            "masks": {"V_mask": (np.arange(Sv)[None] < olv[:, None])[:, None],
                      "A_mask": (np.arange(Sa)[None] < ola[:, None])[:, None]},
            "targets": {"video": targets(olv, Sv), "audio": targets(ola, Sa),
                        "anchors_v": PROP_ANCHORS, "anchors_a": PROP_ANCHORS,
                        "duration": dur, "orig_len_video": olv,
                        "orig_len_audio": ola}}


def segments_err(got, want):
    """Largest error of (B, N, 3) predictions: confidences absolute, a
    segment's start and end relative to its scale (the larger of |start|
    and |end|, at least 1 s: both endpoints are centre -+ length / 2)."""
    scale = want[..., :2].abs().amax(-1, keepdim=True).clamp_min(1.0)
    return max(float((got[..., 2] - want[..., 2]).abs().max()),
               float(((got[..., :2] - want[..., :2]).abs() / scale).max()))


def small_proposals_card_vs_cpu():
    """A small f32 proposal generator (2 heads of d=128: the 3xTF32
    flash route) on the card and on the CPU with the same weights: the
    predictions and losses within 1e-5 (segments relative to their
    scale), then one train_step with dropout from the same draws and the
    clip triggered, the updated parameters within 1e-5. cuDNN's TF32 stays
    at PyTorch's default: the heads' convolutions turn it off."""
    import torch

    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.steps import _grads
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
    from bmhrl_tpu_torch.weights import (load_jax_params,
                                         random_jax_layout_params)

    HostDraws = host_draws_class()
    batch = proposal_batch(4, 300, 800, 256, 128, seed=31, missing_row=2)
    tree = random_jax_layout_params(dict(PROP_SMALL, dout_p=0.1), seed=7)
    clip = 1e-3
    out = {}
    for device in ("cuda", "cpu"):
        model = load_jax_params(MultimodalProposalGenerator(
            **PROP_SMALL, dout_p=0.1, dtype=torch.float32, device=device),
            tree)
        sf = ProposalStepFactory(model, lr=5e-5, grad_clip=clip,
                                 device=device)
        state = sf.init_state()
        _cuda.reset_launches()
        preds = sf.predict(state, batch).cpu()
        launches = dict(_cuda.LAUNCHES)
        b = sf.to_device(batch)
        with torch.no_grad():
            _, loss, la, lv = model(b["feature_stacks"], b["targets"],
                                    b["masks"])
        if device == "cpu":
            _, tl, _, _ = model(b["feature_stacks"], b["targets"],
                                b["masks"], HostDraws(5, device))
            gnorm = float(torch.sqrt(sum(
                g.square().sum() for g in _grads(tl, sf.params).values())))
        state, m = sf.train_step(state, batch, HostDraws(5, device))
        out[device] = dict(
            preds=preds, launches=launches,
            losses=np.array([float(loss)] + [float(d[k]) for d in (la, lv)
                                             for k in sorted(d)]
                            + [float(m[k]) for k in sorted(m)]),
            params={n: p.detach().cpu() for n, p in model.named_parameters()})
    card, cpu = out["cuda"], out["cpu"]
    pred_err = segments_err(card["preds"], cpu["preds"])
    loss_err = float(np.max(np.abs(card["losses"] - cpu["losses"])
                            / np.abs(cpu["losses"])))
    param_err = max(float((card["params"][n] - p).abs().max())
                    for n, p in cpu["params"].items())
    emit({"phase": "proposals", "check": "small f32 card vs CPU",
          "B": 4, "Sv": 300, "Sa": 800, "dims": PROP_SMALL,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "pred_err": pred_err, "loss_rel_err": loss_err,
          "grad_norm": gnorm, "grad_clip": clip,
          "param_max_abs_err": param_err, "tol": 1e-5,
          "launches_card_forward": card["launches"]})
    if not (pred_err <= 1e-5 and loss_err <= 1e-5 and param_err <= 1e-5):
        raise AssertionError("the small proposal generator disagrees "
                             "between card and CPU")
    if gnorm <= clip:
        raise AssertionError(f"the clip did not trigger: norm {gnorm}")
    if card["launches"]["flash_attention_simt"] != 8 or \
            card["launches"]["flash_attention_tc"]:
        raise AssertionError(f"small f32 forward launches "
                             f"{card['launches']}")


def proposal_flash_times(K):
    """Flash attention at the proposal encoder's four sites of one layer
    (B=8, 4 heads of d=256, bf16; V<-V 300x300, A<-A 800x800, V<-A
    300x800, A<-V 800x300), ragged key-pad masks and one fully-masked row
    (= mean(V)): kernel vs plain version within 2e-2; kernel, plain and
    ``scaled_dot_product_attention`` times with the bound, and the
    backward (the plain recompute) against SDPA's forward + backward.
    Sums go on the tensor-core flash record (``proposal_layer_B8``)."""
    import torch
    import torch.nn.functional as Fn

    from bmhrl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, d, tol = 8, 4, 256, 2e-2
    HD = H * d
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 bwd_recompute_ms=0.0, fwd_bwd_eager_ms=0.0,
                 sdpa_fwd_bwd_eager_ms=0.0, fwd_bwd_bound_ms=0.0,
                 max_abs_err=0.0)
    bytes_ms = ops_ms = 0.0
    for site, Sq, Sk in (("V<-V", 300, 300), ("A<-A", 800, 800),
                         ("V<-A", 300, 800), ("A<-V", 800, 300)):
        def rnd(S, scale=1.0):
            return (torch.randn(B, S, HD, generator=g, device=dev)
                    * scale).to(torch.bfloat16)
        q, k, v, go = rnd(Sq, 0.3), rnd(Sk), rnd(Sk), rnd(Sq)
        lens = torch.randint(Sk // 3, Sk + 1, (B,), generator=g, device=dev)
        mask = torch.arange(Sk, device=dev)[None] < lens[:, None]
        mask[3] = False
        if att.flash_route(q.dtype, d) != "tc":
            raise AssertionError("the proposal sites left the tensor cores")
        got = att.flash_attention_bsd(q, k, v, mask, H)
        want = att.flash_attention_bsd_plain(q, k, v, mask, H)
        torch.cuda.synchronize()
        e = check_close(f"flash proposal {site}", got, want, tol)
        mean_v = v[3].float().mean(0).expand_as(got[3])
        e = max(e, check_close(f"flash proposal {site} masked row = mean(V)",
                               got[3], mean_v, tol))
        K["flash_tc"].err(e)
        ms = time_ms(lambda: att.flash_attention_bsd(q, k, v, mask, H))
        pms = time_ms(lambda: att.flash_attention_bsd_plain(q, k, v, mask,
                                                            H), iters=5)
        bwd = time_ms(lambda: att.flash_attention_bsd_bwd(q, k, v, mask, go,
                                                          H), iters=5)
        qh, kh, vh = (t.view(B, -1, H, d).transpose(1, 2) for t in (q, k, v))
        m4 = mask[:, None, None, :]
        lms = time_ms(lambda: Fn.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m4))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def port_fb():
            o = att.flash_attention_bsd(qg, kg, vg, mask, H)
            return torch.autograd.grad(o, (qg, kg, vg), go)

        qr, kr, vr = (t.detach().requires_grad_() for t in (qh, kh, vh))
        goh = go.view(B, Sq, H, d).transpose(1, 2)

        def sdpa_fb():
            o = Fn.scaled_dot_product_attention(qr, kr, vr, attn_mask=m4)
            return torch.autograd.grad(o, (qr, kr, vr), goh)

        fb = eager_ms(port_fb, iters=5)
        lfb = eager_ms(sdpa_fb, iters=5)
        nbytes = (2 * B * Sq * HD + 2 * B * Sk * HD) * 2 + B * Sk * 4
        ops = 4.0 * B * H * Sq * Sk * d
        bms, by = bound_ms(nbytes, ops, "bf16")
        fbb, _ = bound_ms((3 * B * Sq * HD + 3 * B * Sk * HD) * 2
                          + B * Sk * 4, 3 * ops, "bf16")
        emit({"kernel": "flash_attention_tc", "case": f"proposal {site}",
              "B": B, "Sq": Sq, "Sk": Sk, "H": H, "d": d, "dtype": "bf16",
              "max_abs_err": e, "tol": tol, "kernel_ms": ms,
              "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
              "bound_by": by, "bwd_recompute_ms": bwd,
              "fwd_bwd_eager_ms": fb, "sdpa_fwd_bwd_eager_ms": lfb,
              "fwd_bwd_bound_ms": fbb})
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bwd_recompute_ms", bwd), ("fwd_bwd_eager_ms", fb),
                         ("sdpa_fwd_bwd_eager_ms", lfb),
                         ("fwd_bwd_bound_ms", fbb)):
            total[key] += val
        total["max_abs_err"] = max(total["max_abs_err"], e)
        bytes_ms += nbytes / PEAK_BYTES * 1e3
        ops_ms += ops / PEAK_OPS["bf16"] * 1e3
        del q, k, v, go, qg, kg, vg, qr, kr, vr
    total["bound_ms"] = max(bytes_ms, ops_ms)
    total["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"kernel": "flash_attention_tc", "case": "proposal: the four "
          "sites of one encoder layer, B=8", **total})
    K["flash_tc"].rec["proposal_layer_B8"] = total
    torch.cuda.empty_cache()


def proposal_step_split(sf, state, batch, seed):
    """Device-timeline ms of one train_step's forward (and of the f32
    heads inside it), backward and optimizer update, from CUDA events."""
    import torch

    from bmhrl_tpu_torch.train import steps_proposal as sp

    names = ("start", "fwd0", "fwd1", "bwd0", "bwd1", "opt0", "opt1", "end",
             "hv0", "hv1", "ha0", "ha1")
    ev = {k: torch.cuda.Event(enable_timing=True) for k in names}
    grads, update = sp._grads, sf.optim.update

    def timed(a, b, fn):
        def run(*args, **kw):
            ev[a].record()
            res = fn(*args, **kw)
            ev[b].record()
            return res
        return run

    m = sf.model
    hooks = []
    for mod, a, b in ((m, "fwd0", "fwd1"), (m.head_V, "hv0", "hv1"),
                      (m.head_A, "ha0", "ha1")):
        hooks += [mod.register_forward_pre_hook(
                      lambda *x, a=a: ev[a].record()),
                  mod.register_forward_hook(lambda *x, b=b: ev[b].record())]
    try:
        with mock.patch.object(sp, "_grads", timed("bwd0", "bwd1", grads)), \
                mock.patch.object(sf.optim, "update",
                                  timed("opt0", "opt1", update)):
            ev["start"].record()
            state, _ = sf.train_step(state, batch, sf.draws(seed))
            ev["end"].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return state, {"forward_ms": ev["fwd0"].elapsed_time(ev["fwd1"]),
                   "heads_forward_ms": ev["hv0"].elapsed_time(ev["hv1"])
                   + ev["ha0"].elapsed_time(ev["ha1"]),
                   "backward_ms": ev["bwd0"].elapsed_time(ev["bwd1"]),
                   "optimizer_ms": ev["opt0"].elapsed_time(ev["opt1"]),
                   "step_ms": ev["start"].elapsed_time(ev["end"])}


def proposal_forward_flops(model, batch):
    """Matmul and convolution FLOPs of one deterministic forward (counted
    by ``torch.utils.flop_counter`` over the kernels' plain versions):
    (all, the f32 heads' share)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    heads = []
    with torch.no_grad(), plain_kernels(), \
            FlopCounterMode(display=False) as counter:
        hooks = []
        for head in (model.head_V, model.head_A):
            hooks += [head.register_forward_pre_hook(
                          lambda *a: heads.append(-counter.get_total_flops())),
                      head.register_forward_hook(
                          lambda *a: heads.append(counter.get_total_flops()))]
        try:
            model(batch["feature_stacks"], batch["targets"], batch["masks"])
        finally:
            for h in hooks:
                h.remove()
    return counter.get_total_flops(), sum(heads)


def proposal_flagship_train(K):
    """The proposal generator at the CLIs' widths (d_vid 1024, d_aud 128,
    d_model 1024 / 128, d_ff 1024 / 512, 4 heads, 2 layers, 10 anchors,
    bf16, dropout 0.1; random weights from seed 0) on a B=8 batch at the
    pads (Sv 300, Sa 800): every encoder parameter's gradient through
    flash, the training main run (10 steps on one batch, launches counted:
    8 tensor-core flash launches a forward, nothing else of csrc/; the
    loss falls), ms/step, the step's split, FLOPs and the device's idle
    share of a step, and the predict ms at B=8."""
    import torch

    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
    from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

    model = MultimodalProposalGenerator(device="cuda")
    load_jax_params(model, random_module_params(model, 0, flax_init=True))
    sf = ProposalStepFactory(model, device="cuda")
    batch = sf.to_device(proposal_batch(8, 300, 800, 1024, 128, seed=41,
                                        missing_row=5))
    b = batch
    _, loss, _, _ = model(b["feature_stacks"], b["targets"], b["masks"],
                          sf.draws(0))
    enc = {n: p for n, p in model.named_parameters()
           if n.startswith("encoder.")}
    grads = torch.autograd.grad(loss, list(enc.values()))
    zero = [n for n, gr in zip(enc, grads) if not float(gr.abs().sum()) > 0]
    if zero:
        raise AssertionError(f"encoder parameters without gradient: {zero}")
    del loss, grads
    state = sf.init_state()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    metrics = []
    for s in range(10):
        state, m = sf.train_step(state, batch, sf.draws(1 + s))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    losses = [float(m["loss"]) for m in metrics]
    for name, n in launches.items():
        K[name].rec["launches_proposal_train"] = n
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": "proposals", "train_main_run": "10 train_steps on one "
          "batch, B=8, Sv 300, Sa 800", "launches": launches,
          "losses": losses, "params": n_params,
          "encoder_params_with_grad": len(enc)})
    if launches["flash_attention_tc"] != 8 * 10 or any(
            v for n, v in launches.items() if n != "flash_attention_tc"):
        raise AssertionError(f"proposal training launches {launches}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"proposal training loss did not fall: "
                             f"{losses}")

    def step():
        nonlocal state
        state, _ = sf.train_step(state, batch, sf.draws(7))

    ms, samples = step_ms(step)
    state, split = proposal_step_split(sf, state, batch, 8)
    flops, head_flops = proposal_forward_flops(model, batch)
    pms, psamples = step_ms(lambda: sf.predict(state, batch))
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("proposal_step"):
            step()
        torch.cuda.synchronize()
    (_, wall, busy, n), = span_busy(prof, "proposal_step")
    emit({"phase": "proposals", "what": "train step", "B": 8, "Sv": 300,
          "Sa": 800, "ms_per_step": ms, "samples": samples, "split": split,
          "heads_share_of_forward": split["heads_forward_ms"]
          / split["forward_ms"],
          "forward_gflop": flops / 1e9, "heads_forward_gflop_f32":
          head_flops / 1e9, "profiled_wall_ms": wall,
          "device_busy_ms": busy,
          "device_idle_share": (1.0 - busy / wall) if busy else None,
          "device_launches": n, "predict_ms_B8": pms,
          "predict_samples": psamples,
          "note": None if busy else "not measured: no device time traced"})
    del sf, state, model, batch
    torch.cuda.empty_cache()


def write_proposal_corpus(root, n=24, seed=0):
    """``n`` videos of 30-180 s as .npy files (I3D rgb/flow at one row per
    0.64 s, VGGish at one per 0.96 s: within the pads 300 and 800), the
    twelfth without feature files, 1-4 events each in a meta TSV. Returns
    (meta path, video dir, audio dir, {vid: duration})."""
    rng = np.random.RandomState(seed)
    vdir, adir = os.path.join(root, "i3d"), os.path.join(root, "vggish")
    os.makedirs(vdir)
    os.makedirs(adir)
    meta = os.path.join(root, "props.csv")
    durations = {}
    with open(meta, "w") as f:
        f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
        idx = 0
        for i in range(n):
            vid = f"p{i:02d}"
            dur = float(np.round(rng.uniform(30, 180), 2))
            durations[vid] = dur
            if i != 11:
                Tv, Ta = int(dur / 0.64), int(dur / 0.96)
                for kind in ("rgb", "flow"):
                    np.save(os.path.join(vdir, f"{vid}_{kind}.npy"),
                            rng.rand(Tv, 1024).astype(np.float32))
                np.save(os.path.join(adir, f"{vid}.npy"),
                        rng.rand(Ta, 128).astype(np.float32))
            for _ in range(rng.randint(1, 5)):
                s = float(np.round(rng.uniform(0, 0.8 * dur), 2))
                e = float(np.round(min(dur, s + rng.uniform(2, dur / 2)), 2))
                f.write(f"{vid}\tan event\t{s}\t{e}\t{dur}\ttrain\t{idx}\n")
                idx += 1
    return meta, vdir, adir, durations


def proposal_clis(K, serve_model):
    """``cli.train_proposals`` at the CLIs' widths on a written corpus (2
    epochs of at most 4 steps, launches counted), ``--emit_only`` on its
    checkpoint reproducing the best epoch's proposals; then
    ``cli.dense_caption`` over 16 of the videos with that checkpoint and
    the flagship captioner from a reference .pt (seed-0 weights,
    vocabulary 10172): the slice's main path (launches zeroed just before
    and read just after: every tensor-core kernel and both cells, no
    3xTF32 route), equal to a direct ``ProposalStepFactory.predict`` +
    ``postprocess`` + ``CaptionServer.caption`` with the serve phase's
    model (the same weights)."""
    import torch

    from bmhrl_tpu_torch.cli import dense_caption, train_proposals
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.proposal import ProposalDataset
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
    from bmhrl_tpu_torch.utils.checkpoint import (export_torch_bmhrl,
                                                  load_proposal_checkpoint)
    from bmhrl_tpu_torch.weights import random_jax_layout_params

    with tempfile.TemporaryDirectory() as root:
        meta, vdir, adir, durations = write_proposal_corpus(root)
        log_dir = os.path.join(root, "props_log")
        base = ["--train_meta_path", meta, "--val_meta_path", meta,
                "--video_features_path", vdir, "--audio_features_path", adir,
                "--device", "cuda"]
        t0 = time.perf_counter()
        f1, lines, launches = run_cli(train_proposals.main, base + [
            "--log_dir", log_dir, "--epochs", "2",
            "--max_steps_per_epoch", "4"])
        train_s = time.perf_counter() - t0
        for name, n in launches.items():
            K[name].rec["launches_train_proposals_cli"] = n
        emit({"phase": "proposals", "cli": "train_proposals",
              "wall_s": train_s, "best_val_F1": f1, "printed": lines,
              "launches": launches})
        if launches["flash_attention_tc"] <= 0 or any(
                v for n, v in launches.items() if n != "flash_attention_tc"):
            raise AssertionError(f"train_proposals launches {launches}")
        with open(os.path.join(log_dir, "learned_proposals.json")) as f:
            best = json.load(f)
        emit_dir = os.path.join(root, "emit")
        _, lines, _ = run_cli(train_proposals.main, base + [
            "--log_dir", emit_dir, "--emit_only", "--checkpoint_dir",
            log_dir])
        with open(os.path.join(emit_dir, "learned_proposals.json")) as f:
            again = json.load(f)
        emit({"phase": "proposals", "cli": "train_proposals --emit_only",
              "equal_to_best_epoch": again == best, "printed": lines[-1:],
              "segments": sum(len(v["timestamps"]) for v in best.values())})
        if again != best or not best:
            raise AssertionError("--emit_only did not reproduce the best "
                                 "epoch's proposals")

        # dense captioning over 16 videos (the one without features
        # included), the flagship captioner from a reference .pt
        vids = sorted(durations)[:16]
        dj = os.path.join(root, "videos.json")
        with open(dj, "w") as f:
            json.dump({v: durations[v] for v in vids}, f)
        tsv = os.path.join(root, "train.csv")
        write_train_tsv(tsv, VOC - 4)
        vocab = build_vocab_from_tsv(tsv)
        pt = os.path.join(root, "bm_hrl_agent.pt")
        export_torch_bmhrl(random_jax_layout_params(
            Config().agent_kwargs(VOC), 0), pt)
        out = os.path.join(root, "dense.json")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got, lines, launches = run_cli(dense_caption.main, [
            "--durations_json", dj, "--video_features_path", vdir,
            "--audio_features_path", adir, "--proposal_checkpoint", log_dir,
            "--train_meta_path", tsv, "--torch_checkpoint", pt,
            "--out", out, "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        summary = json.loads(lines[-1])
        with open(out) as f:
            written = json.load(f)
        for name, n in launches.items():
            K[name].rec["launches_dense_caption"] = n

        # the same two stages called directly
        anchors = np.load(os.path.join(log_dir, "anchors.npy"))
        vmeta = os.path.join(root, "videos.csv")
        with open(vmeta, "w") as f:
            f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
            for i, v in enumerate(vids):
                f.write(f"{v}\t-\t0.0\t{durations[v]}\t{durations[v]}\t"
                        f"infer\t{i}\n")
        ds = ProposalDataset(vmeta, vdir, adir)
        ds.anchors = anchors
        pmodel = MultimodalProposalGenerator(num_anchors=len(anchors),
                                             device="cuda")
        sf = ProposalStepFactory(pmodel, device="cuda")
        state = load_proposal_checkpoint(log_dir, pmodel, sf.init_state())
        reqs, confs = [], []
        for batch in ds.batches(0, 8, shuffle=False):
            per_vid = train_proposals.postprocess(
                sf.predict(state, batch).cpu().numpy(), batch["durations"],
                10, 0.5)
            for vid, rows in zip(batch["video_ids"], per_vid):
                for s, e, conf in rows:
                    reqs.append(ClipRequest(vid, float(s), float(e),
                                            durations[vid]))
                    confs.append(float(conf))
        del sf, state, pmodel
        cfg = Config().replace(video_features_path=vdir,
                               audio_features_path=adir)
        want, _ = CaptionServer(cfg, serve_model, vocab.itos,
                                device="cuda").caption(reqs, batch_size=256)
        seen = {}
        for r, conf in zip(reqs, confs):
            i = seen.get(r.video_id, 0)
            want["results"][r.video_id][i]["proposal_score"] = conf
            seen[r.video_id] = i + 1
        sents = [s["sentence"] for segs in written["results"].values()
                 for s in segs]
        emit({"phase": "proposals", "cli": "dense_caption",
              "main_path": True, "videos": len(vids), "wall_s": cli_s,
              "summary": summary, "launches": launches,
              "answered": len(sents), "requests_direct": len(reqs),
              "equal_to_direct_path": written == want == got,
              "example": [s for segs in written["results"].values()
                          for s in segs][:2]})
        if written != want or got != written or len(sents) != len(reqs) \
                or not all(sents) or set(written["results"]) != set(vids):
            raise AssertionError("dense_caption differs from the direct "
                                 "predict + postprocess + CaptionServer")
        check_serve_launches("dense_caption", launches)


def phase_proposals(K, serve_model):
    """The proposal path: small f32 card vs CPU, flash at its shapes, the
    full-width training main run and timings, the two CLIs (dense_caption
    is the slice's main path)."""
    small_proposals_card_vs_cpu()
    proposal_flash_times(K)
    proposal_flagship_train(K)
    proposal_clis(K, serve_model)


def bundle_vs_live(K, model, cfg, itos, reqs, bs, what, key, beam_width=1,
                   length_penalty=0.0, turns=0, keep=None):
    """Export ``model``'s decode for the shapes ``reqs`` plan at ``bs``
    (``serve_export.export_decode_bundle``), load it and serve ``reqs``
    from it and from the live CaptionServer (both with fixed batch shapes:
    tails row-padded to ``bs``), each serve a main path with its launches
    counted (the bundle's go to the ``kernels`` line as
    ``launches_bundle_<key>``). Gates: the same submission, the same
    launches per kernel route, no 3xTF32 route, and every tensor-core
    kernel launched (both cells too, except for the DETR, which has none
    on its default path). With ``turns``, clips/s of both servers taking
    turns (median) and their ratio. ``keep``: the directory to export into
    and keep (else a temporary one, removed once loaded). Returns the
    bundle's server, its submission and its launches."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.serve import CaptionServer, plan_batches
    from bmhrl_tpu_torch.serve_export import (ExportedCaptionServer,
                                              export_decode_bundle)

    root = keep or tempfile.mkdtemp()
    try:
        shapes = sorted({(bs, vb, ab) for _, vb, ab in plan_batches(
            reqs, cfg, bs)})
        t0 = time.perf_counter()
        manifest = export_decode_bundle(cfg, model, itos, shapes, root,
                                        beam_width=beam_width,
                                        length_penalty=length_penalty)
        export_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(root, f))
                 for f in sorted(os.listdir(root))}
        server = ExportedCaptionServer(root, cfg.video_features_path,
                                       cfg.audio_features_path, "cuda")
    finally:
        if keep is None:
            shutil.rmtree(root)
    live = CaptionServer(cfg, model, itos, device="cuda",
                         beam_width=beam_width,
                         length_penalty=length_penalty)
    live._fixed_batch = True
    runs = {}
    for name, srv in (("live", live), ("bundle", server)):
        srv.caption(reqs[:3], batch_size=bs)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        pred, stats = srv.caption(reqs, batch_size=bs)
        torch.cuda.synchronize()
        runs[name] = (pred, stats, dict(_cuda.LAUNCHES))
    rates = {"live": [], "bundle": []}
    for _ in range(turns):
        for name, srv in (("live", live), ("bundle", server)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            srv.caption(reqs, batch_size=bs)
            torch.cuda.synchronize()
            rates[name].append(len(reqs) / (time.perf_counter() - t))
    (want, _, l_live), (got, stats, l_bundle) = runs["live"], runs["bundle"]
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    rate = {k: statistics.median(v) if turns else None
            for k, v in rates.items()}
    emit({"phase": "export", "what": what, "B": bs,
          "beam_width": beam_width, "shapes": manifest["shapes"],
          "export_s": export_s, "export_s_per_program": manifest["export_s"],
          "bytes": files, "params_npz_bytes": files["params.npz"],
          "programs_bytes": sum(v for f, v in files.items()
                                if f.endswith(".pt2")),
          "load_s": server.load_s, "weight_inputs": {
              k: len(v["weights"]) for k, v in manifest["programs"].items()},
          "state": manifest["state"], "answered": len(sents),
          "equal_to_live": got == want, "launches_bundle": l_bundle,
          "launches_live": l_live, "stats": stats.summary(),
          "clips_per_s_bundle": rate["bundle"],
          "clips_per_s_live": rate["live"],
          "bundle_over_live": rate["bundle"] / rate["live"]
          if turns else None, "samples": rates, "example": sents[:3]})
    if len(sents) != len(reqs) or not all(sents) or got != want:
        raise AssertionError(f"{what}: bundle answered {len(sents)}, equal "
                             f"to live {got == want}")
    if l_bundle != l_live:
        raise AssertionError(f"{what}: launches {l_bundle} != live "
                             f"{l_live}")
    # the routes a family's decode never takes: the 3xTF32 ones; the
    # DETR's default path has no cells, its pre-goal path (full buffer)
    # no folded attention
    idle = {"flash_attention_simt", "folded_attend_simt"}
    if cfg.mode == "DETR":
        idle |= ({"folded_attend_tc"} if cfg.pre_goal_attention
                 else {"lstm_cell", "gru_cell"})
    bad = {n: v for n, v in l_bundle.items() if (v <= 0) != (n in idle)}
    if bad:
        raise AssertionError(f"{what} launches: {l_bundle}")
    for name, n in l_bundle.items():
        K[name].rec[f"launches_bundle_{key}"] = n
    return server, got, l_bundle


def phase_export(K, model, keep_root):
    """AOT serving bundles (``serve_export``) on the card: the four kernel
    ops pass ``torch.library.opcheck`` with CUDA tensors at serving shapes;
    the flagship (``model``: the serve phase's, seed-0 weights) exported
    greedy and beam W=4 for the 64 requests at B=32 and served from the
    bundle against the live CaptionServer in this call (``bundle_vs_live``:
    the same submissions and launches), greedy clips/s of both taking
    turns (the bundle's dynamic row axis and its extra head program a
    token are in its time); the bundle's loop syncs the host once per
    token; AHRL and DETR bundles on 8 requests; a JAX bundle is refused.
    The two flagship bundles stay under ``keep_root`` for the mesh phase:
    returns {"greedy"/"beam4": (dir, submission, launches)}."""
    import torch

    from bmhrl_tpu_torch.cli.serve_captions import load_captioner
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.ops import critic_kernels as ck
    from bmhrl_tpu_torch import serve_export

    # opcheck at serving shapes: flash on q/k/v views of one merged
    # projection (B=32, 128 rows, 4 heads of 256, bf16), folded at the
    # video call of one layer's step (B=32, G=8, S=128, draw 1024), the
    # cells at B=32
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    qkv = rnd(32, 128, 3072, dtype=torch.bfloat16)
    mask = (torch.rand(32, 128, generator=g, device="cuda") > 0.2).int()
    lstm = ck.pack_lstm(rnd(2400, 300), rnd(2400, 600), rnd(2400))
    gru = ck.pack_gru(rnd(1800, 600), rnd(1800, 600), rnd(1800), rnd(1800))
    cases = {
        "flash_attention_bsd": (*qkv.split(1024, dim=-1), mask, 4, False),
        "folded_attend": (rnd(32, 8, 1024),
                          rnd(32, 128, 1024, dtype=torch.bfloat16), mask,
                          1 / 16),
        "lstm_cell_packed": (rnd(32, 300), rnd(32, 600), rnd(32, 600),
                             lstm.w, lstm.b, lstm.K, lstm.H),
        "gru_cell_packed": (rnd(32, 600), rnd(32, 600), gru.w, gru.b, gru.K,
                            gru.H)}
    for op, args in cases.items():
        result = torch.library.opcheck(getattr(torch.ops.bmhrl, op).default,
                                       args)
        emit({"phase": "export", "opcheck": op, "result": result})
        if set(result.values()) != {"SUCCESS"}:
            raise AssertionError(f"opcheck {op}: {result}")

    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]
    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        cfg = Config().replace(video_features_path=vdir,
                               audio_features_path=adir)
        kept = {}
        for name, W, lp, turns in (("greedy", 1, 0.0, 3),
                                   ("beam4", 4, 1.0, 0)):
            out = os.path.join(keep_root, name)
            os.makedirs(out)
            server, pred, launches = bundle_vs_live(
                K, model, cfg, itos, reqs, 32, f"BMHRL {name}",
                "serve" if W == 1 else "beam", beam_width=W,
                length_penalty=lp, turns=turns, keep=out)
            kept[name] = (out, pred, launches)
            if W == 1:
                greedy = server

        # one host sync per token in the bundle's loop (it never stops
        # early with EOS out of reach)
        feats = make_feats(32, 128, 256, 1024, 128, "cuda", seed=32)

        def run(n):
            greedy.cfg = cfg.replace(max_len=n)
            with mock.patch.object(serve_export, "EOS", -1):
                greedy._decode(feats, None)

        per_token, where = syncs_per_token(run)
        greedy.cfg = cfg
        emit({"phase": "export", "bundle_syncs_per_token": per_token,
              "where": where})
        if per_token != 1:
            raise AssertionError(f"bundle loop: {per_token} syncs per "
                                 f"token ({where})")

        # 8 requests of one bucket pair (128, 256): one shape each; the
        # DETR's pre-goal path exports its full-buffer loop
        for mode, pre_goal, key in (("AHRL", False, "ahrl"),
                                    ("DETR", False, "detr"),
                                    ("DETR", True, "detr_pre_goal")):
            mcfg = cfg.replace(mode=mode, pre_goal_attention=pre_goal)
            m = load_captioner(mcfg, VOC, None, "cuda")
            bundle_vs_live(K, m, mcfg, itos, reqs[8:16], 8,
                           f"{key} greedy", key)
            del m
            torch.cuda.empty_cache()

        # a JAX bundle (jax.export blobs) is refused
        jdir = os.path.join(root, "jax_bundle")
        os.makedirs(jdir)
        with open(os.path.join(jdir, "bundle.json"), "w") as f:
            json.dump({"shapes": [[32, 128, 256]], "platforms": ["tpu"]}, f)
        with open(os.path.join(jdir, "decode_B32xV128xA256.bin"), "wb") as f:
            f.write(b"\0")
        try:
            serve_export.ExportedCaptionServer(jdir, vdir, adir, "cuda")
        except serve_export.BundleError as e:
            emit({"phase": "export", "jax_bundle_refused": str(e)})
        else:
            raise AssertionError("a JAX bundle was not refused")
    return kept


# --------------------------------------------------------------------------
def write_small_requests(root):
    """Three requests for the small model (128 video and 160 audio frames
    of width 128: one bucket pair); served at batch 2 they end in a tail
    of 1."""
    from bmhrl_tpu_torch.serve import ClipRequest

    rng = np.random.RandomState(9)
    vdir, adir = os.path.join(root, "i3d"), os.path.join(root, "vggish")
    os.makedirs(vdir)
    os.makedirs(adir)
    for i in range(3):
        for kind in ("rgb", "flow"):
            np.save(os.path.join(vdir, f"s{i}_{kind}.npy"),
                    rng.rand(128, 128).astype(np.float32))
        np.save(os.path.join(adir, f"s{i}.npy"),
                rng.rand(160, 128).astype(np.float32))
    return vdir, adir, [ClipRequest(f"s{i}", 0.0, 10.0, 10.0)
                        for i in range(3)]


def mesh_small_run(mesh, device, small):
    """The small f32 model's sequence on ``mesh`` (None: one process) on
    ``device``, each rank on its rows of the global batches: two warmstart
    steps, a value step, an RL worker and an RL manager step (a batch of
    4), greedy and beam W=2 decodes (8 clips, a zero-feature row), and
    ``small``'s three requests served at batch 2 (the tail of 1 padded to
    2). Then the collectives of one warmstart step and of one 30-token
    decode. Returns losses, tokens (global), the submission and the
    parameters, on the host."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib
    from bmhrl_tpu_torch.serve import CaptionServer
    from bmhrl_tpu_torch.train.decode import beam_decode, decode

    def rows(x):
        return x if mesh is None else x[mesh.rows(x.shape[0])]

    def back(t):
        return mesh_lib.gather_rows(t, mesh).cpu()

    sf, state = build_trainer(dict(SMALL, dtype=torch.float32), device,
                              seed=3)
    for net in (sf.model, sf.wv_model, sf.mv_model):
        mesh_lib.replicate(net, mesh)
    sf.mesh = mesh
    batch = {k: rows(v) for k, v in make_train_batch(
        4, 128, 160, Lc=8, voc=SMALL["voc_size"], d_v=128, d_a=128,
        device=device, seed=3).items()}
    score = rows(torch.from_numpy(np.random.RandomState(5).rand(4, 8)
                                  .astype(np.float32)).to(device))
    out = {"losses": []}
    for s in range(2):
        state, m, aux = sf.warmstart_step(state, batch, s, 1e-4)
        out["losses"].append(float(m["loss"]))
    state, vm = sf.value_warmstart_step(state, aux["wf"], aux["mf"], score,
                                        score, aux["token_mask"], aux["seg"])
    out["losses"] += [float(vm["wv_loss"]), float(vm["mv_loss"])]
    out["seg"] = back(aux["seg"])
    for tw in (True, False):
        roll = sf.rl_rollout(state, batch, 10 + tw, tw)
        out[f"sampled_{'worker' if tw else 'manager'}"] = back(
            roll["sampled"])
        state, m = sf.rl_update(state, batch, 10 + tw, 1e-4, roll, score,
                                tw)
        out["losses"] += [float(m["loss"]), float(m["value_loss"])]
    out["params"] = {f"{tag}.{n}": p.detach().cpu() for tag, mod in (
        ("cap", sf.model), ("wv", sf.wv_model), ("mv", sf.mv_model))
        for n, p in mod.named_parameters()}
    model = sf.model
    feats = make_feats(8, 128, 160, 128, 128, device, seed=3)
    feats["audio"][2, 90:] = 0.0     # ragged audio
    feats["rgb"][5] = 0.0            # a zero-feature (fully masked) row
    feats = {k: rows(v) for k, v in feats.items()}
    masks = make_masks(feats)
    with torch.no_grad():
        out["greedy"] = back(decode(model, feats, masks, 12, 2, 3, 1)[0])
        out["beam2"] = back(beam_decode(model, feats, masks, 12, 2, 3, 1,
                                        beam_width=2)[0])
    vdir, adir, reqs = small
    cfg = Config(video_features_path=vdir, audio_features_path=adir,
                 d_vid=128, d_aud=128, video_buckets=(128,),
                 audio_buckets=(160,), pad_video_feats_up_to=128,
                 pad_audio_feats_up_to=160, max_len=12)
    itos = SPECIALS + [f"w{i}" for i in range(SMALL["voc_size"] - 4)]
    server = CaptionServer(cfg, model, itos, device=device, mesh=mesh)
    server._fixed_batch = mesh is None  # one process: the tail padded to 2
    out["served"], stats = server.caption(reqs, batch_size=2)
    out["padded_rows"] = stats.padded_rows
    # the collectives of one training step and of one decode token
    mesh_lib.reset_collectives()
    sf.warmstart_step(state, batch, 7, 1e-4)
    out["collectives_per_warmstart_step"] = dict(mesh_lib.COLLECTIVES)
    mesh_lib.reset_collectives()
    with torch.no_grad():
        decode(model, feats, masks, 30, 2, -1, 1)
    out["all_reduce_per_token"] = mesh_lib.COLLECTIVES["all_reduce"] / 30
    return out


def forced_steps(model, feats, masks, tokens, want=None):
    """The kernel path's argmax at each step of the fast loop fed
    ``tokens`` (B, L) (the caller's rows, its model's mesh) and, where it
    differs from ``want`` (B, L-1), the largest log-prob gap between its
    choice and want's per row (0 elsewhere)."""
    import torch

    B, L = tokens.shape
    with torch.no_grad():
        mem = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                           masks)
        caches, valid, step = model.fast_setup(*mem, masks, B, L)
        args, gaps = [], torch.zeros(B, device=tokens.device)
        positions = torch.arange(L, device=tokens.device)
        for t in range(L - 1):
            tok_t = tokens[:, t]
            valid[:, t] = tok_t != 1
            valid[:, 0] = True
            logp, caches = step(tok_t, positions[t], caches, valid)
            a = logp.argmax(-1)
            args.append(a)
            if want is not None:
                gap = (logp.gather(1, a[:, None])
                       - logp.gather(1, want[:, t, None]))[:, 0]
                gaps = torch.maximum(gaps, gap)
    return torch.stack(args, 1), gaps


def mesh_flagship_serve(mesh, device, vdir, adir, reqs, model=None,
                        batch_size=32):
    """The flagship (seed-0 weights, bf16) serving ``reqs`` greedily at
    ``batch_size`` (global) on ``mesh`` (None: one process). Returns the
    submission."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.serve import CaptionServer

    cfg = Config().replace(video_features_path=vdir,
                           audio_features_path=adir)
    if model is None:
        model = build_model(cfg.agent_kwargs(VOC), device)
    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]
    server = CaptionServer(cfg, model, itos, device=device, mesh=mesh)
    return server.caption(reqs, batch_size=batch_size)[0]


def rig_serve(server, reqs, bs):
    """One counted serve of ``reqs`` at batch ``bs`` (after a warm-up on
    three of them): the submission, this rank's kernel launches, its
    all_reduce calls, the program calls of a bundle's server (None for a
    live one) and the seconds."""
    import torch

    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib

    server.caption(reqs[:3], batch_size=bs)
    calls0 = dict(getattr(server, "program_calls", {}))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    mesh_lib.reset_collectives()
    t0 = time.perf_counter()
    pred = server.caption(reqs, batch_size=bs)[0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    calls = ({k: v - calls0[k] for k, v in server.program_calls.items()}
             if calls0 else None)
    return {"pred": pred, "launches": dict(_cuda.LAUNCHES),
            "all_reduce": mesh_lib.COLLECTIVES["all_reduce"],
            "program_calls": calls, "seconds": secs}


def bundle_rank_serve(mesh, bundle_dir, vdir, adir, reqs, bs):
    """``rig_serve`` of the bundle in ``bundle_dir`` on this rank
    (``ExportedCaptionServer(mesh=...)``), with every rank's load
    seconds."""
    import torch

    from bmhrl_tpu_torch.parallel import mesh as mesh_lib
    from bmhrl_tpu_torch.serve_export import ExportedCaptionServer

    server = ExportedCaptionServer(bundle_dir, vdir, adir,
                                   device=mesh.device, mesh=mesh)
    out = rig_serve(server, reqs, bs)
    out["load_s"] = mesh_lib.gather_rows(torch.tensor(
        [server.load_s], device=mesh.device), mesh).tolist()
    out["backend"] = mesh.backend
    return out


def mesh_rank(mesh, small, vdir, adir, reqs, tokens, want, bundles,
              small_bundle):
    """One of the two gloo ranks sharing the card: the small f32 sequence
    and the flagship's serve, with this rank's kernel launches, then the
    flagship's steps fed one process's greedy ``tokens`` (``forced_steps``
    on this rank's rows of the 64-clip batch); then the export phase's
    flagship bundles (``bundles``: {"greedy"/"beam4": dir}) and the live
    server with the same fixed batch shapes, each through ``rig_serve``,
    and the small f32 model's bundle on ``small``'s requests at batch 2
    (one row a rank)."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib
    from bmhrl_tpu_torch.serve import CaptionServer

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = {"small": mesh_small_run(mesh, mesh.device, small)}
    out["small_s"] = time.perf_counter() - t0
    model = build_model(Config().agent_kwargs(VOC), mesh.device)
    t0 = time.perf_counter()
    _cuda.reset_launches()
    mesh_lib.reset_collectives()
    out["flagship"] = mesh_flagship_serve(mesh, mesh.device, vdir, adir,
                                          reqs, model)
    torch.cuda.synchronize()
    out["flagship_s"] = time.perf_counter() - t0
    out["flagship_launches"] = dict(_cuda.LAUNCHES)
    out["flagship_collectives"] = dict(mesh_lib.COLLECTIVES)
    cfg = Config().replace(video_features_path=vdir, audio_features_path=adir)
    itos = SPECIALS + [f"w{i}" for i in range(VOC - 4)]
    for name, W, lp in (("greedy", 1, 0.0), ("beam4", 4, 1.0)):
        live = CaptionServer(cfg, model, itos, device=mesh.device,
                             beam_width=W, length_penalty=lp, mesh=mesh)
        live._fixed_batch = True
        out[f"live_{name}"] = rig_serve(live, reqs, 32)
        out[f"bundle_{name}"] = bundle_rank_serve(mesh, bundles[name], vdir,
                                                  adir, reqs, 32)
    out["small_bundle"] = bundle_rank_serve(mesh, small_bundle, *small, 2)
    mesh_lib.replicate(model, mesh)
    rows = mesh.rows(tokens.shape[0])
    feats = {k: v[rows] for k, v in make_feats(64, 128, 256, 1024, 128,
                                                mesh.device, seed=7).items()}
    args, gaps = forced_steps(model, feats, make_masks(feats),
                              tokens[rows].to(mesh.device),
                              want[rows].to(mesh.device))
    out["forced_args"] = mesh_lib.gather_rows(args, mesh).cpu()
    out["forced_gaps"] = mesh_lib.gather_rows(gaps, mesh).cpu()
    return out


def sentences(pred):
    return [s["sentence"] for segs in pred["results"].values() for s in segs]


def mesh_world_of_one(K, model, paths):
    """A world of 1 over NCCL through the production path: ``train_rl_cap``
    (B=16, a warmstart and a worker epoch of 4 steps) and the flagship's
    greedy ``CaptionServer`` on the 64 requests at B=32, each with and
    without the mesh in turns of both orders: bit-equal losses and
    parameters, identical
    submissions, one host sync per token; their ms/step and clips/s, the
    collectives per step and per token; the mesh runs' launches are data
    parallelism's main paths."""
    import torch

    from bmhrl_tpu_torch.data.vocab import BOS, PAD
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib
    from bmhrl_tpu_torch.train.decode import decode
    from bmhrl_tpu_torch.train.loop import train_rl_cap

    mesh = mesh_lib.make_mesh((1, 1), "cuda")
    if mesh.backend != "nccl" or mesh.world != 1:
        raise AssertionError(f"a world of 1 over NCCL: {mesh.backend}, "
                             f"{mesh.world}")
    cfg = loop_config(paths, epoch_num=3, rl_warmstart_epochs=1,
                      one_by_one_starts_at=3)
    runs = {}
    # turns in both orders (plain, mesh, mesh, plain)
    for name, m in (("plain", None), ("mesh", mesh), ("mesh", mesh),
                    ("plain", None)):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        mesh_lib.reset_collectives()
        t0 = time.perf_counter()
        out = train_rl_cap(cfg, max_steps_per_epoch=4, device="cuda",
                           mesh=m)
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0,
               "launches": dict(_cuda.LAUNCHES),
               "collectives": dict(mesh_lib.COLLECTIVES),
               "losses": [x for r in out["epochs"] for x in r["step_losses"]],
               "ms_per_step": {r["phase"]: r["timer"]["step"]["p50_ms"]
                               for r in out["epochs"]},
               "steps": sum(r["steps"] for r in out["epochs"]),
               "tensors": params_and_state(out["step_factory"],
                                           out["state"])}
        runs.setdefault(name, []).append(rec)
        del out
    for name in ("plain", "mesh"):
        a, b = runs[name]
        emit({"phase": "mesh", "rig": "world of 1 (nccl)", "what": "train",
              "run": name, "seconds": [a["seconds"], b["seconds"]],
              "ms_per_step": [a["ms_per_step"], b["ms_per_step"]],
              "steps": a["steps"], "collectives_per_step": {
                  k: v / a["steps"] for k, v in a["collectives"].items()},
              "launches": a["launches"], "losses": a["losses"]})
    plain, meshed = runs["plain"][0], runs["mesh"][0]
    if plain["losses"] != meshed["losses"]:
        raise AssertionError("world of 1: losses differ from no mesh")
    assert_same_tensors("world of 1, training", plain["tensors"],
                        meshed["tensors"])
    launches = meshed["launches"]
    for name, n in launches.items():
        K[name].rec["launches_mesh_train"] = n
    # the teacher-forced steps: flash and the critic's cells (no decode,
    # so no folded attention), no 3xTF32 route
    idle = {"flash_attention_simt", "folded_attend_simt", "folded_attend_tc"}
    if any((v <= 0) != (n in idle) for n, v in launches.items()):
        raise AssertionError(f"mesh training launches: {launches}")

    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        preds, rates = {}, {"plain": [], "mesh": []}
        for turn in range(2):  # each order once
            order = (("plain", None), ("mesh", mesh))
            for name, m in (order if turn % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                mesh_lib.reset_collectives()
                t0 = time.perf_counter()
                preds[name] = mesh_flagship_serve(m, "cuda", vdir, adir,
                                                  reqs, model)
                torch.cuda.synchronize()
                rates[name].append(len(reqs) / (time.perf_counter() - t0))
                if name == "mesh" and turn == 0:
                    serve_launches = dict(_cuda.LAUNCHES)
                    serve_collectives = dict(mesh_lib.COLLECTIVES)
        for name, n in serve_launches.items():
            K[name].rec["launches_mesh_serve"] = n
        check_serve_launches("mesh serving", serve_launches)
        mesh_lib.replicate(model, mesh)
        feats = make_feats(32, 128, 256, 1024, 128, "cuda", seed=32)
        masks = make_masks(feats)
        per_token, where = syncs_per_token(
            lambda n: decode(model, feats, masks, n, BOS, -1, PAD))
        mesh_lib.replicate(model, None)
    emit({"phase": "mesh", "rig": "world of 1 (nccl)", "what": "serve",
          "B": 32, "requests": len(reqs),
          "identical_submissions": preds["mesh"] == preds["plain"],
          "clips_per_s": {k: statistics.median(v) for k, v in rates.items()},
          "samples": rates, "syncs_per_token": per_token, "where": where,
          "collectives": serve_collectives, "launches": serve_launches})
    if preds["mesh"] != preds["plain"]:
        raise AssertionError("world of 1: the submission differs")
    if per_token != 1:
        raise AssertionError(f"mesh decode: {per_token} syncs per token")
    mesh_nccl_methods(mesh, sum(p.numel() for p in model.parameters()))
    mesh_lib.close()


def host_syncs(fn):
    """(fn(), the device syncs ``torch.cuda.set_sync_debug_mode`` reports
    while it runs)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def mesh_nccl_methods(mesh, n_params):
    """Every collective of ``parallel.mesh.Mesh`` called directly over NCCL
    on CUDA tensors of the kinds the helpers exchange (the helpers skip
    them at a world of 1): the all_reduce of the rank flags (int32, no host
    sync), of the decode's unfinished rows (int32, read back: one sync), of
    the flat gradients (f32, ``n_params``: the flagship's), of the nan-mean's
    sum and count and of gathered token rows (int64); a broadcast of a
    bf16 and an f32 tensor, an object broadcast and the barrier. At a world
    of 1 each result is its input; each call is counted once."""
    import torch

    from bmhrl_tpu_torch.parallel import mesh as mesh_lib

    g = torch.Generator("cuda").manual_seed(11)
    grads = torch.randn(n_params, device="cuda", generator=g)
    toks = torch.randint(0, VOC, (32, 30), device="cuda", generator=g)
    stats = torch.stack([grads[:100].sum(), torch.tensor(100.0,
                                                         device="cuda")])
    flag = torch.zeros(16, dtype=torch.bool, device="cuda")
    flag[3] = True
    done = torch.ones(16, dtype=torch.bool, device="cuda")
    done[5] = False
    mesh_lib.reset_collectives()
    ok, syncs = {}, {}
    ranks, syncs["rank_flags"] = host_syncs(
        lambda: mesh_lib.rank_flags(flag, mesh))
    ok["rank_flags"] = ranks.tolist() == [1]
    left, syncs["unfinished_rows"] = host_syncs(lambda: int(mesh.all_reduce(
        (~done).sum().to(torch.int32).reshape(1))))
    ok["unfinished_rows"] = left == 1
    for name, t in (("grads", grads), ("nanmean_stats", stats),
                    ("token_rows", toks)):
        got, syncs[name] = host_syncs(lambda: mesh.all_reduce(t.clone()))
        ok[name] = bool(torch.equal(got, t))
    for name, t in (("broadcast_bf16", grads[:4096].bfloat16()),
                    ("broadcast_f32", grads[:4096])):
        got, syncs[name] = host_syncs(lambda: mesh.broadcast(t.clone()))
        ok[name] = bool(torch.equal(got, t))
    obj = {"err": "", "rows": [1, 2]}
    ok["broadcast_object"] = mesh.broadcast_object(obj) == obj
    mesh.barrier()
    counted = dict(mesh_lib.COLLECTIVES)
    ok["counted"] = counted == {"all_reduce": 5, "broadcast": 3,
                                "barrier": 1}
    emit({"phase": "mesh", "rig": "world of 1 (nccl)",
          "what": "Mesh collectives called directly", "ok": ok,
          "host_syncs": syncs, "collectives": counted,
          "grads_numel": grads.numel()})
    if not all(ok.values()) or syncs["rank_flags"] != 0 \
            or syncs["unfinished_rows"] != 1:
        raise AssertionError(f"NCCL collectives: {ok}, syncs {syncs}")


def small_bundle(root, small):
    """The small f32 model (seed 3) exported greedily for ``small``'s
    requests at batch 2 into ``root`` and served from there in this
    process: (dir, submission)."""
    import torch

    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.serve_export import (ExportedCaptionServer,
                                              export_decode_bundle)

    vdir, adir, reqs = small
    cfg = Config(video_features_path=vdir, audio_features_path=adir,
                 d_vid=128, d_aud=128, video_buckets=(128,),
                 audio_buckets=(160,), pad_video_feats_up_to=128,
                 pad_audio_feats_up_to=160, max_len=12)
    model = build_model(dict(SMALL, dtype=torch.float32), "cuda", seed=3)
    itos = SPECIALS + [f"w{i}" for i in range(SMALL["voc_size"] - 4)]
    export_decode_bundle(cfg, model, itos, [(2, 128, 160)], root)
    pred = ExportedCaptionServer(root, vdir, adir, "cuda").caption(
        reqs, batch_size=2)[0]
    return root, pred


def mesh_bundle_world_of_one(K, bundles):
    """The export phase's greedy flagship bundle served by a world of 1
    over NCCL started as the CLI starts ranks (``spawn(world=1)``): its
    submission bit-equal to the same bundle's without a mesh, with equal
    launches per kernel route (the ``kernels`` line's
    ``launches_bundle_mesh_serve``)."""
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib

    bundle_dir, want, want_launches = bundles["greedy"]
    with tempfile.TemporaryDirectory() as root:
        vdir, adir, reqs = write_requests(root)
        t0 = time.perf_counter()
        got = mesh_lib.spawn(bundle_rank_serve, 1, "cuda",
                             args=(bundle_dir, vdir, adir, reqs, 32))
        spawn_s = time.perf_counter() - t0
    emit({"phase": "mesh", "rig": "world of 1 (nccl)", "what":
          "greedy bundle (spawned rank)", "backend": got["backend"],
          "identical_to_no_mesh_bundle": got["pred"] == want,
          "launches": got["launches"], "launches_no_mesh": want_launches,
          "all_reduce": got["all_reduce"],
          "program_calls": got["program_calls"], "load_s": got["load_s"],
          "clips_per_s": len(reqs) / got["seconds"],
          "seconds": {"spawn_total": spawn_s, "serve": got["seconds"]}})
    if got["backend"] != "nccl" or got["pred"] != want:
        raise AssertionError("bundle on a world of 1: the submission "
                             "differs from no mesh's")
    if got["launches"] != want_launches:
        raise AssertionError(f"bundle on a world of 1: launches "
                             f"{got['launches']} != {want_launches}")
    for name, n in got["launches"].items():
        K[name].rec["launches_bundle_mesh_serve"] = n


def mesh_two_gloo_ranks(model, bundles):
    """Two gloo ranks sharing cuda:0 (``spawn(devices=["cuda:0"] * 2,
    backend="gloo")``, the rig's choice: NCCL refuses two ranks on one
    card) against one process on the card: the small f32 sequence (tokens
    identical, losses and parameters within 1e-5, the served tail of 1
    padded to 2) and the bf16 flagship. Its free-running captions of the
    64 requests are compared (the share of identical ones, printed: one
    bf16 near-tie flips the rest of a caption, and each rank decodes half
    the rows, other GEMM shapes), and its steps fed one process's greedy
    tokens of a 64-clip batch must choose that process's token at >= 95%
    of the steps (the repo's bf16 agreement measure). The witness: one
    process serving at the ranks' 16 rows a batch; the ranks' identical
    share may fall at most 0.1 below its share against 32 rows. Then the
    export phase's greedy and beam W=4 bundles (``bundles``) on the ranks
    (16 rows a rank): captions identical to the live server's on the same
    ranks with the same batch shapes, the same launches per route on rank
    0 and the same all-reduces; and the small f32 bundle on the ranks (one
    row a rank) gives its one-process submission."""
    import torch

    from bmhrl_tpu_torch.data.vocab import BOS, PAD
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.parallel import mesh as mesh_lib
    from bmhrl_tpu_torch.train.decode import decode

    with tempfile.TemporaryDirectory() as root:
        small = write_small_requests(os.path.join(root, "small"))
        vdir, adir, reqs = write_requests(os.path.join(root, "flagship"))
        small_dir, small_pred = small_bundle(os.path.join(root, "bundle"),
                                             small)
        one = mesh_small_run(None, "cuda", small)
        want = mesh_flagship_serve(None, "cuda", vdir, adir, reqs, model)
        # the witness: one process at the ranks' 16 rows a batch
        want16 = mesh_flagship_serve(None, "cuda", vdir, adir, reqs, model,
                                     batch_size=16)
        feats = make_feats(64, 128, 256, 1024, 128, "cuda", seed=7)
        masks = make_masks(feats)
        tokens = decode(model, feats, masks, 30, BOS, -1, PAD)[0]
        want_args, _ = forced_steps(model, feats, masks, tokens)
        t0 = time.perf_counter()
        two = mesh_lib.spawn(mesh_rank, 2, "cuda", backend="gloo",
                             devices=["cuda:0", "cuda:0"],
                             args=(small, vdir, adir, reqs, tokens.cpu(),
                                   want_args.cpu(),
                                   {k: v[0] for k, v in bundles.items()},
                                   small_dir))
        spawn_s = time.perf_counter() - t0
    got = two["small"]
    same = {k: bool(torch.equal(got[k], one[k]))
            for k in ("seg", "sampled_worker", "sampled_manager", "greedy",
                      "beam2")}
    same["served"] = got["served"] == one["served"]
    loss_err = float(np.max(np.abs(np.array(got["losses"])
                                   - np.array(one["losses"]))
                            / np.abs(np.array(one["losses"]))))
    param_err = max(float((got["params"][n] - p).abs().max())
                    for n, p in one["params"].items())
    a, b, c = (sentences(p) for p in (two["flagship"], want, want16))

    def same_share(x, y):
        return sum(u == v for u, v in zip(x, y)) / len(y)

    share, share16, ranks_vs16 = same_share(a, b), same_share(c, b), \
        same_share(a, c)
    agree = two["forced_args"] == want_args.cpu()
    forced = float(agree.float().mean())
    regret = float(two["forced_gaps"].max())
    emit({"phase": "mesh", "rig": "2 gloo ranks on cuda:0",
          "small_identical": same, "loss_rel_err": loss_err,
          "loss_tol": 1e-5, "param_max_abs_err": param_err,
          "param_tol": 1e-5, "padded_rows": got["padded_rows"],
          "collectives_per_warmstart_step":
              got["collectives_per_warmstart_step"],
          "all_reduce_per_token": got["all_reduce_per_token"],
          "flagship_identical_captions_share": share,
          "one_process_B16_vs_B32_identical_share": share16,
          "ranks_vs_one_process_B16_identical_share": ranks_vs16,
          "flagship_forced_step_agreement": forced, "min_required": 0.95,
          "max_logprob_gap_where_they_differ": regret,
          "flagship_collectives": two["flagship_collectives"],
          "flagship_launches_rank0": two["flagship_launches"],
          "seconds": {"spawn_total": spawn_s, "small": two["small_s"],
                      "flagship": two["flagship_s"]}})
    if not all(same.values()) or got["padded_rows"] != 1:
        raise AssertionError(f"2 ranks vs one process: {same}")
    if not loss_err <= 1e-5 or not param_err <= 1e-5:
        raise AssertionError(f"2 ranks: losses {loss_err}, params "
                             f"{param_err}")
    if len(a) != len(b) or not all(a) or forced < 0.95:
        raise AssertionError(f"2 ranks, flagship: {len(a)} captions, "
                             f"forced agreement {forced}")
    # the flips must be those of the ranks' 16-row shapes: one process at
    # 16 rows a batch flips as many against 32 (within 6 of 64 captions)
    if share < share16 - 0.1:
        raise AssertionError(f"2 ranks, flagship: identical share {share} "
                             f"against one process at 16 rows' {share16}")
    check_serve_launches("2 ranks, flagship", two["flagship_launches"])
    bundles_on_two_gloo_ranks(two, small_pred, len(reqs))


def bundles_on_two_gloo_ranks(two, small_pred, n_reqs):
    """The gates and the line of the bundles served on the two gloo ranks
    (``mesh_rank``): each flagship bundle against the live server on the
    same ranks, and the small f32 bundle against its one process. The
    rig's clips/s are two processes on one card: no speed of data
    parallelism."""
    for name in ("greedy", "beam4"):
        live, bundle = two[f"live_{name}"], two[f"bundle_{name}"]
        tokens = bundle["program_calls"].get("head", 0)
        emit({"phase": "mesh", "rig": "2 gloo ranks on cuda:0",
              "what": f"flagship {name} bundle vs live", "rows_a_rank": 16,
              "identical_captions": bundle["pred"] == live["pred"],
              "launches_rank0": bundle["launches"],
              "launches_rank0_live": live["launches"],
              "all_reduce": bundle["all_reduce"],
              "all_reduce_live": live["all_reduce"],
              "all_reduce_per_token": bundle["all_reduce"] / tokens,
              "program_calls": bundle["program_calls"],
              "program_calls_per_token": sum(
                  v for k, v in bundle["program_calls"].items()
                  if k != "setup") / tokens,
              "load_s_per_rank": bundle["load_s"],
              "clips_per_s_rig": {"bundle": n_reqs / bundle["seconds"],
                                  "live": n_reqs / live["seconds"]}})
        if bundle["pred"] != live["pred"]:
            raise AssertionError(f"2 ranks, {name} bundle: captions differ "
                                 "from the live server's")
        if (bundle["launches"] != live["launches"]
                or bundle["all_reduce"] != live["all_reduce"]):
            raise AssertionError(f"2 ranks, {name} bundle: launches or "
                                 "all-reduces differ from live")
    got = two["small_bundle"]
    emit({"phase": "mesh", "rig": "2 gloo ranks on cuda:0",
          "what": "small f32 bundle (1 row a rank) vs one process",
          "identical": got["pred"] == small_pred,
          "program_calls": got["program_calls"], "load_s": got["load_s"]})
    if got["pred"] != small_pred:
        raise AssertionError("2 ranks, small f32 bundle: the submission "
                             "differs from one process's")


def phase_mesh(K, model, paths, bundles):
    """Data parallelism (``parallel.mesh``) on the one card: a world of 1
    over NCCL through the production path, for the live model and for the
    export phase's greedy bundle (``bundles``), then two gloo ranks on the
    card against one process, the bundles among them."""
    mesh_world_of_one(K, model, paths)
    mesh_bundle_world_of_one(K, bundles)
    mesh_two_gloo_ranks(model, bundles)


def span_busy(prof, prefix):
    """Per record_function span whose name starts with ``prefix``: its wall
    ms and the device ms of the kernels that ran inside it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith(prefix) and e.device_type != cuda]
    # the device's kernels and copies; a record_function span also shows
    # on the device's timeline (a user annotation), which is not work
    work = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(prefix))
    out = []
    for name, s, t in sorted(spans, key=lambda x: x[1]):
        busy, last, n = 0.0, s, 0
        for a, b in work:  # the union of the intervals inside [s, t]
            n += s <= a < t
            a, b = max(a, last, s), min(b, t)
            if b > a:
                busy += b - a
                last = b
        out.append((name, (t - s) / 1e3, busy / 1e3, n))
    return out


def profile_train_loop(paths):
    """The device's idle share of each epoch of a timed loop run (pipeline
    on) under torch.profiler: 1 - (device busy time inside the epoch's
    span) / (the span's wall time), with the device launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bmhrl_tpu_torch.train.loop import train_rl_cap

    cfg = loop_config(paths, epoch_num=4, rl_warmstart_epochs=1,
                      one_by_one_starts_at=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = train_rl_cap(cfg, max_steps_per_epoch=LOOP_STEPS,
                           device="cuda")
        torch.cuda.synchronize()
    spans = span_busy(prof, "train_loop/epoch_")
    for (name, wall, busy, n), r in zip(spans, out["epochs"]):
        emit({"phase": "profile", "what": "training loop epoch",
              "epoch": r["epoch"], "phase_name": r["phase"],
              "steps": r["steps"], "wall_ms": wall, "device_busy_ms": busy,
              "device_idle_share": (1 - busy / wall) if busy else None,
              "device_launches_per_step": n / r["steps"],
              "ms_per_step": r["timer"]["step"]["p50_ms"],
              "note": None if busy else "not measured: no device time "
                                        "traced"})
    shutil.rmtree(os.path.dirname(paths["train"]))


def profile_train(sf, state, batch):
    """Device time of one B=16 warmstart step by kernel group, and the
    device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sf.warmstart_step(state, batch, 5, 1e-4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, counts = device_groups(prof)
    busy = sum(groups.values())
    emit({"phase": "profile", "what": "warmstart step", "B": 16,
          "wall_ms": wall_ms, "device_ms": groups, "device_busy_ms": busy,
          "device_idle_share": (1 - busy / wall_ms) if busy else None,
          "device_launches": sum(counts.values()),
          "device_launches_by_group": counts,
          "note": None if busy else "not measured: no device time traced"})


# --------------------------------------------------------------------------
def kernel_records():
    """The ``Kernel`` record of each kernel of csrc/, by short name and by
    its launch counter's name. The kernels phase alone, after a build:
    ``python3 -c "import chip_smoke as c; from bmhrl_tpu_torch.ops import
    _cuda; _cuda.build(); c.phase_kernels(c.kernel_records())"``."""
    src = "bmhrl_tpu_torch/csrc/"
    flash_tpu = "bmhrl_tpu/ops/attention.py:89 (+ :269)"
    folded_tpu = "bmhrl_tpu/ops/attention.py:568"
    K = {"flash_tc": Kernel("flash_attention_tc", src + "flash_attention.cu",
                            flash_tpu),
         "flash_simt": Kernel("flash_attention_simt",
                              src + "flash_attention.cu", flash_tpu),
         "folded_tc": Kernel("folded_attend_tc", src + "folded_attention.cu",
                             folded_tpu),
         "folded_simt": Kernel("folded_attend_simt",
                               src + "folded_attention.cu", folded_tpu),
         "lstm_cell": Kernel("lstm_cell", src + "critic_cells.cu",
                             "bmhrl_tpu/ops/critic_kernels.py:64"),
         "gru_cell": Kernel("gru_cell", src + "critic_cells.cu",
                            "bmhrl_tpu/ops/critic_kernels.py:87")}
    K["flash_attention_tc"] = K["flash_tc"]
    K["flash_attention_simt"] = K["flash_simt"]
    K["folded_attend_tc"] = K["folded_tc"]
    K["folded_attend_simt"] = K["folded_simt"]
    return K


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    try:
        from bmhrl_tpu_torch.ops import _cuda
    except ImportError as e:
        log(f"chip_smoke: the bmhrl_tpu_torch package is missing ({e})")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    # exact f32 products in cuBLAS (PyTorch's default, stated). cuDNN's
    # TF32 stays at its default (on), as the entry points find it: the
    # DETR's f32 convolutions turn it off themselves.
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    build_s = _cuda.build()
    emit({"phase": "build", "build_s": build_s,
          "ptxas": {n: [ln for ln in (_cuda.BUILD_DIR / f"{n}.log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
                    for n in _cuda.SOURCES
                    if (_cuda.BUILD_DIR / f"{n}.log").exists()}})
    # every attention kernel, at every instantiated width, keeps its state
    # in registers: no spill
    spills = {}
    for src in ("flash_attention", "folded_attention"):
        entry = ""
        for ln in (_cuda.BUILD_DIR / f"{src}.log").read_text().splitlines():
            if "entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln and entry:
                spills[entry] = ln.strip()
    emit({"phase": "build", "attention_kernel_spills": spills})
    kinds = ("flash_tc_kernel", "flash_simt_kernel", "folded_tc_kernel",
             "folded_kernel")
    if (not all(any(k in e for e in spills) for k in kinds)
            or any("0 bytes spill stores, 0 bytes spill loads" not in ln
                   for ln in spills.values())):
        raise AssertionError(f"attention kernel spills: {spills}")

    K = kernel_records()
    # the export phase's flagship bundles, served again by the mesh phase
    made = {"bundle_root": tempfile.mkdtemp(prefix="bmhrl_bundles_")}
    phases = (("kernels", lambda: phase_kernels(K)),
              ("reference", lambda: phase_reference(K)),
              ("serve", lambda: made.update(serve=phase_serve(K))),
              ("decode_modes", lambda: phase_decode_modes(K, made["serve"])),
              ("graph", lambda: phase_graph(K)),
              ("entry_points", lambda: phase_entry_points(K, made["serve"])),
              ("train", lambda: made.update(train=phase_train(K))),
              ("train_loop",
               lambda: made.update(train_loop=phase_train_loop(K))),
              ("detr", lambda: phase_detr(K, made["serve"])),
              ("leftovers", lambda: phase_leftovers(K)),
              ("proposals", lambda: phase_proposals(K, made["serve"])),
              ("export", lambda: made.update(bundles=phase_export(
                  K, made["serve"], made["bundle_root"]))),
              ("mesh", lambda: phase_mesh(K, made["serve"],
                                          made["train_loop"],
                                          made["bundles"])),
              # the profiler runs last: once it has traced, the host
              # launches more slowly
              ("profile", lambda: (profile_decode(made["serve"]),
                                   profile_decode(made["serve"], 64, 4),
                                   profile_train(*made["train"]),
                                   profile_train_loop(made["train_loop"]))))
    try:
        for name, phase in phases:
            t0 = time.perf_counter()
            log(f"chip_smoke: phase {name}")
            phase()
            torch.cuda.synchronize()
            emit({"phase": name, "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(made["bundle_root"], ignore_errors=True)

    kernels = [K[n].rec for n in ("flash_tc", "flash_simt", "folded_tc",
                                  "folded_simt", "lstm_cell", "gru_cell")]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
