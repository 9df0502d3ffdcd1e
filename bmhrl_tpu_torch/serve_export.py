"""AOT serving bundles: export the decode once, serve it without the model
code (the counterpart of bmhrl_tpu/serve_export.py).

For each (batch, video bucket, audio bucket) shape a bundle holds
``torch.export`` programs, shared by shapes whose lengths differ only
within one side of the flash gate (dynamic lengths):

- ``setup``: the source masks, the encoder and the model's ``fast_state``.
  It returns the per-row decode state (KV caches, critic RNN state, goal
  cache, boundary flags), the validity buffer and the loop-invariant inputs
  (merged QKV, folded projections, packed critic cells, the memories);
- ``head`` and ``body``: one token cut at its cross-row rule (the goal
  families, BMHRL and AHRL/VHRL: ``fast_step_head``/``fast_step_body``;
  the DETR's pre-goal path: ``train.decode.full_step_head``/
  ``full_step_body``). The head embeds the token, steps the frozen critic
  and returns the new critic state and boundary flags with their local
  any (the pre-goal path: the buffer's segment labels); the host
  exchanges that over the ranks (``parallel.mesh.cross_flags``: one
  all_reduce; constants on one device); the body runs the rest of the
  token under those flags (three 0-d bool inputs) and writes the caches
  it is given in place (input mutation), so after a beam's parent gather
  it writes into the gathered tensors. No program holds a collective.
- ``step`` (the DETR's default path, whose token has no cross-row rule
  but the loop's stop): one whole token, as ``fast_step``.

Every program's row axis is dynamic (``torch.export.Dim`` "clips", and
clips x W rows for beam search), from 1 to the exported batch's clips
(static for a batch of one clip, which serves one device):
one bundle, exported once at the global batch size, serves B / n clips on
each of n data-parallel ranks (``ExportedCaptionServer(mesh=...)``), as a
JAX bundle serves any mesh that divides its batch sizes. Each token
program takes only the state and invariant leaves it reads (``reads``).

A model without a fast loop (the DETR's ``pre_goal_attention`` path)
exports the full-buffer loop's start, head and body instead
(``train.decode.full_state``/``full_step_head``/``full_step_body``: the
token buffer and the critic's labels are per-row state written in place,
the memories repeated per beam), which the same host loops drive.

The loop over positions stays on the host: ``train/decode.py``'s fast
greedy and beam loops (argmax, or beam search's candidates, parent gather
and final pick) with one ``done.all()`` sync per token. (JAX bakes the whole loop into its
blob; ``torch.export`` has no stable loop, and a loop without its early
stop would run every position.) The programs call the kernels through the
custom ops of ``bmhrl_tpu_torch.ops``; the server imports no module of a
captioner.

Weights are program inputs, not constants, as in JAX: ``params.npz`` holds
the f32 flax tree in the JAX package's layout (``"params/a/b/c"`` keys),
the one copy of the weights, and ``bundle.json`` lists for each program the
flax key and layout of each weight input, and the positional tables the
loader rebuilds. A bundle is per platform: a program holds constants on the
device it was exported on, so export on the device that serves.

Layout of a bundle dir:
    bundle.json                       the JAX manifest's keys (shapes, itos,
                                      max_len, d_vid, d_aud, mode,
                                      beam_width, length_penalty, platforms)
                                      and format, programs (their
                                      inputs, in the order of a file
                                      entry), files ([B, vb, ab, program
                                      files...]), state, export_s
    params.npz                        the flax tree, "a/b/c" keys
    setup_B{B}xV{vb}xA{ab}.pt2        per group of shapes (B clips; a
                                      length range as lo-hi: ``_groups``)
    head_B{B}xV{vb}xA{ab}.pt2,        per group (B x beam_width rows), or
    body_B{B}xV{vb}xA{ab}.pt2         step_B{B}xV{vb}xA{ab}.pt2
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode

import bmhrl_tpu_torch.ops  # noqa: F401  (the bmhrl:: custom ops)
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
from bmhrl_tpu_torch.models.blocks import (_cudnn_without_tf32,
                                           sinusoid_table)
from bmhrl_tpu_torch.ops.attention import MIN_SK
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.serve import CaptionServer
from bmhrl_tpu_torch.train.decode import (_beam_fast_loop, _fast_loop,
                                          full_state, full_step,
                                          full_step_body, full_step_head)
from bmhrl_tpu_torch.weights import flax_keys, jax_layout_params

FORMAT = "bmhrl_tpu_torch/torch.export/2"
JAX_BLOB = ".bin"


class BundleError(ValueError):
    """A directory that is not a bundle the port serves on this device."""


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array} (the JAX bundle's key scheme)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _program_name(kind: str, B: int, v0: int, a0: int, v1: int,
                  a1: int) -> str:
    """``{kind}_B{B}xV{vb}xA{ab}.pt2``, a length range as ``lo-hi``."""
    def span(lo, hi):
        return f"{lo}" if lo == hi else f"{lo}-{hi}"

    return f"{kind}_B{B}xV{span(v0, v1)}xA{span(a0, a1)}.pt2"


# ---- nests of dicts, lists, tuples and NamedTuples <-> lists of tensors
_LEAF = object()


def _split(x, leaves: List[torch.Tensor]):
    """The skeleton of nest ``x`` (tensors replaced by a marker, other
    values kept), appending its tensors to ``leaves`` in order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if isinstance(x, dict):
        return {k: _split(v, leaves) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_split(v, leaves) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_split(v, leaves) for v in x)
    return x


def _join(skel, leaves):
    """The inverse of ``_split``: the skeleton filled from an iterator."""
    if skel is _LEAF:
        return next(leaves)
    if isinstance(skel, dict):
        return {k: _join(v, leaves) for k, v in skel.items()}
    if isinstance(skel, tuple) and hasattr(skel, "_fields"):
        return type(skel)(*(_join(v, leaves) for v in skel))
    if isinstance(skel, (list, tuple)):
        return type(skel)(_join(v, leaves) for v in skel)
    return skel


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)
        elif isinstance(a, dict):
            yield from _tensors(a.values())


class _Uses(TorchFunctionMode):
    """Records which of the watched tensors (parameters and buffers, by id)
    enter a torch function; property reads (``.device``, ``.shape``) do not
    count."""

    def __init__(self, watched: Dict[int, str]):
        super().__init__()
        self.watched = watched
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") != "__get__":
            for t in _tensors((args, kwargs)):
                name = self.watched.get(id(t))
                if name is not None:
                    self.seen.add(name)
        return func(*args, **kwargs)


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module's forward, so ``functional_call``
    can swap the model's tensors for program inputs."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Program(nn.Module):
    """The exported callable: ``forward(weights, tables, inputs)`` runs
    ``fn(model, *inputs)`` with the named parameters and buffers taken from
    the two lists. The model is not registered, so the exported program
    holds none of its tensors."""

    def __init__(self, model: nn.Module, fn, weights: Sequence[str],
                 tables: Sequence[str]):
        super().__init__()
        self.__dict__["_bound"] = _Bound(model, fn)
        self._names = [f"model.{n}" for n in (*weights, *tables)]

    def forward(self, weights: List[torch.Tensor], tables: List[torch.Tensor],
                inputs: List[torch.Tensor]):
        swap = dict(zip(self._names, [*weights, *tables]))
        return torch.func.functional_call(self._bound, swap, tuple(inputs))


def _setup(model, rgb, flow, audio, W: int, L: int):
    """The decode's start (``train.decode.decode`` up to its loop): masks,
    encoder, ``fast_state`` (or ``full_state``) for B x W rows."""
    feats = {"rgb": rgb, "flow": flow, "audio": audio}
    masks = make_masks(feats)
    Va, Av = model.encode(rgb + flow, audio, masks)
    rows = rgb.shape[0] * W
    if model.has_fast_loop:
        return model.fast_state(Va, Av, masks, rows, L)
    return full_state(model, Va, Av, masks, rows, L, W)


def _step(model, tok_t, t, caches, valid, inv, W: int):
    """One token of the loop ``_setup`` started: (log-probs, caches)."""
    if model.has_fast_loop:
        return model.fast_step(tok_t, t, caches, valid, inv, W)
    return full_step(model, tok_t, t, caches, valid, inv)


def _head(model, tok_t, t, caches, inv):
    """A token's step up to its cross-row rule: (head, caches, flag)."""
    if model.has_fast_loop:
        return model.fast_step_head(tok_t, t, caches, inv)
    return full_step_head(model, tok_t, t, caches, inv)


def _body(model, head, t, caches, valid, inv, W: int, fed):
    """A token's step after its head, under the cross-rank flags ``fed``:
    the log-probs."""
    if model.has_fast_loop:
        return model.fast_step_body(head, t, caches, valid, inv, W, fed)
    return full_step_body(model, head, t, caches, valid, inv, fed=fed)


def _alone_flags(device) -> List[torch.Tensor]:
    """The cross-rank flags of a batch held whole (no later rank, no other
    rank, row 0 here): the body program's flags on one device."""
    return [torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.ones((), dtype=torch.bool, device=device)]


def _leaves_at(skel, x) -> List:
    """The values of nest ``x`` at the leaves of skeleton ``skel`` (``x``
    has its structure; a value may be None where the program was not
    given that leaf)."""
    if skel is _LEAF:
        return [x]
    if isinstance(skel, dict):
        return [v for k in skel for v in _leaves_at(skel[k], x[k])]
    if isinstance(skel, (list, tuple)):
        return [v for s, y in zip(skel, x) for v in _leaves_at(s, y)]
    return []


def _table_spec(model: nn.Module, name: str) -> List:
    """The recipe of buffer ``name``: every buffer the decode reads is a
    ``PositionalEncoder`` table, rebuilt by the loader."""
    buf = model.get_buffer(name)
    rows, d = buf.shape
    if not torch.equal(buf.cpu(), torch.from_numpy(sinusoid_table(rows, d))):
        raise ValueError(f"buffer {name} is not a sinusoid table")
    return ["sinusoid", int(rows), int(d)]


def _groups(shapes) -> List[List[Tuple[int, int, int]]]:
    """Shapes that share one pair of programs: the same batch size, the
    video and the audio lengths each on one side of the flash gate's
    ``MIN_SK`` (``ops.attention.flash_qualifies``, the decode's only
    branch on a length), and the two ranges told apart by their ends (a
    length of the state is matched to one of them)."""
    groups: Dict[Tuple, List[Tuple[int, int, int]]] = {}
    for B, vb, ab in sorted({tuple(int(x) for x in s) for s in shapes}):
        groups.setdefault((B, vb >= MIN_SK, ab >= MIN_SK), []).append(
            (B, vb, ab))
    out = []
    for g in groups.values():
        v, a = (g[0][1], g[-1][1]), (g[0][2], g[-1][2])
        ambiguous = v[0] != v[1] and v == a
        out += [[x] for x in g] if ambiguous else [g]
    return out


def _dim(name: str, lo: int, hi: int):
    return torch.export.Dim(name, min=lo, max=hi) if lo < hi else None


def _leaf_dims(first, last, wider, ends: Dict[Tuple[int, int], object],
               grow: Dict[Tuple[int, int], object]):
    """Dynamic-shape specs of the program inputs ``first`` (at the group's
    first shape), ``last`` (at its last) and ``wider`` (at the first shape
    with one clip more; ``first`` where the rows stay static). The row
    axis is told by position: axis 0 of an input that grows with the clips
    takes the Dim of ``grow`` (its sizes at B and B + 1 clips: the clips'
    Dim, or the rows' for B x W rows).
    Each other axis whose size moves from one end of a length's range to
    the other takes that length's Dim."""
    specs = []
    for x, y, z in zip(first, last, wider):
        spec = {}
        if x.dim() and x.shape[0] != z.shape[0]:
            if (x.shape[0], z.shape[0]) not in grow:
                raise ValueError(f"an input of {x.shape[0]} -> {z.shape[0]} "
                                 "rows follows neither the clips nor the "
                                 "rows")
            spec[0] = grow[x.shape[0], z.shape[0]]
        for d, (n, m) in enumerate(zip(x.shape, y.shape)):
            if d not in spec and n != m:
                if (n, m) not in ends:
                    raise ValueError(f"an input of shape {tuple(x.shape)} "
                                     f"-> {tuple(y.shape)} follows no "
                                     "length of the bundle's shapes")
                spec[d] = ends[n, m]
        specs.append(spec or None)
    return specs


def _export(program: _Program, args, dynamic) -> Tuple[object, float]:
    """The exported program and its export seconds. Its example inputs
    (the weights among them) are dropped: they would be saved with it."""
    t0 = time.perf_counter()
    ep = torch.export.export(program, args, dynamic_shapes=dynamic,
                             strict=False)
    ep.example_inputs = None
    return ep, time.perf_counter() - t0


@torch.no_grad()
def export_decode_bundle(cfg, model, itos: Sequence[str],
                         shapes: Sequence[Tuple[int, int, int]], out_dir: str,
                         beam_width: int = 1,
                         length_penalty: float = 0.0) -> Dict:
    """Export ``model``'s decode at each (B, video_bucket, audio_bucket)
    shape into ``out_dir`` -- greedy by default, beam search when
    ``beam_width`` > 1 (the token programs then run B x W rows with the W
    beams of a clip sharing its memories) -- with the weights once in
    ``params.npz``. Shapes of one ``_groups`` group share one set of
    programs whose video and audio lengths are dynamic between the group's
    ends; the row axis of every program is dynamic from 1 to B clips, so
    one bundle, exported in one process at the global B, serves B / n
    clips on each of n ranks. Exports on the model's device, the platform
    the bundle serves on. Takes every family: the fast loop's step where
    the model has one, the full-buffer step for the DETR's
    ``pre_goal_attention`` path, each as a head and a body around the
    exchange of the cross-row flags where it has a cross-row rule
    (``model.cross_row_step``). Returns the manifest."""
    if not shapes:
        raise ValueError("export_decode_bundle: no shapes requested")
    os.makedirs(out_dir, exist_ok=True)
    model = model.eval()
    dev = model.device
    W = int(beam_width)
    L = int(cfg.max_len) + 1
    # a token's step with a cross-row rule is cut around its exchange
    split = model.cross_row_step
    names = {id(p): n for n, p in model.named_parameters()}
    names.update({id(b): n for n, b in model.named_buffers()})
    keys = flax_keys(model)
    programs: Dict[str, Dict] = {}
    state_spec: Optional[Dict] = None
    export_s: Dict[str, float] = {}
    files: List[List] = []

    def traced(fn, leaves):
        """fn() under a record of the parameters, buffers (by name) and
        decode-state leaves (by index into ``leaves``) it reads."""
        watched = dict(names)
        watched.update({id(x): i for i, x in enumerate(leaves)})
        with _Uses(watched) as uses:
            out = fn()
        return (out, {n for n in uses.seen if isinstance(n, str)},
                sorted(n for n in uses.seen if isinstance(n, int)))

    def dry_run(B, vb, ab):
        """One eager decode start and token at a shape: per program its
        example inputs, the parameters and buffers it reads and the state
        leaves it takes; the nests' skeletons; the state leaves a token
        carries anew."""
        feats = [torch.zeros(B, vb, cfg.d_vid, device=dev),
                 torch.zeros(B, vb, cfg.d_vid, device=dev),
                 torch.zeros(B, ab, cfg.d_aud, device=dev)]
        (caches, valid, inv), setup_used, _ = traced(
            lambda: _setup(model, *feats, W, L), [])
        state: List[torch.Tensor] = []
        inv_leaves: List[torch.Tensor] = []
        skels = (_split(caches, state), _split(inv, inv_leaves))
        # distinct tensors: the state aliases (the critic starts every cell
        # from one zero tensor)
        leaves = [x.clone() for x in (*state, *inv_leaves)]
        n = len(state)
        caches = _join(skels[0], iter(leaves[:n]))
        inv = _join(skels[1], iter(leaves[n:]))
        tok = torch.full((B * W,), BOS, dtype=torch.int64, device=dev)
        t0 = torch.zeros((), dtype=torch.int64, device=dev)
        runs = {"setup": (feats, setup_used)}
        if split:
            (head, new, _), used, reads = traced(
                lambda: _head(model, tok, t0, caches, inv), leaves)
            runs["head"] = ([tok, t0, *(leaves[i] for i in reads)], used,
                            reads)
        else:
            (_, new), used, reads = traced(
                lambda: _step(model, tok, t0, caches, valid, inv, W), leaves)
            runs["step"] = ([tok, t0, valid, *(leaves[i] for i in reads)],
                            used, reads)
        new_state = _leaves_at(skels[0], new)
        carried = [i for i, (a, b) in enumerate(zip(leaves, new_state))
                   if a is not b]
        if split:
            head_leaves: List[torch.Tensor] = []
            head_skel = _split(head, head_leaves)
            after = [new_state[i] for i in range(n)] + leaves[n:]
            alone = _alone_flags(dev)
            _, used, reads = traced(
                lambda: _body(model, head, t0, _join(
                    skels[0], iter(after[:n])), valid, inv, W, alone), after)
            runs["body"] = ([*head_leaves, t0, valid, *alone,
                             *(after[i] for i in reads)], used, reads)
            skels += (head_skel, len(head_leaves))
        return runs, skels, carried, (n, len(leaves))

    for group in _groups(shapes):
        (B, v0, a0), (_, v1, a1) = group[0], group[-1]
        first = dry_run(*group[0])
        last = dry_run(*group[-1]) if len(group) > 1 else first
        # which inputs grow with the clips: a dry run with one clip more
        # (a batch of one clip keeps its row axis static)
        wider = dry_run(B + 1, v0, a0)[0] if B > 1 else first[0]
        runs, skels, carried, (n_state, n_leaves) = first
        spec = {"leaves": n_state, "carried": carried}
        if state_spec not in (None, spec) or last[2] != carried:
            raise ValueError(f"shapes {group}: decode state {spec} differs "
                             f"from {state_spec}")
        state_spec = spec
        ends = {}
        vdim, adim = _dim("video", v0, v1), _dim("audio", a0, a1)
        if vdim is not None:
            ends[v0, v1] = vdim
        if adim is not None:
            ends[a0, a1] = adim
        clips = _dim("clips", 1, B)
        rows = clips if clips is None or W == 1 else W * clips
        grow = {(B, B + 1): clips, (W * B, W * (B + 1)): rows}

        def state_of(rest, reads):
            """The state and invariant nests from a program's inputs (None
            at the leaves it does not take)."""
            full: List = [None] * n_leaves
            for i, x in zip(reads, rest):
                full[i] = x
            return (_join(skels[0], iter(full[:n_state])),
                    _join(skels[1], iter(full[n_state:])))

        def setup_fn(m, rgb, flow, audio):
            c, v, i = _setup(m, rgb, flow, audio, W, L)
            leaves: List[torch.Tensor] = []
            _split(c, leaves)
            inv_out: List[torch.Tensor] = []
            _split(i, inv_out)
            return leaves, v, inv_out

        def step_fn(m, tok_t, t, valid_t, *rest):
            c, i = state_of(rest, programs["step"]["reads"])
            logits, c_new = _step(m, tok_t, t, c, valid_t, i, W)
            leaves = _leaves_at(skels[0], c_new)
            return logits, [leaves[j] for j in carried]

        def head_fn(m, tok_t, t, *rest):
            c, i = state_of(rest, programs["head"]["reads"])
            head, c_new, flag = _head(m, tok_t, t, c, i)
            leaves = _leaves_at(skels[0], c_new)
            out: List[torch.Tensor] = []
            _split(head, out)
            return out, [leaves[j] for j in carried], flag.any()

        def body_fn(m, *args):
            k = skels[3]  # the head's leaves, then t, valid and the flags
            head = _join(skels[2], iter(args[:k]))
            t, valid_t, *fed = args[k:k + 5]
            c, i = state_of(args[k + 5:], programs["body"]["reads"])
            return _body(m, head, t, c, valid_t, i, W, fed)

        fns = {"setup": setup_fn, "step": step_fn, "head": head_fn,
               "body": body_fn}
        names_of = {}
        for kind, run in runs.items():
            args, used = run[0], run[1]
            w = [n for n, _ in model.named_parameters() if n in used]
            b = [n for n, _ in model.named_buffers() if n in used]
            record = {"weights": [[keys[n][0], "T" if keys[n][1] else ""]
                                  for n in w],
                      "tables": [_table_spec(model, n) for n in b]}
            if kind != "setup":
                record["reads"] = run[2]
            if programs.setdefault(kind, record) != record:
                raise ValueError(f"{kind} inputs differ across shapes")
            wt = [model.get_parameter(n).detach() for n in w]
            bt = [model.get_buffer(n) for n in b]
            dynamic = ([None] * len(wt), [None] * len(bt),
                       _leaf_dims(args, last[0][kind][0],
                                  wider[kind][0], ends, grow))
            ep, secs = _export(_Program(model, fns[kind], w, b),
                               (wt, bt, args), dynamic)
            name = _program_name(kind, B, v0, a0, v1, a1)
            torch.export.save(ep, os.path.join(out_dir, name))
            export_s[name] = secs
            names_of[kind] = name
        files += [[*s, *names_of.values()] for s in group]

    np.savez(os.path.join(out_dir, "params.npz"),
             **_flatten(jax_layout_params(model)))
    manifest = {
        "shapes": [[int(B), int(vb), int(ab)] for B, vb, ab in shapes],
        "itos": list(itos),
        "max_len": int(cfg.max_len),
        "d_vid": int(cfg.d_vid),
        "d_aud": int(cfg.d_aud),
        "mode": cfg.mode,
        "beam_width": W,
        "length_penalty": float(length_penalty),
        "platforms": [dev.type],
        "format": FORMAT,
        "programs": programs,
        "files": files,
        "state": state_spec,
        "export_s": export_s,
    }
    with open(os.path.join(out_dir, "bundle.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def read_manifest(bundle_dir: str, device) -> Dict:
    """``bundle.json`` of a bundle this port serves on ``device``; raises
    ``BundleError`` for a JAX bundle, one of an older format or one of
    another platform."""
    path = os.path.join(bundle_dir, "bundle.json")
    if not os.path.exists(path):
        raise BundleError(f"{bundle_dir} holds no bundle.json")
    with open(path) as f:
        m = json.load(f)
    files = os.listdir(bundle_dir)
    if m.get("format") != FORMAT:
        if any(f.endswith(JAX_BLOB) for f in files):
            raise BundleError(
                f"{bundle_dir} is a bundle of the JAX package (jax.export "
                "blobs, which run only under JAX: bmhrl_tpu.serve_export."
                "ExportedCaptionServer); export one for the port with "
                "bmhrl_tpu_torch.serve_export.export_decode_bundle "
                "(serve_captions --export_bundle)")
        if str(m.get("format", "")).startswith(FORMAT.rsplit("/", 1)[0]):
            raise BundleError(
                f"{bundle_dir} is a bundle of format {m['format']}, not "
                f"{FORMAT} (whose programs take any rows a rank holds and "
                "cut the goal families' token step around the exchange of "
                "the cross-row flags): re-export it with "
                "bmhrl_tpu_torch.serve_export.export_decode_bundle "
                "(serve_captions --export_bundle)")
        raise BundleError(f"{bundle_dir}: not a bundle of format {FORMAT}")
    dev = torch.device(device).type
    if m["platforms"] != [dev]:
        raise BundleError(
            f"{bundle_dir} was exported for {m['platforms']}, not {dev}: its "
            "programs hold that device's constants; export the bundle on "
            "the device that serves it")
    return m


def check_world(manifest: Dict, world: int) -> None:
    """Raise ValueError unless every batch size of the bundle splits over
    ``world`` ranks (the programs take any rows from 1 to the batch)."""
    bad = sorted({s[0] for s in manifest["shapes"] if s[0] % world})
    if bad:
        raise ValueError(
            f"bundle batch sizes {bad} are not divisible by the mesh data "
            f"axis ({world}); batches would pad to shapes with no exported "
            "program — re-export with divisible batch sizes or serve on a "
            "matching mesh")


class ExportedCaptionServer(CaptionServer):
    """CaptionServer that runs a bundle's exported programs: no captioner
    module. Scheduling and IO are inherited; each batch's (B, vb, ab) shape
    must match an exported one, so tail batches are row-padded to the
    bundle's batch sizes. ``mesh``: the data-parallel mesh this rank
    serves in (``parallel.mesh``): every rank loads the bundle, decodes
    its B / world rows of each batch, exchanges the boundary flags between
    the head and the body of each token and stops with the others; a batch
    size the ranks do not divide is refused here. ``load_s``: seconds to
    load params and programs; ``program_calls``: the calls of each program
    kind so far."""

    def __init__(self, bundle_dir: str, video_features_path: str,
                 audio_features_path: str, device="cuda", mesh=None):
        t0 = time.perf_counter()
        self.manifest = m = read_manifest(bundle_dir, device)
        if mesh is not None:
            check_world(m, mesh.world)
        cfg = Config(
            mode=m["mode"], max_len=m["max_len"],
            d_vid=m["d_vid"], d_aud=m["d_aud"],
            video_buckets=tuple(sorted({s[1] for s in m["shapes"]})),
            audio_buckets=tuple(sorted({s[2] for s in m["shapes"]})),
            video_features_path=video_features_path,
            audio_features_path=audio_features_path, to_log=False)
        super().__init__(cfg, None, m["itos"], device=device, mesh=mesh)
        self._fixed_batch = True
        self._batch_sizes = sorted({s[0] for s in m["shapes"]})
        self.beam_width = int(m["beam_width"])
        self.length_penalty = float(m["length_penalty"])
        self._state = m["state"]
        self._alone = _alone_flags(self.device)
        weights: Dict[Tuple[str, str], torch.Tensor] = {}

        def weight(key, layout):
            if (key, layout) not in weights:
                arr = flat[f"params/{key}"]
                arr = np.ascontiguousarray(arr.T if layout == "T" else arr)
                weights[key, layout] = torch.from_numpy(arr).to(self.device)
            return weights[key, layout]

        with np.load(os.path.join(bundle_dir, "params.npz")) as flat:
            self._inputs = {
                kind: ([weight(k, lay) for k, lay in p["weights"]],
                       [torch.from_numpy(sinusoid_table(rows, d)).to(
                           self.device) for _, rows, d in p["tables"]])
                for kind, p in m["programs"].items()}
        self._reads = {kind: p.get("reads") for kind, p in
                       m["programs"].items()}
        self.program_calls = dict.fromkeys(m["programs"], 0)
        loaded: Dict[str, nn.Module] = {}

        def program(name):
            if name not in loaded:
                loaded[name] = torch.export.load(
                    os.path.join(bundle_dir, name)).module()
            return loaded[name]

        # a shape's program files follow the order of ``programs``
        self._programs = {(B, vb, ab): dict(zip(m["programs"], map(
            program, names))) for B, vb, ab, *names in m["files"]}
        self.load_s = time.perf_counter() - t0

    def _decode(self, feats: Dict, masks_src: Dict) -> torch.Tensor:
        rgb, audio = feats["rgb"], feats["audio"]
        world = 1 if self.mesh is None else self.mesh.world
        key = (int(rgb.shape[0]) * world, int(rgb.shape[1]),
               int(audio.shape[1]))
        progs = self._programs.get(key)
        if progs is None:
            raise KeyError(f"no exported decode for shape {key}; bundle has "
                           f"{sorted(self._programs)}")
        # the live model runs its f32 convolutions with cuDNN's TF32 off
        # (models.blocks.ConvSame); an exported program holds no switch
        with torch.no_grad(), _cudnn_without_tf32():
            return self._loop(progs, rgb, feats["flow"], audio)

    def _call(self, progs, kind: str, lead: List, state, inv):
        """Program ``kind`` on its leading inputs and the state and
        invariant leaves it reads."""
        n = len(state)
        taken = [state[i] if i < n else inv[i - n] for i in self._reads[kind]]
        self.program_calls[kind] += 1
        return progs[kind](*self._inputs[kind], [*lead, *taken])

    def _loop(self, progs, rgb, flow, audio) -> torch.Tensor:
        """``train.decode``'s fast greedy or beam loop over the programs:
        the decode state is the flat list of the state leaves, the carried
        ones replaced after each token. A token is one ``step`` program,
        or a ``head``, the exchange of its boundary flags over the ranks
        (constants on one device) and a ``body``."""
        B, W = rgb.shape[0], self.beam_width
        self.program_calls["setup"] += 1
        with self.spans("decode.setup"):
            state, valid, inv = progs["setup"](*self._inputs["setup"],
                                               [rgb, flow, audio])
        carried = self._state["carried"]

        def carry(state, new):
            state = list(state)
            for i, x in zip(carried, new):
                state[i] = x
            return state

        def step_fn(tok_t, t, state, valid):
            if "step" in progs:
                logits, new = self._call(progs, "step", [tok_t, t, valid],
                                         state, inv)
                return logits, carry(state, new)
            head, new, flag = self._call(progs, "head", [tok_t, t], state,
                                         inv)
            state = carry(state, new)
            fed = mesh_lib.cross_flags(flag, self.mesh) or self._alone
            return self._call(progs, "body", [*head, t, valid, *fed], state,
                              inv), state

        args = (state, valid, step_fn, B)
        if W == 1:
            return _fast_loop(*args, self.cfg.max_len, BOS, EOS, PAD, True,
                              None, None, self.mesh, self.spans)[0]
        return _beam_fast_loop(*args, W, self.cfg.max_len, BOS, EOS, PAD,
                               self.length_penalty, self.mesh, self.spans)[0]

    def caption(self, reqs, batch_size: Optional[int] = None, **kw):
        bs = batch_size or max(self._batch_sizes)
        if bs not in self._batch_sizes:
            raise ValueError(f"batch_size {bs} not in bundle (has "
                             f"{self._batch_sizes})")
        return super().caption(reqs, batch_size=bs, **kw)
