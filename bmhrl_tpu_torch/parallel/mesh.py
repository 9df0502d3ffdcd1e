"""Data parallelism over ``torch.distributed`` (the port of
bmhrl_tpu/parallel/mesh.py).

The JAX package lays a (data, model) mesh over its devices: batches shard
on ``data``, parameters replicate, and XLA computes every cross-row
operation over the global batch. Here each device is one process (a
rank): NCCL joins CUDA ranks, gloo CPU ranks. Parameters are replicated,
broadcast from rank 0 at start, and the rows of every global batch are
split over the ranks in contiguous blocks: rank r holds rows
[r*b, (r+1)*b), as ``P("data")`` lays them out.

A rank sees only its rows, so every quantity in which a row depends on
other rows takes the helpers below: the goal expansion's "does a later
row have a boundary" and "row 0 of the batch" (``ops.segments``; split
into the exchange, ``cross_flags``, and the pure ``apply_cross_flags``,
so an exported token step takes the exchanged flags as inputs), the
Manager's statistics, the loss normalisers (``global_sum``,
``global_count``), the decode's stop (``all_done``) and the tokens back in
request order (``gather_rows``). Each helper is the identity for
``mesh=None`` and for a world of 1, so one process computes what it
computes without a mesh. Every exchange is an ``all_reduce`` or a
``broadcast``: under NCCL a CUDA tensor stays on the card; gloo, which a
test or a rig may pick for CUDA tensors, gets them staged through the host.
``COLLECTIVES`` counts the calls.

No helper falls back: a failed collective raises, and ``spawn`` fails the
run when a rank dies.

The model axis: the JAX loop replicates it (its ``param_sharding_rules``
are applied only by tests), so a (d, m) mesh computes what (d, 1) does;
the port has no tensor parallelism and ``resolve_data`` refuses m > 1.
Ranks run on one host: ``spawn`` starts them from one command.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collective calls made by the helpers, by kind
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "broadcast": 0,
                               "barrier": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class Mesh:
    """The data-parallel ranks of one run, as this process sees them:
    ``rank`` of ``world`` (one host), this rank's ``device`` and the
    process group's ``backend``."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.backend = backend

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    # -- the collectives (every one counted) ---------------------------------
    def _staged(self, t: torch.Tensor, fn) -> torch.Tensor:
        """Run ``fn`` on t where the backend takes it: gloo gets CUDA
        tensors through the host."""
        if self.backend == "gloo" and t.device.type == "cuda":
            h = t.cpu()
            fn(h)
            t.copy_(h)
        else:
            fn(t)
        return t

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced over the ranks, in place (t is returned)."""
        COLLECTIVES["all_reduce"] += 1
        return self._staged(t, lambda x: dist.all_reduce(x, op=op))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        COLLECTIVES["broadcast"] += 1
        return self._staged(t, lambda x: dist.broadcast(x, src))

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """A picklable object of rank ``src`` on every rank."""
        COLLECTIVES["broadcast"] += 1
        box = [obj]
        dist.broadcast_object_list(
            box, src, device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        COLLECTIVES["barrier"] += 1
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _world(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


# ---- the cross-row helpers -----------------------------------------------------
def _local_later(flag: torch.Tensor) -> torch.Tensor:
    """later[b] = any(flag[b+1:]) within this rank's rows."""
    hb = flag.to(torch.int32)
    suffix = hb.flip(0).cumsum(0).flip(0)  # inclusive suffix count
    return (suffix - hb) > 0


def rank_flags(flag: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(world,) int32: 1 where that rank has a row with ``flag`` (one
    all_reduce; no host sync)."""
    slots = torch.zeros(mesh.world, dtype=torch.int32, device=flag.device)
    slots[mesh.rank] = flag.any().to(torch.int32)
    return mesh.all_reduce(slots)


def cross_flags(flag: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """The exchange half of ``row_flags``: three 0-d bools (a LATER rank
    has a row with ``flag``, ANOTHER rank has one, this rank holds row 0
    of the global batch) from one ``rank_flags`` all_reduce; None alone
    (no collective). ``flag``: this rank's rows' flags, or their any."""
    if _world(mesh) == 1:
        return None
    ranks = rank_flags(flag, mesh)
    later = ranks[mesh.rank + 1:].sum() > 0
    other = (ranks.sum() - ranks[mesh.rank]) > 0
    first = torch.full((), mesh.rank == 0, dtype=torch.bool,
                       device=flag.device)
    return later, other, first


def apply_cross_flags(flag: torch.Tensor, fed=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pure half of ``row_flags``: (later (b,) bool, any () bool, row0
    (b,) bool: True at row 0 of the global batch) of this rank's rows of
    ``flag`` under the cross-rank flags ``fed`` (``cross_flags``'s three
    0-d bools, or the inputs of an exported program; None: these rows are
    the batch)."""
    later = _local_later(flag)
    row0 = torch.arange(flag.shape[0], device=flag.device) == 0
    if fed is None:
        return later, flag.any(), row0
    later_rank, other_rank, first_rank = fed
    return later | later_rank, flag.any() | other_rank, row0 & first_rank


def row_flags(flag: torch.Tensor, mesh: Optional[Mesh] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(later (b,) bool: does any LATER row of the global batch have
    ``flag``; any () bool: does any row), with one collective."""
    return apply_cross_flags(flag, cross_flags(flag, mesh))[:2]


def rows_later_have(flag: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(b,) bool: does a later row of the global batch have ``flag``."""
    return row_flags(flag, mesh)[0]


def rows_any(flag: torch.Tensor, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """() bool: does any row of the global batch have ``flag``."""
    return row_flags(flag, mesh)[1]


def global_sum(x: torch.Tensor, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """x summed over the ranks (a new tensor; x itself when alone)."""
    if _world(mesh) == 1:
        return x
    return mesh.all_reduce(x.detach().clone())


def global_count(mask: torch.Tensor, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """The number of True (non-zero) entries of ``mask`` over the ranks."""
    return global_sum(mask.sum(), mesh)


def global_numel(x: torch.Tensor, mesh: Optional[Mesh] = None) -> int:
    """The global batch's element count of a tensor of this rank's rows
    (the same shape on every rank)."""
    return x.numel() * _world(mesh)


def global_nanmean(x: torch.Tensor, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """``torch.nanmean`` over every rank's rows (one collective)."""
    if _world(mesh) == 1:
        return torch.nanmean(x)
    sc = torch.stack([torch.nansum(x), (~torch.isnan(x)).sum().to(x.dtype)])
    s, c = mesh.all_reduce(sc)
    return s / c


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Every rank's rows of x, in rank order (the global batch), on every
    rank: one all_reduce of the rows placed in their slots (exact, also
    for floats: each entry is one value plus zeros)."""
    if _world(mesh) == 1:
        return x
    b = x.shape[0]
    out = x.new_zeros((b * mesh.world,) + tuple(x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x
    return mesh.all_reduce(out)


def all_done(done: torch.Tensor, mesh: Optional[Mesh] = None) -> bool:
    """Has every row of the global batch finished? One host sync; with
    ranks one all_reduce before it, so every rank stops at one step."""
    if _world(mesh) == 1:
        return bool(done.all())
    left = (~done).sum().to(torch.int32).reshape(1)
    return int(mesh.all_reduce(left)) == 0


def all_reduce_grads(grads: Dict[Any, Optional[torch.Tensor]],
                     mesh: Optional[Mesh] = None
                     ) -> Dict[Any, Optional[torch.Tensor]]:
    """The gradients summed over the ranks, in one flat all_reduce.

    The scale: every loss of a step divides by its GLOBAL normaliser
    (``global_count``), so a rank's loss is its share of the global loss
    and the sum of the ranks' gradients is the gradient of the global
    batch, which one process computes. (DDP would average local-mean
    gradients instead; it is not used.) A missing gradient (None) is None
    on every rank: the ranks run one graph."""
    if _world(mesh) == 1:
        return grads
    names = [n for n, g in grads.items() if g is not None]
    if not names:
        return grads
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    mesh.all_reduce(flat)
    out = dict(grads)
    off = 0
    for n in names:
        g = grads[n]
        out[n] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return out


# ---- batches and modules ---------------------------------------------------------
def shard_batch(mesh: Optional[Mesh], batch: Dict[str, Any]
                ) -> Dict[str, Any]:
    """This rank's rows of every numpy array or tensor of ``batch`` with a
    leading batch dim; other fields pass through."""
    if _world(mesh) == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            out[k] = v[mesh.rows(v.shape[0])]
        else:
            out[k] = v
    return out


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]
              ) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 and give
    every submodule that takes a mesh (a ``mesh`` class attribute: the
    captioners and their Manager) this one. Returns the module."""
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    if _world(mesh) > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                mesh.broadcast(t.data)
    return module


# ---- making and starting ranks ---------------------------------------------------
def _backend_of(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def num_devices(device="cuda") -> int:
    """The devices "all devices" counts: the cards for CUDA, 1 for CPU."""
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def resolve_data(mesh_shape, device="cuda") -> int:
    """The data axis of ``mesh_shape``: (0, m) is every device (over m)."""
    d, m = mesh_shape
    if m != 1:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)}: the port has no model axis "
            "(no tensor parallelism; the JAX loop replicates that axis, so "
            f"({d}, {m}) computes what ({d}, 1) does): give a model axis "
            "of 1")
    return d if d > 0 else num_devices(device)


def build_once(mesh: Mesh) -> None:
    """Build the kernels (CUDA ranks), the native reward library and the
    feature reader on rank 0 while the other ranks wait; every rank then
    loads the built libraries. A failed build raises on every rank."""
    err = ""
    if mesh.rank == 0:
        try:
            from bmhrl_tpu_torch import native
            from bmhrl_tpu_torch.data import feature_reader

            # no compiler: the Python scorer and loader, everywhere
            native.available()
            feature_reader.available()
            if mesh.device.type == "cuda":
                from bmhrl_tpu_torch.ops import _cuda

                _cuda.build()
        except Exception as e:  # reported on every rank below
            err = f"rank {mesh.rank}: {e}"
    err = mesh.broadcast_object(err)
    if err:
        raise RuntimeError(f"kernel build failed: {err}")


def make_mesh(mesh_shape=(0, 1), device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """A world of one rank in this process (NCCL for CUDA, gloo for CPU
    by default): the mesh of ``mesh_shape`` (1, 1), or (0, 1) where there
    is one device. More ranks are processes of their own: ``spawn`` starts
    them, with their mesh."""
    from bmhrl_tpu_torch import resolve_device

    d = resolve_data(mesh_shape, device)
    if d != 1:
        raise ValueError(
            f"a mesh of {d} ranks needs {d} processes: start them with "
            "parallel.mesh.spawn (the CLIs do)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend_of(dev, backend),
                            store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(0, 1, dev, dist.get_backend())


def close() -> None:
    """Leave the process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, store_path: str, device: str,
               backend: Optional[str], threads: Optional[int], fn, args,
               results) -> None:
    """One spawned rank: join the group, build, run fn(mesh, *args); rank
    0 puts its result on ``results``, a failing rank its traceback."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        be = _backend_of(dev, backend)
        dist.init_process_group(be, init_method=f"file://{store_path}",
                                rank=rank, world_size=world)
        mesh = Mesh(rank, world, dev, be)
        build_once(mesh)
        out = fn(mesh, *args)
        if rank == 0:
            # plain pickle bytes: a queue would pass tensors as handles to
            # this process's shared memory, gone once it exits
            results.put(("ok", rank, pickle.dumps(out)))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cuda", args: Sequence = (),
          backend: Optional[str] = None,
          devices: Optional[Sequence[str]] = None,
          threads: Optional[int] = None) -> Any:
    """Run ``fn(mesh, *args)`` on ``world`` new processes (the "spawn"
    start method; ``fn`` and ``args`` must pickle) joined by a file store
    in a fresh temporary directory, and return rank 0's result. Rank r
    runs on ``devices[r]``, by default cuda:r for CUDA (one card each)
    and the CPU otherwise; ``backend`` NCCL for CUDA and gloo for CPU by
    default (a rig that puts two ranks on one card passes gloo: NCCL
    refuses that). ``threads``: torch threads per rank (default: this
    process's threads shared out). If a rank fails or dies, the others are
    stopped and this raises."""
    import multiprocessing as mp

    if threads is None:
        threads = max(1, torch.get_num_threads() // world)

    dev = torch.device(device)
    if devices is None:
        devices = [f"cuda:{r}" if dev.type == "cuda" else "cpu"
                   for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="bmhrl_mesh_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, str(devices[r]), backend,
                               threads, fn, tuple(args), results),
                         daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    got, failure = None, None
    try:
        while any(p.is_alive() for p in procs):
            while not results.empty():
                kind, rank, payload = results.get()
                if kind == "ok":
                    got = (pickle.loads(payload),)
                elif failure is None:
                    failure = f"rank {rank} failed:\n{payload}"
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            if dead or failure:
                break
            time.sleep(0.05)
        while not results.empty():
            kind, rank, payload = results.get()
            if kind == "ok":
                got = (pickle.loads(payload),)
            elif failure is None:
                failure = f"rank {rank} failed:\n{payload}"
        dead = [(r, p.exitcode) for r, p in enumerate(procs)
                if p.exitcode not in (None, 0)]
        if dead or failure:
            raise RuntimeError(failure or f"ranks died (rank, exit code): "
                               f"{dead}")
    finally:
        for p in procs:
            if p.is_alive() and (failure or any(
                    q.exitcode not in (None, 0) for q in procs)):
                p.terminate()
        for p in procs:
            p.join()
        try:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
        except OSError:
            pass
    if got is None:
        raise RuntimeError("rank 0 returned no result")
    return got[0]
