"""Meshes over ``torch.distributed`` process groups, the local launcher and
the collectives the sharded programs use (counterpart of
``graphtpu/dist/mesh.py`` and of ``make_2d_mesh`` in
``graphtpu/dist/spmm_summa.py:53-63``).

graphtpu's substrate is a ``jax.sharding.Mesh`` whose ``shard_map``
programs see every device's block at once.  Here each rank is a process
that holds only its own block, and a mesh is that rank's view of an
initialised process group: its coordinates, one sub-group per axis, and
the device it computes on.  Axes:

  * ``data`` / ``model`` (:func:`make_mesh`, :func:`make_1d_mesh`): the
    walker/batch axis and the embedding-table axis;
  * ``pr`` / ``pc`` (:func:`make_2d_mesh`): the SUMMA grid's rows and
    columns, rank = i * c + j.

The JAX collectives map to :func:`ppermute` (a ring shift), :func:`all_to_all`,
:func:`psum`, :func:`psum_scatter` and :func:`all_gather`.  All of them move
raw bytes through ``all_to_all_single`` or sum float32/float64 through
``all_reduce``, so one code path serves NCCL (a card per rank) and gloo
(CPU tensors, or several ranks sharing one card, where gloo stages each
collective through host memory while the blocks and the products stay on
the card).  gloo's all-to-all refuses int16 and has no reduce-scatter for
CUDA tensors; moving bytes sidesteps the first and :func:`psum_scatter`
builds the second from an all-to-all and a local sum.

:func:`spawn` starts ``world_size`` local ranks for tests, the smoke and
the dry run and returns rank 0's result.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from graphtpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a device mesh over the default process group.

    ``shape[k]`` ranks lie along ``axis_names[k]``; the rank's position is
    ``coords`` (row-major: the last axis varies fastest with the rank).
    ``groups[axis]`` is the process group of the ranks that share every
    other coordinate, ordered by their coordinate on ``axis``.  ``device``
    is where this rank computes."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def backend(self) -> str:
        return dist.get_backend()


def device_count() -> int:
    """Ranks in the default process group (graphtpu: devices visible)."""
    return dist.get_world_size()


def _rank_device(device) -> torch.device:
    """``device`` for this rank: a CUDA device without an index becomes
    ``cuda:{rank mod cards}``, so NCCL gives each rank its own card and gloo
    ranks outnumbering the cards share them."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _grid_mesh(shape: Sequence[int], axis_names: Sequence[str], device) -> Mesh:
    """A row-major mesh of ``shape`` over every rank of the default group.
    Every rank creates every axis group in the same order, as
    ``dist.new_group`` requires, and keeps the ones it belongs to."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group, or spawn)")
    shape = tuple(int(s) for s in shape)
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the group has {n}")
    rank = dist.get_rank()

    def coords_of(r):
        out = []
        for s in reversed(shape):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    coords = coords_of(rank)
    groups = {}
    for k, name in enumerate(axis_names):
        lines: Dict[tuple, list] = {}
        for r in range(n):  # ascending ranks: ascending coordinate on axis k
            c = coords_of(r)
            lines.setdefault(c[:k] + c[k + 1:], []).append(r)
        for key in sorted(lines):
            grp = dist.new_group(lines[key])
            if rank in lines[key]:
                groups[name] = grp
    return Mesh(axis_names=tuple(axis_names), shape=shape, rank=rank, coords=coords,
                groups=groups, device=_rank_device(device))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
    model_parallel: int = 1,
    device=None,
) -> Mesh:
    """A (data, model) mesh over every rank, ``model_parallel`` ranks on the
    model axis (it must divide the world size).  ``n_devices``, when given,
    must equal the world size: a rank cannot leave the group."""
    n = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is not None and n is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has {n} ranks")
    if n is not None and n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} ranks")
    return _grid_mesh(((n or 0) // model_parallel, model_parallel), axis_names, device)


def make_1d_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """A one-axis mesh over every rank."""
    n = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is not None and n is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has {n} ranks")
    return _grid_mesh((n or 0,), (axis,), device)


def make_2d_mesh(r: int, c: int, device=None) -> Mesh:
    """An (r, c) grid with axes ("pr", "pc"); rank i*c + j sits at (i, j)."""
    return _grid_mesh((r, c), ("pr", "pc"), device)


# ---------------------------------------------------------------------------
# collectives


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Split ``x`` into ``n`` equal blocks along dim 0 and send block k to
    group rank k; returns the received blocks stacked in sender order."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not a multiple of {n} ranks")
    if n == 1:
        return x.clone()
    src = _bytes(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(x.dtype).reshape(x.shape)


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """The ring shift ``[(i, i - 1 mod n)]``: send ``x`` to the previous group
    rank and return the block of the next one (same shape and dtype)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    src = _bytes(x)
    out = torch.empty_like(src)
    send = [0] * n
    recv = [0] * n
    send[(me - 1) % n] = src.numel()
    recv[(me + 1) % n] = src.numel()
    dist.all_to_all_single(out, src, recv, send, group=group)
    return out.view(x.dtype).reshape(x.shape)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (float32, float64 or int64), as a new tensor."""
    out = x.clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``psum_scatter(x, scatter_dimension=0, tiled=True)``: the sum over the
    group of each rank's ``x``, of which group rank k keeps the k-th of
    ``n`` row blocks.  One all-to-all of ``x``'s dtype (a bf16 ``x`` ships
    as bf16), then the n blocks summed in rank order in float32 and rounded
    once to ``x``'s dtype."""
    n = dist.get_world_size(group)
    parts = all_to_all(x, group).reshape(n, x.shape[0] // n, *x.shape[1:])
    acc = parts[0].float()
    for k in range(1, n):
        acc = acc + parts[k].float()
    return acc.to(x.dtype)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``x`` (equal shapes), stacked in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x[None].clone()
    src = _bytes(x)
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return torch.stack([o.view(x.dtype).reshape(x.shape) for o in outs])


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's row block of one global array (equal shapes),
    concatenated in rank order: the whole array on every rank."""
    return all_gather(x, group).reshape(-1, *x.shape[1:])


# ---------------------------------------------------------------------------
# the local launcher


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, backend, port, device, fn, args, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world_size)
        try:
            out = fn(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(
    fn: Callable,
    world_size: int,
    backend: str = "gloo",
    device="cuda",
    args: Tuple = (),
    timeout: float = 900.0,
):
    """Run ``fn(device, *args)`` in ``world_size`` new processes, each a rank
    of a fresh default process group (``backend`` over
    ``tcp://127.0.0.1:<free port>``, one CPU thread), and return rank 0's
    result.  ``fn`` and ``args`` must pickle (``fn`` by import path) and the
    result must be host data.  ``device`` is handed to ``fn`` as given; the
    mesh functions turn it into the rank's own device.  A rank that raises,
    or a run past ``timeout`` seconds, ends every rank and raises here with
    the rank's traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, port, device, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failure, waiting = None, None, set(range(world_size))
    deadline = time.monotonic() + timeout
    try:
        while waiting and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died before reporting (at start-up, or killed)
                dead = [r for r in waiting if procs[r].exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                               "before reporting")
                elif time.monotonic() > deadline:
                    failure = f"no result from every rank within {timeout:g} s"
                continue
            waiting.discard(rank)
            if not ok:
                failure = f"rank {rank} failed:\n{payload}"
            elif rank == 0:
                out = payload
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return out
