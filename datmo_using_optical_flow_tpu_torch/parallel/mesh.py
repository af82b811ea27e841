"""Process groups for the row-sharded flow, the counterpart of
``datmo_using_optical_flow_tpu.parallel.mesh``.

The JAX package shards a grid by rows over a ``'space'`` mesh axis inside
``shard_map``.  Here each shard is a process (a *rank*) of a
``torch.distributed`` group, and a :class:`RowGroup` is one rank's view of
that group: its index, the group's size, the backend, the rank's device, and
the three transfers the sharded functions need (neighbour rows, the gather of
every rank's rows, a sum).  Everything is passed explicitly: nothing reads a
cluster's environment, and nothing switches backend or device on a failure.

Backends:

* ``"nccl"``: one card per rank, tensors exchanged on the card;
* ``"gloo"``: CPU tensors, or CUDA tensors staged through host memory for the
  transfers alone.  Several ranks may then share one card (NCCL refuses two
  ranks on one GPU).

The JAX package's stream axis maps each feed to a device.  The port's feeds
run one after another on one card (``parallel/streams``), so
:func:`stream_mesh` and :func:`stream_space_mesh` give each rank its share of
the feeds (a local stream count) and, for the second, the space group that
row-shards each of its feeds.

:func:`spawn` runs a function on every rank of a new group, one process per
rank (start method ``spawn``, a ``file://`` rendezvous), and returns each
rank's result.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class RowGroup:
    """One rank's view of a group of ranks that share a grid by rows.

    ``rank`` is the index within the group (the JAX ``axis_index``),
    ``world_size`` its size (``psum(1, axis)``), ``ranks`` the members' global
    ranks in row order, ``pg`` the process group (``None``: the default one).
    """

    def __init__(self, rank: int, world_size: int, backend: str, device: torch.device,
                 pg=None, ranks: Sequence[int] | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device per rank, got {device}")
        self.rank, self.world_size = rank, world_size
        self.backend, self.device, self.pg = backend, device, pg
        self.ranks = tuple(range(world_size) if ranks is None else ranks)
        # gloo moves CPU tensors only: CUDA tensors travel through host memory
        self.staged = backend == "gloo" and device.type == "cuda"

    def __repr__(self) -> str:
        return (f"RowGroup(rank={self.rank}, world_size={self.world_size}, "
                f"backend={self.backend!r}, device={self.device}, ranks={self.ranks})")

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().cpu() if self.staged else t.contiguous()

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.staged else self.device)

    def neighbour_rows(self, top: torch.Tensor, bottom: torch.Tensor
                       ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """Send ``top`` to the rank above and ``bottom`` to the rank below;
        receive the rank above's bottom rows and the rank below's top rows
        (the two ``ppermute`` of JAX ``halo.py:33-36``).  ``None`` where there
        is no neighbour (the global edges)."""
        ops, from_above, from_below = [], None, None
        if self.rank > 0:
            peer = self.ranks[self.rank - 1]
            from_above = self._buffer(bottom.shape, bottom.dtype)
            ops += [dist.P2POp(dist.isend, self._wire(top), peer, self.pg),
                    dist.P2POp(dist.irecv, from_above, peer, self.pg)]
        if self.rank < self.world_size - 1:
            peer = self.ranks[self.rank + 1]
            from_below = self._buffer(top.shape, top.dtype)
            ops += [dist.P2POp(dist.isend, self._wire(bottom), peer, self.pg),
                    dist.P2POp(dist.irecv, from_below, peer, self.pg)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(None if t is None else t.to(self.device) for t in (from_above, from_below))

    def all_gather_rows(self, block: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``block`` concatenated along ``dim`` in rank order
        (``all_gather(..., tiled=True)``).  Every rank's block has one shape."""
        wire = self._wire(block)
        parts = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(parts, wire, group=self.pg)
        return torch.cat(parts, dim=dim).to(self.device)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (``psum``), on this rank's device."""
        wire = self._wire(x).clone()
        dist.all_reduce(wire, group=self.pg)
        return wire.to(self.device)

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def init_row_group(rank: int, world_size: int, init_method: str, backend: str,
                   device: str | torch.device) -> RowGroup:
    """Join the default process group as ``rank`` of ``world_size`` and return
    the row group over all its ranks.  ``init_method`` is the rendezvous
    (``file://...`` or ``tcp://host:port``); a CUDA ``device`` becomes the
    rank's current device first."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, device_id=dev if backend == "nccl" else None)
    return RowGroup(rank, world_size, backend, dev)


def stream_mesh(group: RowGroup, n_streams: int) -> range:
    """The feeds this rank runs when ``n_streams`` feeds are shared over the
    group, one block of ``n_streams / world_size`` per rank (JAX
    ``stream_mesh``: one feed per device)."""
    if n_streams % group.world_size:
        raise ValueError(f"{n_streams} streams do not divide over {group.world_size} ranks")
    per = n_streams // group.world_size
    return range(group.rank * per, (group.rank + 1) * per)


def stream_space_mesh(group: RowGroup, n_streams: int, n_space: int
                      ) -> tuple[range, RowGroup]:
    """The 2-D layout of JAX ``stream_space_mesh``: the group's ranks split
    into ``world_size / n_space`` space groups of ``n_space`` consecutive
    ranks, each row-sharding its share of the ``n_streams`` feeds.  Returns
    this rank's feeds and its space group.  Every rank of ``group`` calls it
    (each space group is created by all of them)."""
    if group.world_size % n_space:
        raise ValueError(f"{group.world_size} ranks do not form space groups of {n_space}")
    n_groups = group.world_size // n_space
    if n_streams % n_groups:
        raise ValueError(f"{n_streams} streams do not divide over {n_groups} space groups")
    mine = group.rank // n_space
    space = None
    for g in range(n_groups):
        members = [group.ranks[g * n_space + i] for i in range(n_space)]
        pg = dist.new_group(members, backend=group.backend)
        if g == mine:
            space = RowGroup(group.rank % n_space, n_space, group.backend, group.device,
                             pg, members)
    per = n_streams // n_groups
    return range(mine * per, (mine + 1) * per), space


def shard_rows(full: torch.Tensor, group: RowGroup) -> torch.Tensor:
    """This rank's rows of a (..., H, W) grid, on its device: H / world_size
    rows, in rank order.  Raises unless the ranks share the rows evenly
    (every rank's block has one shape, as the JAX shapes require)."""
    h = full.shape[-2]
    if h % group.world_size:
        raise ValueError(f"{h} rows do not divide over {group.world_size} ranks")
    hl = h // group.world_size
    return full[..., group.rank * hl:(group.rank + 1) * hl, :].to(group.device).contiguous()


def _to_cpu(out):
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_cpu(x) for x in out)
    return out


def sharded_calls(group: RowGroup, calls: Sequence[tuple[Callable, tuple, dict]]) -> list:
    """A rank program for :func:`spawn`: each ``(fn, args, kwargs)`` of
    ``calls`` run as ``fn(*args, group=group, **kwargs)`` with every tensor of
    ``args`` replaced by this rank's rows of it (:func:`shard_rows`; other
    arguments as given), in order on every rank.  Returns the results, on
    the CPU."""
    return [_to_cpu(fn(*(shard_rows(a, group) if isinstance(a, torch.Tensor) else a
                         for a in args), group=group, **kwargs))
            for fn, args, kwargs in calls]


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               devices: Sequence[str], workdir: str, args: tuple) -> None:
    """One spawned rank: join the group, run ``fn(group, *args)``, leave its
    result in ``workdir``."""
    torch.set_num_threads(1)
    # one host: the ranks' transports meet on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    group = init_row_group(rank, world_size, f"file://{os.path.join(workdir, 'rendezvous')}",
                           backend, devices[rank])
    try:
        out = fn(group, *args)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        group.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world_size: int, backend: str, devices: Sequence[str],
          *args, timeout: float = 600.0) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` new processes, one per rank,
    and return each rank's result (picklable, on the CPU) in rank order.

    ``fn`` must be a function of an importable module (each child imports
    it anew).  ``devices``: one device per rank.  Each child runs
    one torch thread.  A rank's exception is raised here (the other ranks are
    stopped); so is a :class:`TimeoutError` when the ranks have not all ended
    within ``timeout`` seconds.  When a rank runs on the card, the kernels
    are built here first, so the ranks do not race to build them."""
    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    devices = [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if any(torch.device(d).type == "cuda" for d in devices):
        from datmo_using_optical_flow_tpu_torch.kernels import build

        build.build()
    with tempfile.TemporaryDirectory(prefix="datmo_ranks_") as workdir:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, world_size, backend, devices, workdir, args),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0) + 0.1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__qualname__} did not end "
                                       f"within {timeout:g} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
