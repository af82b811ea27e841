"""One device-to-host copy for a frame's observables.

The counterpart of ``datmo_using_optical_flow_tpu.utils.hostpack``: every
leaf of a fixed-structure tree (dicts in sorted key order, NamedTuples and
tuples in field order, as ``jax.tree`` flattens them) is reinterpreted as
bytes on the device (``Tensor.view(torch.uint8)``; bool as one byte) and the
bytes are concatenated into one flat uint8 buffer, the JAX package's layout.
Buffers of several frames are stacked on the device and copied to the host
together; :meth:`HostPacker.unpack` rebuilds the tree of numpy arrays.
:class:`HostMirror` is the two background threads both file runners put
behind their loops.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

_SUPPORTED = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.float32)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree`` order: dict values by sorted key, sequences
    (NamedTuples included) in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def _rebuild(example, leaves):
    """``example``'s structure with the next leaves of the iterator ``leaves``."""
    if isinstance(example, dict):
        return {k: _rebuild(example[k], leaves) for k in sorted(example)}
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(*(_rebuild(item, leaves) for item in example))
    if isinstance(example, (tuple, list)):
        return type(example)(_rebuild(item, leaves) for item in example)
    return next(leaves)


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of one leaf (bool widened to one byte)."""
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"HostPacker: unsupported leaf dtype {x.dtype}")
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous().reshape(-1).view(torch.uint8)


class HostPacker:
    """Pack and unpack a fixed-structure tree through one flat uint8 buffer."""

    def __init__(self, example_tree):
        self._example = example_tree
        self._specs = [(tuple(t.shape), t.dtype) for t in tree_leaves(example_tree)]
        self.nbytes = sum(int(np.prod(s, dtype=np.int64)) * (1 if d == torch.bool else d.itemsize)
                          for s, d in self._specs)

    def pack(self, tree) -> torch.Tensor:
        """The tree's leaves as one flat uint8 tensor on their device."""
        return torch.cat([_to_bytes(leaf) for leaf in tree_leaves(tree)])

    @staticmethod
    def stack(bufs) -> torch.Tensor:
        """Stack packed buffers on their device, for one copy to the host."""
        return torch.stack(list(bufs))

    def unpack(self, buf: np.ndarray):
        """Flat uint8 host vector -> the tree with numpy leaves (original dtypes)."""
        buf = np.ascontiguousarray(np.asarray(buf, dtype=np.uint8))
        out = []
        off = 0
        for shape, dtype in self._specs:
            n = int(np.prod(shape, dtype=np.int64))
            npdtype = np.dtype(str(dtype).replace("torch.", ""))
            seg = buf[off:off + n * npdtype.itemsize]
            off += n * npdtype.itemsize
            if npdtype == np.bool_:
                a = seg.astype(np.bool_)
            elif npdtype == np.uint8:
                a = seg
            else:
                a = seg.copy().view(npdtype)
            out.append(a.reshape(shape))
        return _rebuild(self._example, iter(out))


class HostMirror:
    """Two background threads behind a runner's loop, through bounded queues
    (a slow consumer holds the loop back instead of piling up device
    buffers): a transfer thread copies a drained batch of packed device
    buffers (up to 16) to the host in one copy, and a writer thread hands
    each frame's unpacked observables to ``mirror(frame, obs)``, in order.

    Each thread records its first error and keeps draining its queue, so the
    loop never blocks on a dead consumer; :meth:`put`, :meth:`flush` and
    :meth:`check` re-raise it.  ``seconds`` holds each thread's busy time.
    """

    def __init__(self, packer: HostPacker, mirror: Callable[[int, object], None]):
        self._packer, self._mirror = packer, mirror
        self._work: queue.Queue = queue.Queue(maxsize=32)   # packed device buffers
        self._ready: queue.Queue = queue.Queue(maxsize=4)   # host batches
        self._exc: list[BaseException] = []
        self.seconds = {"transfer": 0.0, "mirror": 0.0}
        self._threads = [threading.Thread(target=self._transfer, daemon=True),
                         threading.Thread(target=self._write, daemon=True)]
        for t in self._threads:
            t.start()

    def check(self) -> None:
        """Raise the first error either thread recorded."""
        if self._exc:
            raise self._exc[0]

    def put(self, frame: int, buf: torch.Tensor) -> None:
        """Queue frame ``frame``'s packed buffer (an earlier error raises first)."""
        self.check()
        self._work.put((frame, buf))

    def flush(self) -> None:
        """Wait until every queued frame has been mirrored."""
        self._work.join()
        self._ready.join()
        self.check()

    def close(self) -> None:
        """Mirror what is queued and stop both threads (call :meth:`check`
        after it: close runs in a ``finally`` and must not mask the loop's
        own error)."""
        self._work.put(None)
        for t in self._threads:
            t.join()

    def _transfer(self) -> None:
        done = False
        while not done:
            batch = [self._work.get()]
            while len(batch) < 16:
                try:
                    batch.append(self._work.get_nowait())
                except queue.Empty:
                    break
            got = len(batch)
            if batch[-1] is None:
                done = True
                batch.pop()
            if batch and not self._exc:
                try:
                    t0 = time.perf_counter()
                    bufs = HostPacker.stack([b for _, b in batch]).cpu().numpy()
                    self.seconds["transfer"] += time.perf_counter() - t0
                    self._ready.put(([i for i, _ in batch], bufs))
                except BaseException as e:  # noqa: BLE001  (re-raised in the loop's thread)
                    self._exc.append(e)
            for _ in range(got):
                self._work.task_done()
        self._ready.put(None)

    def _write(self) -> None:
        while True:
            item = self._ready.get()
            if item is None:
                self._ready.task_done()
                return
            frames, bufs = item
            if not self._exc:
                try:
                    t0 = time.perf_counter()
                    for i, buf in zip(frames, bufs):
                        self._mirror(i, self._packer.unpack(buf))
                    self.seconds["mirror"] += time.perf_counter() - t0
                except BaseException as e:  # noqa: BLE001  (re-raised in the loop's thread)
                    self._exc.append(e)
            self._ready.task_done()
