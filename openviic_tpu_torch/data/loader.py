"""Host-side batching and prefetch (the port's counterpart of
``openviic_tpu/data/loader.py``).

 - shuffling from an integer seed: epoch e draws
   ``np.random.default_rng(seed + e)``'s permutation, and each
   ``__iter__`` advances the epoch counter, so a resumed run replays the
   stream of an uninterrupted one once its counter is restored;
 - variable-row feature keys padded to a multiple of ``bucket`` rows, or
   to explicit ``pad_sizes``;
 - a background thread assembles batches ahead of the consumer (numpy's
   file reads release the GIL), and ``device_prefetch`` moves them to the
   card from pinned memory."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from openviic_tpu_torch.data.instance import InstanceList

_PREFETCH_END = object()


def _threaded_prefetch(items: Iterable, fn: Callable, depth: int) -> Iterator:
    """Yield ``fn(item)`` for each item, computed up to ``depth`` ahead in a
    background thread.  Exceptions reach the consumer in stream order;
    abandoning the iterator (an error in the consuming loop, a
    ``KeyboardInterrupt``) stops the producer instead of leaving it blocked
    on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in items:
                if not _put(fn(item)):
                    return
        except BaseException as e:  # delivered in order, KeyboardInterrupt too
            _put(e)
        finally:
            _put(_PREFETCH_END)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            out = q.get()
            if out is _PREFETCH_END:
                return
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        stop.set()


def host_tensors(items: InstanceList, pin: bool = False) -> Dict[str, torch.Tensor]:
    """The batch's numeric arrays as CPU tensors (in pinned memory with ``pin``)."""
    out = {}
    for key, value in items.arrays().items():
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = tensor.pin_memory() if pin else tensor
    return out


def device_prefetch(iterable: Iterable[InstanceList], device, depth: int = 2) -> Iterator:
    """Yield (items, batch) for each host batch of ``iterable``: ``batch``
    holds its numeric arrays as tensors on ``device``.

    A background thread keeps ``depth`` batches ahead as CPU tensors, in
    pinned memory when ``device`` is a card.  The copy to the card is made
    on the consuming thread, on its current stream, with
    ``non_blocking=True``, one batch ahead of the one yielded: the host
    queues it without waiting, the stream orders it before the kernels that
    read it, and PyTorch's pinned allocator keeps the host buffer alive
    until the copy is done.  No side stream is used, so no
    ``wait_stream`` / ``record_stream`` is needed."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    host = _threaded_prefetch(iterable, lambda items: (items, host_tensors(items, pin=cuda)),
                              depth)

    def to_device(pair):
        items, tensors = pair
        return items, {k: v.to(device, non_blocking=cuda) for k, v in tensors.items()}

    ahead, error = None, None
    try:
        while error is None:
            try:
                nxt = to_device(next(host))
            except StopIteration:
                break
            except BaseException as exc:  # after the batches before it
                error = exc
                nxt = None
            if ahead is not None:
                yield ahead
            ahead = nxt
        if ahead is not None:
            yield ahead
        if error is not None:
            raise error
    finally:
        host.close()  # an abandoned stream stops its producer


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def make_instance_batch(samples, pad_sizes: Optional[Dict[str, int]] = None,
                        bucket: int = 8) -> InstanceList:
    """Collate samples into an ``InstanceList``: array keys not sized by
    ``pad_sizes`` whose rows vary (or that are 2-D or more) are padded to
    a multiple of ``bucket`` rows; 1-D token vectors, already of the
    vocab's fixed length, stay as they are."""
    samples = list(samples)
    pad_sizes = dict(pad_sizes) if pad_sizes else {}
    for key, v0 in samples[0].items():
        if key in pad_sizes or not isinstance(v0, np.ndarray) or v0.ndim < 1:
            continue
        lens = {s[key].shape[0] for s in samples}
        if v0.ndim >= 2 or len(lens) > 1:
            pad_sizes[key] = _round_up(max(lens), bucket)
    return InstanceList(samples, pad_sizes=pad_sizes)


def rank_part(indices: np.ndarray, part: Optional[Tuple[int, int]]) -> np.ndarray:
    """Rank ``r``'s contiguous share of a global batch's indices for
    ``part = (r, ranks)`` (``parallel/mesh.py::batch_shard``'s rows); a
    batch that the ranks do not divide stays whole, and every rank runs it
    unsharded, as the JAX trainer runs such a batch off its mesh."""
    if part is None or len(indices) % part[1]:
        return indices
    n = len(indices) // part[1]
    return indices[part[0] * n:(part[0] + 1) * n]


class DataLoader:
    """Batches of ``dataset`` in epoch order.  ``part = (r, ranks)`` makes
    every batch rank ``r``'s share of the global batch of ``batch_size``
    (``rank_part``): every rank draws the same order and reads only its own
    items, and bucket-pads its own rows (padded rows are masked, so only
    rounding tells it from the global batch's padding)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 pad_sizes: Optional[Dict[str, int]] = None, bucket: int = 8,
                 drop_last: bool = False, prefetch: int = 2,
                 part: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_sizes = pad_sizes
        self.bucket = bucket
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.part = part
        self.epoch = 0

    def _items(self) -> int:
        """The items an epoch."""
        return len(self.dataset)

    def __len__(self) -> int:
        n = self._items()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _read(self, indices) -> list:
        return [self.dataset[int(i)] for i in indices]

    def _make_batch(self, indices: np.ndarray) -> InstanceList:
        return make_instance_batch(self._read(indices), self.pad_sizes, self.bucket)

    def __iter__(self) -> Iterator[InstanceList]:
        order = self._order()
        self.epoch += 1
        batches = [rank_part(order[i * self.batch_size:(i + 1) * self.batch_size], self.part)
                   for i in range(len(self))]
        if self.prefetch <= 0:
            for idxs in batches:
                yield self._make_batch(idxs)
            return
        yield from _threaded_prefetch(batches, self._make_batch, self.prefetch)
