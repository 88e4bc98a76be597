"""The host-sharded loader (the port's counterpart of
``openviic_tpu/data/grain_loader.py``), without the ``grain`` package.

``GrainDataLoader`` is a ``DataLoader`` that yields the batches of the JAX
package's Grain pipeline:

 - it shuffles the whole index space with Grain's own permutation of
   ``MapDataset.shuffle(seed=seed + epoch)`` (``grain_permutation``: a
   Simon block cipher over ``ceil(log2(n - 1))`` bits, made even and at
   least 16, keyed by ``std::seed_seq``, with cycle walking, as Grain's
   ``index_shuffle`` computes it at 4 rounds);
 - each shard takes ``order[shard_index:stop:shard_count]``, ``stop``
   keeping every shard at ``n // shard_count`` elements, so every rank runs
   the same number of steps;
 - it batches as ``DataLoader`` does (honouring ``drop_last``, read ahead
   in a background thread), the items of a batch read by ``read_threads``
   threads;
 - ``shard_index`` and ``shard_count`` default to this process's rank and
   the group's size (``parallel/runtime.py``).

The epoch counter advances on each ``__iter__``, so a resumed run replays
an uninterrupted one's stream once it is restored, as with ``DataLoader``."""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from openviic_tpu_torch.data.instance import InstanceList
from openviic_tpu_torch.data.loader import DataLoader

_M32 = 0xFFFFFFFF
MIN_BLOCK_BITS = 16  # Grain's kMinBlockSize
SHUFFLE_ROUNDS = 4  # MapDataset.shuffle's


def _seed_seq(seed: int, n: int) -> List[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    v, s = [seed & _M32], 1
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        r2 = (r1 + s if k == 0 else r1 + k % n + v[k - 1] if k <= s else r1 + k % n) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def grain_permutation(n: int, seed: int, rounds: int = SHUFFLE_ROUNDS) -> np.ndarray:
    """``order[i]``: the index that Grain's ``MapDataset.range(n).shuffle(seed)``
    puts at position ``i`` (its ``index_shuffle(i, max_index=n - 1, seed,
    rounds)``), for all ``i`` at once."""
    if n <= 1:
        return np.zeros(n, np.int64)
    max_index = n - 1
    bits = int(math.ceil(math.log2(max_index)))
    bits = max(bits + bits % 2, MIN_BLOCK_BITS)
    w = bits // 2
    mask = np.uint64((1 << w) - 1)
    keys = [np.uint64(k) & mask for k in _seed_seq(seed, rounds)]

    def rotl(x, r):
        r %= w
        if r == 0:
            return x
        return ((x << np.uint64(r)) | (x >> np.uint64(w - r))) & mask

    def f(x):
        return (rotl(x, 8) & rotl(x, 1)) ^ rotl(x, 2)

    def encrypt(v):
        x, y = (v >> np.uint64(w)) & mask, v & mask
        for i in range(0, rounds, 2):
            x = x ^ f(y) ^ keys[i]
            y = y ^ f(x) ^ keys[i + 1]
        return (x << np.uint64(w)) | y

    # the cipher over its whole domain, then each index walks its cycle to
    # the first value that is an index (cycle walking): the walks together
    # visit each value of the domain at most once.  Grain reads only the
    # domain's bits of a position: when n - 1 is 2**bits (n = 65 537,
    # 262 145, ...), the domain misses it and position n - 1 repeats
    # position 0's index, so index n - 1 is never drawn; this does the same
    domain = 1 << bits
    table = encrypt(np.arange(domain, dtype=np.uint64)).tolist()
    out = np.empty(n, np.int64)
    for i in range(n):
        x = table[i & (domain - 1)]
        while x > max_index:
            x = table[x]
        out[i] = x
    return out


class GrainDataLoader(DataLoader):
    """The JAX package's ``GrainDataLoader`` (same arguments): ``DataLoader``'s,
    and ``shard_index`` / ``shard_count`` (default: this rank and the
    group's size) and ``read_threads``; and ``DataLoader``'s ``part`` of
    each batch of the shard."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 pad_sizes: Optional[Dict[str, int]] = None, bucket: int = 8,
                 drop_last: bool = False, prefetch: int = 2,
                 shard_index: Optional[int] = None, shard_count: Optional[int] = None,
                 read_threads: int = 2, part: Optional[Tuple[int, int]] = None):
        from openviic_tpu_torch.parallel import runtime

        super().__init__(dataset, batch_size, shuffle, seed, pad_sizes, bucket, drop_last,
                         max(1, prefetch), part)
        if shard_index is None:
            shard_index = runtime.process_index()
        if shard_count is None:
            shard_count = runtime.process_count()
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} out of range for {shard_count} shards")
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.read_threads = read_threads
        self._pool = None

    def _items(self) -> int:
        # every shard is cut to n // shard_count elements: unequal shards
        # would run different step counts and stall the collectives
        return len(self.dataset) // self.shard_count

    def order(self, epoch: int) -> np.ndarray:
        """This shard's dataset indices in epoch ``epoch``, in order."""
        n = len(self.dataset)
        if self.shuffle:
            seed = self.seed + epoch
            if not 0 <= seed < 2**32:  # as Grain's shuffle refuses it
                raise ValueError(f"Seed must be an integer between 0 and 2**32-1 (got {seed=}).")
            order = grain_permutation(n, seed)
        else:
            order = np.arange(n)
        return order[self.shard_index:self._items() * self.shard_count:self.shard_count]

    def _order(self) -> np.ndarray:
        return self.order(self.epoch)

    def _read(self, indices) -> list:
        read = self._pool.map if self._pool is not None else map
        return list(read(lambda i: self.dataset[int(i)], indices))

    def __iter__(self) -> Iterator[InstanceList]:
        self._pool = ThreadPoolExecutor(self.read_threads) if self.read_threads > 1 else None
        try:
            yield from super().__iter__()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
