"""The host-side plan of the port's head kernel (``csrc/head_topk.cu``) and a
numpy emulation of how its blocks build and merge their lists, on the CPU.

The CUDA kernel cannot run here.  What its grid and its lists decide is:

 - the vocab split count (``split_count``): at one block per SM the grid
   of ceil(N / 64) row blocks x splits fills the card's 132 SMs at the
   decode rows (N = 1600) and the first step's (N = 320) without a second
   wave; every split holds a tile and together they cover a ragged vocab
   (``split_tiles``, the kernel's own formula);
 - the lists (k <= 16): each thread keeps a sorted list of k of its own
   columns of a row, seen in increasing id order; a logit not above the
   thread's k-th value, below the largest k-th value of the row's 4
   threads, or below the smallest of the 4 threads' ceil(k / 4)-th largest
   logit of the tile, is rejected before an insert; the first thread of each row's
   quad merges the other three lists into its own, the first warpgroup the
   second's, and the merge kernel merges the splits' sorted lists k-way
   (the best head first, ties to the lowest id).  The emulation follows
   those steps and must give the plain version's ids and values exactly,
   ties to the lowest id, for k = 5 and 16; for k = 128 (one list per row
   in shared memory) each split's exact top k, then the k-way merge.

No tolerance: the emulation takes the plain version's logits, so it must
match exactly."""

import numpy as np
import pytest
import torch

from openviic_tpu_torch.ops.head_topk import (
    MAX_SPLITS, TILE_COLS, TILE_ROWS, head_topk_reference, split_count, split_tiles)

SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("N", [320, 1600])
def test_split_count_fills_the_card_at_the_decode_shapes(N):
    V = 10_000
    splits = split_count(N, V, SMS)
    row_blocks = -(-N // TILE_ROWS)
    tiles = -(-V // TILE_COLS)
    assert row_blocks * splits <= SMS  # one wave
    # one more split would not fit, or none is left to take
    assert splits in (tiles, MAX_SPLITS) or row_blocks * (splits + 1) > SMS
    assert row_blocks * splits >= SMS - row_blocks  # no split count is idle beyond that
    assert {320: 26, 1600: 5}[N] == splits


@pytest.mark.parametrize("V", [10_000, 7094, 277, 128, 129, 1, 50_000])
@pytest.mark.parametrize("N", [1, 5, 37, 320, 1600, 3200, 20_000])
def test_every_split_holds_a_tile_and_the_splits_cover_the_vocab(N, V):
    splits = split_count(N, V, SMS)
    tiles = -(-V // TILE_COLS)
    assert 1 <= splits <= min(tiles, MAX_SPLITS)  # the merge kernel takes up to MAX_SPLITS
    bounds = split_tiles(V, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == tiles
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1  # contiguous
    sizes = [e - b for b, e in bounds]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert (tiles - 1) * TILE_COLS < V <= tiles * TILE_COLS  # the last tile is the ragged one


INT_MAX = 2**31 - 1


def _better(a, b):
    """(value, id) a before b: larger value, then lower id."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _push(lst, item):
    """The kernel's insert of an item that beats the last entry of a sorted
    list of fixed length."""
    at = len(lst) - 1
    while at > 0 and _better(item, lst[at - 1]):
        at -= 1
    lst.insert(at, item)
    lst.pop()


def _merge_list(lst, other):
    """The kernel's merge of a sorted list into another of the same length."""
    for item in other:
        if not _better(item, lst[-1]):
            break
        _push(lst, item)


def _empty(k):
    return [(-np.inf, INT_MAX)] * k


def emulate_row(logits, V, splits, k):
    """One row's top k as the kernel's blocks and merge kernel build it."""
    partials = []
    for t0, t1 in split_tiles(V, splits):
        if k > 16:  # one list per row: the split's exact top k
            best = _empty(k)
            for col in range(t0 * TILE_COLS, min(t1 * TILE_COLS, V)):
                if _better((logits[col], col), best[-1]):
                    _push(best, (logits[col], col))
            partials.append(best)
            continue
        groups = []
        for wg in (0, 1):  # alternate tiles
            quads = [_empty(k) for _ in range(4)]  # a thread's list: columns 8 j + 2 lane + e
            for tile in range(t0 + wg, t1, 2):
                cols = [[c for c in (tile * TILE_COLS + 8 * j + 2 * lane + e
                                     for j in range(TILE_COLS // 8) for e in range(2)) if c < V]
                        for lane in range(4)]
                # the largest k-th value of the row's quad, and the smallest of the
                # lanes' ceil(k / 4)-th largest logit of the tile
                jth = [sorted((logits[c] for c in lane_cols), reverse=True) for lane_cols in cols]
                need = -(-k // 4)
                tile_kth = min(v[need - 1] if len(v) >= need else -np.inf for v in jth)
                quad = max(max(lst[-1][0] for lst in quads), tile_kth)
                for lane, lst in enumerate(quads):
                    thr = lst[-1][0]
                    cands = [c for c in cols[lane] if logits[c] > thr and logits[c] >= quad]
                    for col in cands:
                        if logits[col] > thr:
                            _push(lst, (logits[col], col))
                            thr = lst[-1][0]
            for other in quads[1:]:
                _merge_list(quads[0], other)
            groups.append(quads[0])
        _merge_list(groups[0], groups[1])
        partials.append(groups[0])
    # the merge kernel: k times the best head of the splits' lists
    heads = [0] * len(partials)
    final = []
    for _ in range(k):
        best = None
        for s_, part in enumerate(partials):
            if heads[s_] < k and (best is None
                                  or _better(part[heads[s_]], partials[best][heads[best]])):
                best = s_
        final.append(partials[best][heads[best]])
        heads[best] += 1
    return final


@pytest.mark.parametrize("k", [5, 16, 128])
@pytest.mark.parametrize("N", [5, 1600])
def test_list_emulation_keeps_the_plain_top_k_with_ties_to_the_lowest_id(N, k):
    """Small-integer logits tie everywhere: the blocks' lists, the rejection
    against the k-th value, the quads', warpgroups' and splits' merges keep
    the plain version's ids, lowest id first among equals."""
    rng = np.random.default_rng(k)
    D, V = 16, 1000
    x = torch.from_numpy((rng.integers(-2, 3, size=(3, D)) / 4).astype(np.float32))
    w = torch.from_numpy((rng.integers(-2, 3, size=(V, D)) / 8).astype(np.float32))
    vals, idxs, _ = head_topk_reference(x, w, k)
    logits = (x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T).numpy()
    splits = split_count(N, V, SMS)
    for row in range(x.shape[0]):
        got = emulate_row(logits[row], V, splits, k)
        assert [i for _, i in got] == idxs[row].tolist()
        assert [v for v, _ in got] == vals[row].tolist()
        assert len(set(vals[row].tolist())) < k  # the case has ties
