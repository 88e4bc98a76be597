"""The port's host-sharded loader (``openviic_tpu_torch.data.grain_loader``)
against the JAX package's Grain pipeline (``openviic_tpu.data.grain_loader``)
on the CPU: batch for batch over shuffle, shard counts, ragged shards,
``drop_last`` and epochs, and Grain's own shuffle permutation index for
index."""

import grain
import numpy as np
import pytest

from openviic_tpu.data import datasets as jax_datasets
from openviic_tpu.data.grain_loader import GrainDataLoader as JaxGrainDataLoader
from openviic_tpu_torch.data import datasets
from openviic_tpu_torch.data.grain_loader import GrainDataLoader, grain_permutation
from openviic_tpu_torch.data.vocab import Vocab
from tests.test_torch_port_data import dataset_configs

EPOCHS = 3
ALL_N = list(range(1, 71)) + [127, 128, 129, 1000]


@pytest.fixture(scope="module")
def both_datasets(tiny_dataset_dir):
    """{kind: (JAX dataset, the port's)} over the tiny train split: the
    caption-level feature dataset (8 items) and the image-level dictionary
    dataset (4 items)."""
    jax_cfg, cfg = dataset_configs(tiny_dataset_dir)
    from openviic_tpu.data.vocab import Vocab as JaxVocab

    jax_vocab, vocab = JaxVocab(jax_cfg), Vocab.from_config(cfg)
    path = str(tiny_dataset_dir / "train.json")
    return {
        "feature": (jax_datasets.FeatureDataset(path, jax_vocab, jax_cfg),
                    datasets.FeatureDataset(path, vocab, cfg)),
        "dict": (jax_datasets.DictionaryDataset(path, jax_vocab, jax_cfg),
                 datasets.DictionaryDataset(path, vocab, cfg)),
    }


def assert_batches_equal(got, want, where):
    assert len(got) == len(want), f"{where}: {len(got)} batches, want {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        ga, wa = g.arrays(), w.arrays()
        assert set(ga) == set(wa), where
        for key in wa:
            np.testing.assert_array_equal(np.asarray(ga[key]), np.asarray(wa[key]),
                                          err_msg=f"{where} batch {i} {key}")


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shard_count", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("kind", ["feature", "dict"])
def test_batches_equal_jax_grain_loader(both_datasets, kind, shuffle, shard_count, drop_last):
    """Every shard's batches in epochs 0-2 equal JAX's (8 and 4 items: 3
    shards divide neither), and every shard yields as many batches."""
    jax_ds, ds = both_datasets[kind]
    counts = set()
    for shard in range(shard_count):
        kw = dict(batch_size=2 if kind == "dict" else 3, shuffle=shuffle, seed=13,
                  drop_last=drop_last, pad_sizes={"region_features": 8},
                  shard_index=shard, shard_count=shard_count)
        want_loader, loader = JaxGrainDataLoader(jax_ds, **kw), GrainDataLoader(ds, **kw)
        for epoch in range(EPOCHS):
            want, got = list(want_loader), list(loader)
            assert_batches_equal(got, want, f"shard {shard} epoch {epoch}")
            assert len(got) == len(loader) == len(want_loader)
            counts.add(len(got))
        assert loader.epoch == want_loader.epoch == EPOCHS
    assert len(counts) == 1


def test_resume_replays_the_stream_and_threads_read_alike(both_datasets):
    """Setting ``epoch`` back replays that epoch (the trainer's resume);
    one or several read threads give the same batches; the shard defaults
    to the process group's (none here: 0 of 1)."""
    _, ds = both_datasets["feature"]
    loader = GrainDataLoader(ds, batch_size=3, shuffle=True, seed=5, read_threads=1)
    assert (loader.shard_index, loader.shard_count) == (0, 1)
    first, second = list(loader), list(loader)
    assert any(not np.array_equal(a["caption_tokens"], b["caption_tokens"])
               for a, b in zip(first, second))
    loader.epoch = 1
    assert_batches_equal(list(loader), second, "replayed epoch 1")
    threaded = GrainDataLoader(ds, batch_size=3, shuffle=True, seed=5, read_threads=4)
    assert_batches_equal(list(threaded), first, "4 read threads")
    with pytest.raises(ValueError, match="out of range"):
        GrainDataLoader(ds, batch_size=3, shard_index=2, shard_count=2)


def test_shards_partition_the_epoch(both_datasets):
    """3 shards of 8 items: 2 each, disjoint, from one shuffled order."""
    _, ds = both_datasets["feature"]
    orders = [GrainDataLoader(ds, 1, shuffle=True, seed=7, shard_index=i,
                              shard_count=3).order(0) for i in range(3)]
    assert [len(o) for o in orders] == [2, 2, 2]
    seen = np.concatenate(orders)
    assert len(set(seen.tolist())) == 6
    full = grain_permutation(len(ds), 7)
    np.testing.assert_array_equal(np.sort(seen), np.sort(full[:6]))


@pytest.mark.parametrize("seed,sizes", [(0, ALL_N), (17, ALL_N),
                                        (2**32 - 1, [1, 2, 3, 70, 127, 128, 129, 1000])],
                         ids=["seed0", "seed17", "seed_top"])
def test_permutation_equals_grain_shuffle(seed, sizes):
    """``grain_permutation`` is ``grain.MapDataset.range(n).shuffle(seed)``,
    index for index."""
    for n in sizes:
        want = np.asarray(grain.MapDataset.range(n).shuffle(seed=seed).batch(n)[0])
        np.testing.assert_array_equal(grain_permutation(n, seed), want, err_msg=f"n = {n}")


@pytest.mark.parametrize("n,seed", [(65537, 0), (100_000, 17), (262_145, 3), (600_000, 5)])
def test_permutation_equals_grain_shuffle_over_wide_blocks(n, seed):
    """At the 16-bit block's edge and over 18- and 20-bit blocks (a COCO
    train split's ~566k captions), every 97th position and the last five
    against Grain's; at n - 1 = 2**16 and 2**18 Grain's last position
    repeats its first, and so does the port's."""
    ds = grain.MapDataset.range(n).shuffle(seed=seed)
    got = grain_permutation(n, seed)
    positions = list(range(0, n, 97)) + list(range(n - 5, n))
    np.testing.assert_array_equal(got[positions], [ds[i] for i in positions],
                                  err_msg=f"n = {n}")
    if n - 1 in (2**16, 2**18):
        assert got[n - 1] == got[0] and n - 1 not in set(got.tolist())


def test_permutation_is_a_permutation_and_refuses_grains_bad_seeds(both_datasets):
    for n in (2, 300, 65536):
        np.testing.assert_array_equal(np.sort(grain_permutation(n, 3)), np.arange(n))
    _, ds = both_datasets["feature"]
    with pytest.raises(ValueError, match="2\\*\\*32-1"):
        GrainDataLoader(ds, 2, shuffle=True, seed=2**32).order(0)
