"""The port's data side (``openviic_tpu_torch.data``: the vocab built from
caption files, the feature datasets, the loader and its prefetch) against
the JAX package's ``openviic_tpu.data`` on the CPU, on the tiny dataset of
``tests/conftest.py`` and on constructed cases."""

import json
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.data import datasets as jax_datasets
from openviic_tpu.data import loader as jax_loader
from openviic_tpu.data.instance import Instance as JaxInstance
from openviic_tpu.data.instance import collate_fn as jax_collate_fn
from openviic_tpu.data.vocab import Vocab as JaxVocab
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.data import datasets, loader
from openviic_tpu_torch.data.instance import Instance, InstanceList, collate_fn
from openviic_tpu_torch.data.vocab import Vocab, load_vocab
from tests.conftest import make_dataset_config


def dataset_configs(root, **overrides):
    """The same DATASET config for both packages."""
    raw = make_dataset_config(root).to_dict()
    raw.update(overrides)
    return JaxConfigNode(raw), ConfigNode(raw)


def assert_vocab_equal(got: Vocab, want: JaxVocab):
    assert got.itos == want.itos
    assert dict(got.stoi) == dict(want.stoi)
    assert got.freqs == want.freqs
    assert got.specials == want.specials
    assert got.max_caption_length == want.max_caption_length
    for name in ("padding_idx", "bos_idx", "eos_idx", "unk_idx"):
        assert getattr(got, name) == getattr(want, name), name


def tied_split_files(root):
    """Caption files whose words tie in frequency across all three splits
    (the test split counts too: the reference's leakage), punctuation
    split off by the preprocessing."""
    splits = {"train": ["b b a a c", "b a d, e!"], "dev": ["e c x"], "test": ["y y x z"]}
    for split, caps in splits.items():
        data = {"images": [{"id": 0, "file_name": "x.jpg"}],
                "annotations": [{"image_id": 0, "caption": c} for c in caps]}
        with open(root / f"{split}.json", "w") as f:
            json.dump(data, f)


@pytest.mark.parametrize("min_freq", [1, 2])
@pytest.mark.parametrize("data", ["tiny", "tied"])
def test_vocab_from_config_equals_jax(tiny_dataset_dir, tmp_path, min_freq, data):
    root = tiny_dataset_dir
    if data == "tied":
        tied_split_files(tmp_path)
        root = tmp_path
    jax_cfg, cfg = dataset_configs(root, MIN_FREQ=min_freq)
    want, got = JaxVocab(jax_cfg), Vocab.from_config(cfg)
    assert_vocab_equal(got, want)
    if data == "tied":  # a, b 3 each; c, e, x, y 2; !, ",", d, z 1: ties alphabetical
        assert got.itos[4:] == ["a", "b", "c", "e", "x", "y", "!", ",", "d", "z"][
            :10 if min_freq == 1 else 6]
    assert got == Vocab.from_config(cfg) and not (got != Vocab.from_config(cfg))
    for caption in (["một", "con", "mèo"], ["never-seen", "con"]):
        np.testing.assert_array_equal(got.encode_caption(caption), want.encode_caption(caption))


def test_vocab_pickles_round_trip(tiny_dataset_dir, tmp_path):
    """The JAX package's pickle reads as the port's vocab; the port's own
    pickle reads back equal; every other global is refused."""
    jax_cfg, cfg = dataset_configs(tiny_dataset_dir)
    want, mine = JaxVocab(jax_cfg), Vocab.from_config(cfg)
    with open(tmp_path / "jax.bin", "wb") as f:
        pickle.dump(want, f)
    with open(tmp_path / "port.bin", "wb") as f:
        pickle.dump(mine, f)
    assert_vocab_equal(load_vocab(tmp_path / "jax.bin"), want)
    back = load_vocab(tmp_path / "port.bin")
    assert back == mine and back.tokenizer is None
    assert_vocab_equal(back, want)
    with open(tmp_path / "evil.bin", "wb") as f:
        pickle.dump(threading.Lock, f)
    with pytest.raises(pickle.UnpicklingError, match="refused global"):
        load_vocab(tmp_path / "evil.bin")


def test_vocab_extend_and_refusals(tiny_dataset_dir, tmp_path):
    jax_cfg, cfg = dataset_configs(tiny_dataset_dir)
    want, got = JaxVocab(jax_cfg), Vocab.from_config(cfg)
    tied_split_files(tmp_path)
    jax_other, other = dataset_configs(tmp_path)
    want.extend(JaxVocab(jax_other), sort=True)
    got.extend(Vocab.from_config(other), sort=True)
    assert got.itos == want.itos and dict(got.stoi) == dict(want.stoi)
    for key, value in (("PRETRAINED_LANGUAGE_MODEL", "vinai/phobert-base"),
                       ("USE_MAPPING", True)):
        raw = make_dataset_config(tiny_dataset_dir).to_dict()
        raw["VOCAB"][key] = value
        with pytest.raises(NotImplementedError, match=key):
            Vocab.from_config(ConfigNode(raw))
    # word vectors are ported (tests/test_torch_port_word_embedding.py): a
    # name no class registers raises KeyError in both packages
    raw = make_dataset_config(tiny_dataset_dir).to_dict()
    raw["VOCAB"]["WORD_EMBEDDING"] = "fasttext"
    for build in (lambda: Vocab.from_config(ConfigNode(raw)),
                  lambda: JaxVocab(type(jax_cfg)(raw))):
        with pytest.raises(KeyError, match="'fasttext'"):
            build()


def assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value, key


@pytest.fixture(scope="module")
def both(tiny_dataset_dir):
    """Each package's vocab and its six datasets over the tiny dataset."""
    jax_cfg, cfg = dataset_configs(tiny_dataset_dir)
    jax_vocab, vocab = JaxVocab(jax_cfg), Vocab.from_config(cfg)
    out = {}
    for split in ("train", "dev", "test"):
        path = str(tiny_dataset_dir / f"{split}.json")
        out[split] = (jax_datasets.FeatureDataset(path, jax_vocab, jax_cfg),
                      datasets.FeatureDataset(path, vocab, cfg))
        out[f"{split}_dict"] = (jax_datasets.DictionaryDataset(path, jax_vocab, jax_cfg),
                                datasets.DictionaryDataset(path, vocab, cfg))
    return out


@pytest.mark.parametrize("name", ["train", "dev", "test", "train_dict", "dev_dict",
                                  "test_dict"])
def test_dataset_items_equal_jax(both, name):
    want, got = both[name]
    assert len(got) == len(want)
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])
    if not name.endswith("dict"):
        assert got.captions == want.captions


def test_feature_source_lru_and_casts(tmp_path):
    """The per-directory LRU (shared, bounded by the largest size asked
    for) and the f64 / f16 -> f32 casts, against the JAX source."""
    d = tmp_path / "feats"
    d.mkdir()
    for i in range(5):
        np.save(d / f"{i}.npy", {"region_features": np.full((2, 3), i, np.float16),
                                 "region_boxes": np.full((2, 4), i / 7, np.float64),
                                 "ids": np.arange(2, dtype=np.int64)}, allow_pickle=True)
    src = datasets._FeatureSource(str(d), cache_size=2)
    a = src.load(0)
    assert src.load(0) is a
    src.load(1)
    src.load(2)
    assert src.load(0) is not a  # evicted
    src2 = datasets._FeatureSource(str(d), cache_size=1)
    assert src2.load(0) is src.load(0)  # shared, bound still 2
    plain = datasets._FeatureSource(str(d))
    assert plain.load(3) is not plain.load(3)
    want = jax_datasets._FeatureSource(str(d)).load(4)
    got = plain.load(4)
    assert_items_equal(got, want)
    assert got["region_features"].dtype == got["region_boxes"].dtype == np.float32
    assert got["ids"].dtype == np.int64


class ToyDataset:
    """Samples of varying region rows; ``fail_at`` raises at that index."""

    def __init__(self, cls, n=21, fail_at=None):
        self.cls, self.n, self.fail_at = cls, n, fail_at
        self.rows = [int(r) for r in np.random.default_rng(0).integers(3, 12, size=n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError(f"boom at {i}")
        return self.cls(idx=np.int32(i), region_features=np.full((self.rows[i], 4), i, np.float32),
                        region_boxes=np.full((self.rows[i], 4), i / 3, np.float32),
                        tokens=np.full((7,), i, np.int32), name=f"img{i}")


@pytest.mark.parametrize("kwargs", [
    {"shuffle": True, "seed": 13},
    {"shuffle": True, "seed": 17, "drop_last": True},
    {"shuffle": False},
    {"shuffle": True, "seed": 3, "pad_sizes": {"region_features": 16, "region_boxes": 12}},
    {"shuffle": True, "seed": 3, "bucket": 4, "prefetch": 0},
], ids=["seed13", "drop-last", "ordered", "pad-sizes", "bucket4-noprefetch"])
def test_loader_batches_equal_jax(kwargs):
    """Three epochs of batches, each epoch's permutation drawn from seed +
    epoch, equal to the JAX loader's, arrays bit for bit."""
    want = jax_loader.DataLoader(ToyDataset(JaxInstance), 4, **kwargs)
    got = loader.DataLoader(ToyDataset(Instance), 4, **kwargs)
    assert len(got) == len(want) == (5 if kwargs.get("drop_last") else 6)
    for _ in range(3):
        wb, gb = list(want), list(got)
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert_items_equal(g, w)
            assert g.batch_size == w.batch_size
        assert got.epoch == want.epoch


def test_loader_max_regions_like_the_trainer(both):
    """The trainer's MAX_REGIONS padding over the tiny dataset's feature
    dataset, with the ragged last batch kept."""
    want_ds, got_ds = both["train"]
    pads = {"region_features": 16, "region_boxes": 16}
    want = jax_loader.DataLoader(want_ds, 3, shuffle=True, seed=13, pad_sizes=pads)
    got = loader.DataLoader(got_ds, 3, shuffle=True, seed=13, pad_sizes=pads)
    wb, gb = list(want), list(got)
    assert [b.batch_size for b in gb] == [3, 3, 2]
    for g, w in zip(gb, wb):
        assert_items_equal(g, w)
        assert g["region_features"].shape[1] == 16 and g["grid_features"].shape[1] == 16


def test_image_dataset_items_equal_jax(tiny_dataset_dir, tmp_path):
    """``ImageDataset`` over a corpus of PNGs of odd sizes (shrunk and
    grown to 512 x 512 by cv2's INTER_AREA): every item's image bit-equal
    to JAX's, its features and captions equal; a missing file is named."""
    import cv2

    rng = np.random.default_rng(3)
    with open(tiny_dataset_dir / "test.json") as f:
        data = json.load(f)
    for image, shape in zip(data["images"], [(700, 613, 3), (97, 130, 3)]):
        image["file_name"] = f"photo_{image['id']}.png"
        cv2.imwrite(str(tmp_path / image["file_name"]),
                    rng.integers(0, 256, size=shape, dtype=np.uint8))
    (tmp_path / "images.json").write_text(json.dumps(data))
    raw = make_dataset_config(tiny_dataset_dir).to_dict()
    raw["FEATURE_PATH"]["IMAGE"] = str(tmp_path)
    jax_cfg, cfg = JaxConfigNode(raw), ConfigNode(raw)
    path = str(tmp_path / "images.json")
    want = jax_datasets.ImageDataset(path, JaxVocab(jax_cfg), jax_cfg)
    got = datasets.ImageDataset(path, Vocab.from_config(cfg), cfg)
    assert len(got) == len(want) == 2
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])
        assert got[i]["image"].shape == (512, 512, 3) and got[i]["image"].dtype == np.uint8
    (tmp_path / "photo_7.png").unlink()
    with pytest.raises(FileNotFoundError, match="photo_7.png"):
        got[1]


@pytest.mark.parametrize("pad_sizes", [None, {"region_features": 8}])
def test_collate_fn_equals_instance_list_and_jax(pad_sizes):
    rng = np.random.default_rng(5)
    samples = [dict(region_features=rng.normal(size=(n, 4)).astype(np.float32),
                    caption_tokens=rng.integers(0, 9, size=6).astype(np.int32), image_id=i)
               for i, n in enumerate((3, 5, 2))]
    got = collate_fn([Instance(**x) for x in samples], pad_sizes=pad_sizes)
    direct = InstanceList([Instance(**x) for x in samples], pad_sizes=pad_sizes)
    want = jax_collate_fn([JaxInstance(**x) for x in samples], pad_sizes=pad_sizes)
    assert isinstance(got, InstanceList)
    for other in (direct, want):
        assert_items_equal(got.arrays(), other.arrays())
        assert list(got.image_id) == list(other.image_id)


def test_instance_list_access():
    items = InstanceList([Instance(a=np.zeros((2, 3), np.float32), name="x"),
                          Instance(a=np.ones((1, 3), np.float32), name="y")])
    assert items.batch_size == 2 and items.has("a") and not items.has("b")
    assert list(items.name) == ["x", "y"] and items.missing is None
    assert items.a.shape == (2, 2, 3)
    sample = Instance(a=1)
    sample.b = 2
    assert sample.b == 2 and sample["b"] == 2
    with pytest.raises(AttributeError):
        sample.c
    with pytest.raises(ValueError, match="fixed pad size"):
        InstanceList([Instance(a=np.zeros((9, 2)))], pad_sizes={"a": 4})


def test_prefetch_errors_arrive_in_order():
    """Batches before the failing one arrive, then its exception."""
    got = []
    with pytest.raises(RuntimeError, match="boom at 9"):
        for batch in loader.DataLoader(ToyDataset(Instance, fail_at=9), 4, prefetch=2):
            got.append(batch.batch_size)
    assert got == [4, 4]
    seen = []
    with pytest.raises(RuntimeError, match="boom at 9"):
        for items, batch in loader.device_prefetch(
                loader.DataLoader(ToyDataset(Instance, fail_at=9), 4), "cpu"):
            seen.append(int(batch["idx"][0]))
    assert seen == [0, 4]


def test_device_prefetch_order_and_tensors():
    data = loader.DataLoader(ToyDataset(Instance), 4)
    out = list(loader.device_prefetch(data, "cpu", depth=3))
    assert len(out) == 6
    for k, (items, batch) in enumerate(out):
        assert sorted(batch) == ["idx", "region_boxes", "region_features", "tokens"]
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in batch.values())
        np.testing.assert_array_equal(batch["region_features"].numpy(),
                                      items["region_features"])
        assert int(batch["idx"][0]) == 4 * k
    assert list(loader.device_prefetch([], "cpu")) == []


def test_abandoned_iterators_stop_their_producers():
    """Closing a loader's iterator or a device_prefetch stream mid-way stops
    the producer thread instead of leaving it blocked on a full queue."""
    made = []

    class Counting(ToyDataset):
        def __getitem__(self, i):
            made.append(i)
            return super().__getitem__(i)

    for stream in (lambda d: iter(loader.DataLoader(d, 1, prefetch=2)),
                   lambda d: loader.device_prefetch(loader.DataLoader(d, 1, prefetch=0),
                                                    "cpu", depth=2)):
        made.clear()
        it = stream(Counting(Instance, n=1000))
        next(it)
        it.close()
        time.sleep(0.4)
        n = len(made)
        time.sleep(0.3)
        assert len(made) == n and n < 10
