"""The port's feature extraction (``openviic_tpu_torch/data/extraction.py``
and its CLI ``openviic_tpu_torch.extract_features``) against the JAX
package's ``data/extraction.py`` and ``scripts/extract_features.py`` on the
CPU.

Bit-equal: ``grid_boxes``, the patch projection, and the resized
thumbnails (the port computes PIL's fixed-point bilinear resample
exactly).  Within 1e-6: ``roi_pool`` (a matrix product where JAX sums cell
by cell).  Within 1e-5: the backbone's features, on images that need no
resize and on downsampled ones (the thumbnails being equal, only the f32
product's order of summation differs)."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from openviic_tpu.data import extraction as jax_extraction
from openviic_tpu_torch.data import extraction

ROOT = Path(__file__).resolve().parent.parent
ROI_ATOL = 1e-6
FEATURE_ATOL = 1e-5


@pytest.mark.parametrize("g", [1, 2, 3, 7])
def test_grid_boxes_are_bit_equal(g):
    got = extraction.grid_boxes(g)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_extraction.grid_boxes(g))


@pytest.mark.parametrize("grid, dim", [(3, 11), (7, 1024)])
def test_projection_is_bit_equal(grid, dim):
    got = extraction.PatchBackbone(grid, dim, device="cpu")
    np.testing.assert_array_equal(got.proj, jax_extraction.PatchBackbone(grid, dim).proj)
    assert got._proj.dtype == torch.float32 and got._proj.shape == (192, dim)


def test_roi_pool_matches_jax_with_degenerate_boxes_and_ties():
    rng = np.random.default_rng(0)
    g = 3
    gboxes = extraction.grid_boxes(g)
    fmap = rng.normal(size=(g * g, 32)).astype(np.float32)
    corners = np.sort(rng.uniform(0, 1, size=(12, 2, 2)), axis=1)  # (box, [lo, hi], [x, y])
    boxes = np.concatenate([
        corners.reshape(12, 4),
        np.asarray([[0.0, 0.0, 1.0, 1.0],  # every cell
                    [0.5, 0.5, 0.5, 0.5],  # zero area: the centre cell
                    [1.2, 1.2, 1.5, 1.5],  # outside: the nearest corner cell
                    [1 / 3, 0.1, 1 / 3, 0.2],  # on a cell edge: a tie, the first cell
                    [0.0, 0.0, 1 / 3, 1 / 3]], np.float32),  # exactly one cell
    ]).astype(np.float32)
    want = jax_extraction.roi_pool(fmap, gboxes, boxes)
    got = extraction.roi_pool(torch.from_numpy(fmap), gboxes, boxes)
    assert got.dtype == torch.float32 and got.shape == want.shape == (17, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ROI_ATOL, rtol=0)
    np.testing.assert_array_equal(got[13].numpy(), fmap[4])
    np.testing.assert_array_equal(got[14].numpy(), fmap[8])


def test_roi_pool_tie_takes_the_first_cell():
    """A zero-area box on the edge between cells 0 and 1 of a 2 x 2 grid
    lies as near to both centres: the first wins, as ``np.argmin``."""
    fmap = np.eye(4, dtype=np.float32)
    gboxes = extraction.grid_boxes(2)
    box = np.asarray([[0.5, 0.25, 0.5, 0.25]], np.float32)
    got = extraction.roi_pool(fmap, gboxes, box).numpy()
    np.testing.assert_array_equal(got, jax_extraction.roi_pool(fmap, gboxes, box))
    np.testing.assert_array_equal(got[0], [1, 0, 0, 0])
    pooled = extraction.roi_pool(fmap, gboxes, np.asarray([[0.0, 0.0, 1.0, 0.5]], np.float32))
    np.testing.assert_allclose(pooled[0].numpy(), [0.5, 0.5, 0.0, 0.0], atol=ROI_ATOL)


# (height, width, grid): no resize, downsampling both sides, one side kept,
# upsampling, odd sizes
RESIZE_CASES = [(24, 24, 3), (48, 64, 5), (480, 640, 7), (56, 300, 7), (20, 30, 4),
                (17, 100, 3), (5, 9, 2)]


@pytest.mark.parametrize("h, w, g", RESIZE_CASES)
def test_resize_is_pils_bit_for_bit(h, w, g):
    rng = np.random.default_rng(h * w + g)
    arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((8 * g, 8 * g), Image.BILINEAR))
    got = extraction.PatchBackbone(g, 8, device="cpu").resize(arr)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h, w, g", [(24, 24, 3), (48, 64, 5), (480, 640, 7)])
def test_backbone_matches_jax(h, w, g):
    arr = np.random.default_rng(g).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    image = Image.fromarray(arr)
    want = jax_extraction.PatchBackbone(g, 64)(image)
    backbone = extraction.PatchBackbone(g, 64, device="cpu")
    got = backbone(arr)
    assert got.dtype == torch.float32 and got.shape == want.shape == (g * g, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_array_equal(backbone(image).numpy(), got.numpy())  # a PIL image too


def test_pil_images_of_other_modes_are_converted():
    arr = np.random.default_rng(1).integers(0, 256, size=(40, 40), dtype=np.uint8)
    for image in (Image.fromarray(arr, "L"), Image.fromarray(arr, "L").convert("RGBA")):
        want = jax_extraction.PatchBackbone(3, 16)(image)
        got = extraction.PatchBackbone(3, 16, device="cpu")(image)
        np.testing.assert_allclose(got.numpy(), want, atol=FEATURE_ATOL, rtol=0)
    with pytest.raises(ValueError, match="uint8"):
        extraction.rgb_array(arr)


@pytest.mark.parametrize("with_boxes", [False, True])
def test_extract_feature_dict_matches_jax(with_boxes):
    arr = np.random.default_rng(2).integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    gboxes = extraction.grid_boxes(5)
    boxes = np.asarray([[0.0, 0.0, 0.5, 0.5], [0.2, 0.3, 0.9, 0.8]], np.float32) \
        if with_boxes else None
    want = jax_extraction.extract_feature_dict(
        Image.fromarray(arr), jax_extraction.PatchBackbone(5, 11), gboxes, boxes)
    got = extraction.extract_feature_dict(arr, extraction.PatchBackbone(5, 11, device="cpu"),
                                           gboxes, boxes)
    assert sorted(got) == sorted(want)
    for key in want:
        assert isinstance(got[key], np.ndarray) and got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=FEATURE_ATOL, rtol=0)


def test_backbone_specs(monkeypatch, tmp_path):
    """"patch" builds the patch backbone; "hf:" with a name that is neither a
    directory nor in the local hub cache raises the JAX package's
    RuntimeError (nothing is downloaded); any other spec is unknown."""
    assert isinstance(extraction.make_backbone("patch", 3, 11, device="cpu"),
                      extraction.PatchBackbone)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="is not in the local cache.*'patch' backbone"):
        extraction.make_backbone("hf:google/vit-base-patch16-224-in21k", 7)
    with pytest.raises(ValueError, match="unknown backbone"):
        extraction.make_backbone("resnet", 7)


def test_open_image_names_pillow_when_it_is_missing(monkeypatch, tmp_path):
    path = tmp_path / "x.png"
    arr = np.random.default_rng(0).integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(extraction.open_image(str(path)), arr)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(ImportError, match="Pillow"):
        extraction.open_image(str(path))


@pytest.fixture(scope="module")
def image_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    ids = [10, 11, 12]
    images = []
    for i in ids:
        arr = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.png")
        images.append({"id": i, "file_name": f"img_{i}.png"})
    ann = {"images": images, "annotations": [{"image_id": i, "caption": "một con mèo"}
                                             for i in ids]}
    (root / "ann.json").write_text(json.dumps(ann))
    boxes = {str(i): [[0.0, 0.0, 0.5, 0.5], [16, 8, 48, 40]] for i in ids}
    (root / "boxes.json").write_text(json.dumps(boxes))
    return root, ids


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_features_script", ROOT / "scripts" / "extract_features.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [
    ["--annotations", "{root}/ann.json", "--region-boxes", "{root}/boxes.json", "--pixel-boxes"],
    ["--grid-as-regions"],
])
def test_cli_writes_what_the_jax_script_writes(image_corpus, tmp_path, flags):
    from openviic_tpu_torch import extract_features

    root, ids = image_corpus
    common = ["--image-dir", str(root), "--backbone", "patch", "--grid", "3", "--dim", "11"]
    common += [f.format(root=root) for f in flags]
    _jax_script().main(common + ["--out", str(tmp_path / "jax")])
    extract_features.main(common + ["--out", str(tmp_path / "port"), "--cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == len(ids)
    for name in names:
        want = np.load(tmp_path / "jax" / name, allow_pickle=True)[()]
        got = np.load(tmp_path / "port" / name, allow_pickle=True)[()]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=FEATURE_ATOL, rtol=0)


def test_cli_output_feeds_the_ports_dataset(image_corpus, tmp_path):
    from openviic_tpu_torch import extract_features
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.data.datasets import FeatureDataset
    from openviic_tpu_torch.data.loader import DataLoader
    from openviic_tpu_torch.data.vocab import Vocab
    from tests.conftest import make_dataset_config

    root, _ = image_corpus
    out = tmp_path / "features"
    extract_features.main(["--image-dir", str(root), "--annotations", str(root / "ann.json"),
                           "--out", str(out), "--grid", "3", "--dim", "11", "--cpu"])
    cfg = make_dataset_config(root).to_dict()
    cfg["JSON_PATH"] = dict.fromkeys(("TRAIN", "DEV", "TEST"), str(root / "ann.json"))
    cfg["FEATURE_PATH"]["FEATURES"] = str(out)
    cfg = ConfigNode(cfg)
    dataset = FeatureDataset(str(root / "ann.json"), Vocab.from_config(cfg), cfg)
    arrays = next(iter(DataLoader(dataset, batch_size=3))).arrays()
    assert arrays["grid_features"].shape == (3, 16, 11)  # 9 cells bucket-padded to 16
    assert "region_features" not in arrays
