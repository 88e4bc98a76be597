"""The ``hf:`` ViT feature backbone of the PyTorch port
(``openviic_tpu_torch/data/vit.py``, ``data/extraction.py``'s
``HFViTBackbone``) against the JAX package's ``HFViTBackbone``
(transformers' ``AutoImageProcessor`` and ``FlaxViTModel``) on the CPU, f32.

One tiny ViT directory serves the module: hidden 32, 2 layers of 4 heads,
MLP 64, 32 x 32 images of 8 x 8 patches (a 4 x 4 patch map), its weights
drawn with numpy and written by transformers' ``ViTModel.save_pretrained``
(``model.safetensors``, ``format`` pt) beside a 32 x 32
``ViTImageProcessor``; the other layouts are made from it by transformers
(``FlaxViTModel``'s safetensors and msgpack, ``pytorch_model.bin``).  No
file is downloaded.  Bars: pixel values 1e-6 (they are equal), features
1e-5, the pipeline's captions equal."""

import json
import os
import shutil

os.environ.setdefault("USE_TF", "0")  # transformers leaves TensorFlow unimported

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from openviic_tpu.data import extraction as jax_extraction  # noqa: E402
from openviic_tpu.serving import CaptioningPipeline as JaxPipeline  # noqa: E402
from openviic_tpu_torch.data import extraction, vit  # noqa: E402
from openviic_tpu_torch.serving import CaptioningPipeline  # noqa: E402
from tests.test_torch_port_support import write_checkpoints  # noqa: E402

PIXEL_ATOL = 1e-6
FEATURE_ATOL = 1e-5
HIDDEN, PATCH_MAP = 32, 4
IMAGE_SHAPES = [(37, 53, 3), (480, 640, 3), (32, 32, 3)]


def _vit_config(**overrides):
    from transformers import ViTConfig

    return ViTConfig(**dict(dict(hidden_size=HIDDEN, num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=64, image_size=32, patch_size=8),
                            **overrides))


def _drawn_state(model, seed: int) -> dict:
    """``model``'s state_dict drawn with numpy: weights N(0, 0.1), the
    LayerNorms' gains 1 + N(0, 0.1), the CLS token and position table
    N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in model.state_dict().items():
        scale = 0.5 if key.startswith("embeddings.") and value.ndim == 3 else 0.1
        draw = scale * rng.standard_normal(value.shape)
        if "layernorm" in key and key.endswith("weight"):
            draw += 1.0
        out[key] = torch.from_numpy(draw.astype(np.float32))
    return out


def _write_vit(directory, seed: int = 0, **overrides):
    from transformers import ViTImageProcessor, ViTModel

    model = ViTModel(_vit_config(**overrides))
    model.load_state_dict(_drawn_state(model, seed))
    model.save_pretrained(directory)
    ViTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(directory)
    return model.eval()


@pytest.fixture(scope="module")
def vit_dirs(tmp_path_factory):
    """{"pt": transformers' safetensors, "flax": FlaxViTModel's safetensors,
    "bin": pytorch_model.bin, "msgpack": FlaxViTModel's msgpack alone},
    each with the same weights and the processor."""
    from transformers import FlaxViTModel, ViTModel

    root = tmp_path_factory.mktemp("vit")
    dirs = {name: root / name for name in ("pt", "flax", "bin", "msgpack")}
    _write_vit(dirs["pt"])
    ViTModel.from_pretrained(dirs["pt"]).save_pretrained(dirs["bin"], safe_serialization=False)
    flax = FlaxViTModel.from_pretrained(dirs["pt"], local_files_only=True)
    flax.save_pretrained(dirs["flax"], safe_serialization=True)
    flax.save_pretrained(dirs["msgpack"])
    for name in ("flax", "bin", "msgpack"):
        shutil.copy(dirs["pt"] / vit.PROCESSOR_NAME, dirs[name])
    return {k: str(v) for k, v in dirs.items()}


@pytest.fixture(scope="module")
def jax_backbone(vit_dirs):
    """The JAX package's backbone on the pt directory (its grid is set per
    test: it is read only when an image is pooled)."""
    return jax_extraction.HFViTBackbone(vit_dirs["pt"], 2)


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_pixel_values_match_jax_processor(vit_dirs, jax_backbone, shape):
    """The port's processor against ``AutoImageProcessor`` as the JAX
    backbone loads it: PIL's bilinear resize, rescale, normalise."""
    arr = _image(shape, seed=shape[0])
    want = jax_backbone.processor(Image.fromarray(arr).convert("RGB"),
                                  return_tensors="np")["pixel_values"]
    backbone = extraction.make_backbone(f"hf:{vit_dirs['pt']}", 2, HIDDEN, device="cpu")
    got = backbone.processor(arr)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)
    # a PIL image in another mode is converted to RGB, as the JAX backbone converts it
    grey = Image.fromarray(arr).convert("L")
    np.testing.assert_allclose(backbone.processor(grey).numpy(), jax_backbone.processor(
        grey.convert("RGB"), return_tensors="np")["pixel_values"], atol=PIXEL_ATOL, rtol=0)


def test_older_feature_extractor_config_gives_the_same_pixels(vit_dirs, tmp_path):
    """An older hub repository's preprocessor config (``feature_extractor_type``
    ViTFeatureExtractor, ``size`` an int, no ``rescale_factor``), which
    ``AutoImageProcessor`` loads as ``ViTImageProcessor``."""
    from transformers import AutoImageProcessor

    old = tmp_path / "old"
    shutil.copytree(vit_dirs["pt"], old)
    (old / vit.PROCESSOR_NAME).write_text(json.dumps({
        "do_normalize": True, "do_resize": True, "feature_extractor_type": "ViTFeatureExtractor",
        "image_mean": [0.5] * 3, "image_std": [0.5] * 3, "resample": 2, "size": 32}))
    arr = _image((41, 29, 3), seed=8)
    want = AutoImageProcessor.from_pretrained(str(old), local_files_only=True)(
        Image.fromarray(arr), return_tensors="np")["pixel_values"]
    got = extraction.make_backbone(f"hf:{old}", 2, device="cpu").processor(arr)
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("g", [2, 3, 4])
def test_features_match_jax_backbone(vit_dirs, jax_backbone, g):
    """g = 2 and 3 pool the 4 x 4 patch map (3: uneven edges, a cell of one
    patch), g = 4 is the map itself; JAX takes a PIL image, the port the
    array."""
    backbone = extraction.make_backbone(f"hf:{vit_dirs['pt']}", g, HIDDEN, device="cpu")
    assert isinstance(backbone, extraction.HFViTBackbone) and backbone.dim == HIDDEN
    jax_backbone.grid = g
    for shape in IMAGE_SHAPES[:2]:
        arr = _image(shape, seed=g)
        want = jax_backbone(Image.fromarray(arr))
        got = backbone(arr)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (g * g, HIDDEN)
        np.testing.assert_allclose(got.numpy(), want, atol=FEATURE_ATOL, rtol=0)
        assert np.abs(want).max() > 0.1  # not a vanishing output


def test_pool_matrix_is_the_jax_cell_mean():
    rng = np.random.default_rng(1)
    for p, g in ((4, 2), (4, 3), (14, 7), (14, 5), (3, 5)):
        fmap = rng.standard_normal((p, p, 6)).astype(np.float32)
        edges = np.linspace(0, p, g + 1).round().astype(int)
        want = np.stack([fmap[edges[r]:max(edges[r + 1], edges[r] + 1),
                              edges[c]:max(edges[c + 1], edges[c] + 1)].mean(axis=(0, 1))
                         for r in range(g) for c in range(g)])
        got = extraction.pool_matrix(p, g) @ fmap.reshape(p * p, 6)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["flax", "bin"])
def test_other_weight_files_give_the_same_features(vit_dirs, jax_backbone, layout):
    """FlaxViTModel's safetensors (``format`` flax: kernels (in, out), the
    patch kernel HWIO, LayerNorm ``scale``) and ``pytorch_model.bin`` give
    the pt directory's features, and JAX's."""
    weights, source = vit.read_weights(vit_dirs[layout])
    assert source.endswith("model.safetensors" if layout == "flax" else "pytorch_model.bin")
    want_weights, _ = vit.read_weights(vit_dirs["pt"])
    assert sorted(weights) == sorted(want_weights)
    for key, value in want_weights.items():
        torch.testing.assert_close(weights[key], value, rtol=0, atol=0)
    arr = _image((48, 40, 3), seed=7)
    got = extraction.make_backbone(f"hf:{vit_dirs[layout]}", 3, HIDDEN, device="cpu")(arr)
    jax_backbone.grid = 3
    np.testing.assert_allclose(got.numpy(), jax_backbone(Image.fromarray(arr)),
                               atol=FEATURE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_precision_safetensors_are_read_exactly(vit_dirs, tmp_path, dtype):
    """F16 and BF16 tensors written by the safetensors package are read as
    those values (then held at f32 by the model)."""
    from safetensors.torch import save_file

    weights, _ = vit.read_weights(vit_dirs["pt"])
    half = {k: v.to(dtype) for k, v in weights.items()}
    save_file(half, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    got, meta = vit.read_safetensors(str(tmp_path / "model.safetensors"))
    assert meta == {"format": "pt"}
    for key, value in half.items():
        assert got[key].dtype == dtype
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    for name in (vit.CONFIG_NAME, vit.PROCESSOR_NAME):
        shutil.copy(os.path.join(vit_dirs["pt"], name), tmp_path)
    model = extraction.make_backbone(f"hf:{tmp_path}", 4, device="cpu").model
    assert next(model.parameters()).dtype == torch.float32


def test_head_model_prefix_is_stripped_and_its_head_ignored(vit_dirs, tmp_path):
    """A ``ViTFor*`` file: the base under ``vit.``, the head beside it."""
    from safetensors.torch import save_file

    weights, _ = vit.read_weights(vit_dirs["pt"])
    headed = {f"vit.{k}": v for k, v in weights.items()}
    headed.update({"classifier.weight": torch.zeros(5, HIDDEN), "classifier.bias": torch.zeros(5),
                   "vit.pooler.dense.weight": torch.zeros(HIDDEN, HIDDEN)})
    save_file(headed, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    for name in (vit.CONFIG_NAME, vit.PROCESSOR_NAME):
        shutil.copy(os.path.join(vit_dirs["pt"], name), tmp_path)
    arr = _image((32, 32, 3), seed=3)
    got = extraction.make_backbone(f"hf:{tmp_path}", 2, device="cpu")(arr)
    want = extraction.make_backbone(f"hf:{vit_dirs['pt']}", 2, device="cpu")(arr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_weight_faults_are_refused_naming_the_key(vit_dirs, tmp_path, fault):
    from safetensors.torch import save_file

    weights, _ = vit.read_weights(vit_dirs["pt"])
    if fault == "missing":
        del weights["layernorm.weight"]
    elif fault == "unused":
        weights["encoder.layer.0.attention.attention.extra"] = torch.zeros(3)
    else:
        weights["layernorm.bias"] = torch.zeros(HIDDEN + 1)
    save_file(weights, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    for name in (vit.CONFIG_NAME, vit.PROCESSOR_NAME):
        shutil.copy(os.path.join(vit_dirs["pt"], name), tmp_path)
    error, word = {"missing": (KeyError, "layernorm.weight"),
                   "unused": (ValueError, "attention.extra"),
                   "shape": (ValueError, "layernorm.bias")}[fault]
    with pytest.raises(error, match=word):
        extraction.make_backbone(f"hf:{tmp_path}", 2, device="cpu")


@pytest.mark.parametrize("act", ["gelu_new", "gelu_pytorch_tanh", "gelu_fast"])
def test_tanh_gelu_forms_match_transformers(tmp_path, act):
    """The tanh forms transformers names, against its PyTorch ViTModel."""
    model = _write_vit(tmp_path, seed=2, hidden_act=act)
    processor, port = vit.load_vit(str(tmp_path), device="cpu")
    pixels = processor(_image((40, 36, 3), seed=4))
    with torch.no_grad():
        want = model(pixels).last_hidden_state
        got = port(pixels)
    torch.testing.assert_close(got, want, rtol=0, atol=FEATURE_ATOL)


def test_other_activations_and_processors_are_refused(vit_dirs, tmp_path):
    for name in (vit.CONFIG_NAME, vit.PROCESSOR_NAME, vit.SAFETENSORS_NAME):
        shutil.copy(os.path.join(vit_dirs["pt"], name), tmp_path)
    config = json.loads((tmp_path / vit.CONFIG_NAME).read_text())
    (tmp_path / vit.CONFIG_NAME).write_text(json.dumps(dict(config, hidden_act="relu")))
    with pytest.raises(ValueError, match="'relu'"):
        extraction.make_backbone(f"hf:{tmp_path}", 2, device="cpu")
    (tmp_path / vit.CONFIG_NAME).write_text(json.dumps(config))
    processor = json.loads((tmp_path / vit.PROCESSOR_NAME).read_text())
    (tmp_path / vit.PROCESSOR_NAME).write_text(
        json.dumps(dict(processor, image_processor_type="ViTImageProcessorFast")))
    with pytest.raises(ValueError, match="ViTImageProcessorFast"):
        extraction.make_backbone(f"hf:{tmp_path}", 2, device="cpu")


def test_refusals_on_both_sides(vit_dirs, tmp_path, monkeypatch):
    """A msgpack-only directory is refused (JAX reads it; resave it as
    safetensors); an absent name raises JAX's RuntimeError on both sides;
    a width other than the ViT's is refused by name (the JAX package fails
    later, in the model, tested with the pipelines below)."""
    with pytest.raises(ValueError, match=r"flax_model\.msgpack.*safe_serialization=True"):
        extraction.make_backbone(f"hf:{vit_dirs['msgpack']}", 2, device="cpu")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_cache"))
    for make in (lambda: extraction.make_backbone("hf:nobody/no-such-vit", 2, device="cpu"),
                 lambda: jax_extraction.make_backbone("hf:nobody/no-such-vit", 2)):
        with pytest.raises(RuntimeError, match="is not in the local cache.*'patch' backbone"):
            make()
    with pytest.raises(ValueError, match="32-wide.*48-wide"):
        extraction.make_backbone(f"hf:{vit_dirs['pt']}", 2, 48, device="cpu")


@pytest.mark.parametrize("variable", ["HF_HUB_CACHE", "HF_HOME"])
def test_hub_name_resolves_to_its_cached_snapshot(vit_dirs, tmp_path, monkeypatch, variable):
    """A hub cache tree: ``models--<org>--<name>/refs/main`` names the
    revision, ``snapshots/<rev>/`` holds the files."""
    hub = tmp_path / "hub"
    snapshot = hub / "models--some-org--tiny-vit" / "snapshots" / "0123abcd"
    shutil.copytree(vit_dirs["pt"], snapshot)
    (hub / "models--some-org--tiny-vit" / "refs").mkdir()
    (hub / "models--some-org--tiny-vit" / "refs" / "main").write_text("0123abcd")
    for name in ("HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(variable, str(hub if variable == "HF_HUB_CACHE" else tmp_path))
    assert vit.resolve("some-org/tiny-vit") == str(snapshot)
    arr = _image((32, 32, 3), seed=5)
    got = extraction.make_backbone("hf:some-org/tiny-vit", 2, device="cpu")(arr)
    want = extraction.make_backbone(f"hf:{vit_dirs['pt']}", 2, device="cpu")(arr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (hub / "models--some-org--tiny-vit" / "refs" / "main").write_text("feedbeef")
    with pytest.raises(RuntimeError, match="missing snapshot"):
        vit.resolve("some-org/tiny-vit")


def test_caption_images_through_the_vit_matches_jax(vit_dirs, tiny_vocab, tmp_path):
    """The flagship at D_FEATURE 32 from the same weights (a JAX checkpoint
    and the port's, carried through ``compat.from_jax``), f32: PNG paths
    through JAX's pipeline, the same paths through the port's, at grid 2
    (the grid cells as regions): the captions equal.  At D_FEATURE 13 both
    refuse the ViT's 32-wide features: the port when it makes the backbone,
    the JAX package in the model's first Dense."""
    paths = []
    for i, shape in enumerate([(40, 48, 3), (32, 32, 3), (64, 50, 3), (33, 31, 3)]):
        paths.append(str(tmp_path / f"photo_{i}.png"))
        Image.fromarray(_image(shape, seed=10 + i)).save(paths[-1])
    spec = f"hf:{vit_dirs['pt']}"
    # seed 2: weights whose decodes of these images differ from each other
    jax_config, config = write_checkpoints(tmp_path / "wide", tiny_vocab, d_feature=HIDDEN,
                                           seed=2)
    want = JaxPipeline(jax_config, batch_size=3, use_bf16=False).caption_images(
        paths, backbone=spec, grid=2)
    pipe = CaptioningPipeline(config, batch_size=3, use_bf16=False, device="cpu")
    got = pipe.caption_images(paths, backbone=spec, grid=2)
    assert got == want and list(got) == paths
    assert len(set(got.values())) > 1 and all(got.values())  # not a degenerate decode
    assert pipe.backbone(spec, 2) is pipe.backbone(spec, 2)  # made once

    jax_config, config = write_checkpoints(tmp_path / "narrow", tiny_vocab)
    from flax.errors import ScopeParamShapeError

    with pytest.raises(ScopeParamShapeError, match="vision_embedding/proj"):
        JaxPipeline(jax_config, batch_size=3, use_bf16=False).caption_images(
            paths[:1], backbone=spec, grid=2)
    with pytest.raises(ValueError, match="32-wide.*13-wide"):
        CaptioningPipeline(config, batch_size=3, use_bf16=False,
                           device="cpu").caption_images(paths[:1], backbone=spec, grid=2)


def test_extract_features_cli_with_the_vit_writes_what_the_jax_script_writes(vit_dirs,
                                                                               tmp_path):
    """``--backbone hf:<dir>`` through both packages' CLIs (the JAX script's
    backbone ignores ``--dim``; the port's takes the ViT's own width when
    it is not given): the same files, within 1e-5."""
    from openviic_tpu_torch import extract_features
    from tests.test_torch_port_extraction import _jax_script

    images = tmp_path / "images"
    images.mkdir()
    for i, shape in enumerate([(45, 38, 3), (32, 32, 3)]):
        Image.fromarray(_image(shape, seed=20 + i)).save(images / f"{i}.png")
    common = ["--image-dir", str(images), "--backbone", f"hf:{vit_dirs['pt']}", "--grid", "3",
              "--grid-as-regions"]
    _jax_script().main(common + ["--out", str(tmp_path / "jax")])
    extract_features.main(common + ["--out", str(tmp_path / "port"), "--cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == ["0.npy", "1.npy"]
    for name in names:
        want = np.load(tmp_path / "jax" / name, allow_pickle=True)[()]
        got = np.load(tmp_path / "port" / name, allow_pickle=True)[()]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=FEATURE_ATOL, rtol=0)
    with pytest.raises(SystemExit):  # a width other than the ViT's is refused by name
        extract_features.main(common + ["--out", str(tmp_path / "bad"), "--dim", "48", "--cpu"])
