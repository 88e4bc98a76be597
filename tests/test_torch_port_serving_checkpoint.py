"""Serving from a checkpoint: the port's ``CaptioningPipeline(config,
checkpoint_dir=...)`` against the JAX package's on the same weights at f32
on the CPU: ``caption_directory`` and ``caption_images`` give the same
strings, ``StandardTransformerUsingGrid`` the same forward and beam tokens;
a missing checkpoint, a JAX checkpoint and the unported options are
refused; the ``predict`` and ``serve`` CLIs run with ``--cpu``.

The weights are drawn over ``model.init``'s parameters and written, with
no training, by the JAX package's ``save_checkpoint`` and, carried through
``state_dict_from_jax``, by the port's (``write_checkpoints``)."""

import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.serving import CaptioningPipeline as JaxPipeline
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import model_config as tests_model_config
from tests.test_torch_port_support import make_captions, make_pair, make_vocab, write_checkpoints

ROOT = Path(__file__).resolve().parent.parent
GRID_DIM = 11  # the tiny dataset's grid features, and the patch backbone's width


@pytest.fixture(scope="module")
def region_ckpt(tmp_path_factory, tiny_vocab):
    return write_checkpoints(tmp_path_factory.mktemp("region_ckpt"), tiny_vocab)


@pytest.fixture(scope="module")
def grid_ckpt(tmp_path_factory, tiny_vocab):
    return write_checkpoints(tmp_path_factory.mktemp("grid_ckpt"), tiny_vocab,
                             architecture="StandardTransformerUsingGrid", d_feature=GRID_DIM,
                             eos_gain=1.0)


@pytest.fixture(scope="module")
def jax_directory_captions(region_ckpt, tiny_dataset_dir):
    jax_config, _ = region_ckpt
    pipe = JaxPipeline(jax_config, batch_size=3, use_bf16=False)
    return pipe.caption_directory(str(tiny_dataset_dir / "features"))


def test_caption_directory_matches_jax(region_ckpt, tiny_dataset_dir, jax_directory_captions):
    """8 images in chunks of 3 (the last one padded), the next chunk loaded
    in the background; the checkpoint found at CHECKPOINT_PATH/MODEL.NAME."""
    _, config = region_ckpt
    pipe = CaptioningPipeline(config, batch_size=3, use_bf16=False, device="cpu")
    got = pipe.caption_directory(str(tiny_dataset_dir / "features"))
    assert got == jax_directory_captions
    assert sorted(got) == [str(i) for i in range(8)]
    assert len(set(got.values())) > 1 and all(got.values())  # not a degenerate decode
    assert pipe.caption_directory(str(tiny_dataset_dir / "features"), image_ids=[]) == {}
    assert next(pipe.model.parameters()).dtype == torch.float32


def test_checkpoint_name_and_directory_are_honoured(region_ckpt, tmp_path):
    _, config = region_ckpt
    run_dir = Path(config.TRAINING.CHECKPOINT_PATH) / config.MODEL.NAME
    other = tmp_path / "elsewhere"
    other.mkdir()
    for name, target in (("vocab.bin", "vocab.bin"), ("best_model.ckpt", "epoch_3.ckpt")):
        (other / target).write_bytes((run_dir / name).read_bytes())
    feats = [{"region_features": np.random.default_rng(3).normal(size=(5, 13)).astype(np.float32)}]
    want = CaptioningPipeline(config, batch_size=1, use_bf16=False,
                              device="cpu").caption_features(feats)
    pipe = CaptioningPipeline(config, checkpoint_dir=str(other), checkpoint_name="epoch_3.ckpt",
                              batch_size=1, use_bf16=False, device="cpu")
    assert pipe.caption_features(feats) == want
    assert pipe.beam_size == 3  # the config's EVALUATING_BEAM_SIZE


def test_grid_model_forward_and_beam_match_jax():
    vocab = make_vocab()
    jax_model, jax_params, port_model = make_pair(
        vocab, seed=2, eos_gain=3.0, architecture="StandardTransformerUsingGrid", d_feature=GRID_DIM)
    assert type(port_model).__name__ == "StandardTransformerUsingGrid"
    rng = np.random.default_rng(7)
    grid = rng.normal(size=(3, 9, GRID_DIM)).astype(np.float32)
    grid[0, -2:] = 0.0  # padded cells
    tokens = make_captions(vocab, 3, seed=1)
    want = np.asarray(jax_model.apply(
        jax_params, {"grid_features": jnp.asarray(grid), "caption_tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = port_model({"grid_features": torch.from_numpy(grid),
                          "caption_tokens": torch.from_numpy(tokens).long()}).numpy()
    keep = tokens != vocab.padding_idx
    np.testing.assert_allclose(got[keep], want[keep], atol=2e-4, rtol=0)
    want_ids, _ = jax_beam_search(jax_model, jax_params, {"grid_features": jnp.asarray(grid)},
                                  beam_size=3, beam_resident=True)
    got_ids, _ = beam_search(port_model, {"grid_features": torch.from_numpy(grid)}, beam_size=3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def _png(path, seed, size=24):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def test_caption_images_matches_jax(grid_ckpt, region_ckpt, tmp_path):
    """24 x 24 images at grid 3 need no resize in either package; the grid
    model reads the patch features, the region model the grid cells (or,
    for one image, boxes given by its stem) pooled as regions."""
    paths, arrays = [], []
    for i in range(4):
        paths.append(str(tmp_path / f"photo_{i}.png"))
        arrays.append(_png(paths[-1], seed=i))
    for (jax_config, config), boxes in ((grid_ckpt, None),
                                        (region_ckpt, {"photo_1": np.asarray(
                                            [[0.0, 0.0, 0.5, 0.5], [0.2, 0.1, 0.9, 0.6]],
                                            np.float32)})):
        want = JaxPipeline(jax_config, batch_size=3, use_bf16=False).caption_images(
            paths, backbone="patch", grid=3, region_boxes=boxes)
        pipe = CaptioningPipeline(config, batch_size=3, use_bf16=False, device="cpu")
        got = pipe.caption_images(paths, backbone="patch", grid=3, region_boxes=boxes)
        assert got == want and list(got) == paths
        # the same images as arrays, keyed by position (boxes by position too)
        by_position = None if boxes is None else {1: boxes["photo_1"]}
        from_arrays = pipe.caption_images(arrays, grid=3, region_boxes=by_position)
        assert from_arrays == {i: want[p] for i, p in enumerate(paths)}
    assert len(pipe._backbones) == 1  # one backbone for (spec, grid, dim)


def test_raw_images_take_the_feature_width_from_the_config():
    """A dual-stream vision embedding (``D_REGION_FEATURE`` and
    ``D_GRID_FEATURE``) can caption raw images only where both widths
    agree, as in the JAX pipeline: both streams come from one grid map."""
    config = ConfigNode({"MODEL": tests_model_config(d_feature=13).to_dict(),
                         "TRAINING": {"EVALUATING_BEAM_SIZE": 3}})
    pipe = CaptioningPipeline.from_state_dict(config, make_vocab(), batch_size=1, device="cpu")
    vision = {"ARCHITECTURE": "FeatureEmbedding", "D_MODEL": 16, "DROPOUT": 0.1}
    image = np.zeros((24, 24, 3), np.uint8)
    for region, grid in ((13, 13), (13, 11)):
        dual = config.to_dict()
        dual["MODEL"]["VISION_EMBEDDING"] = dict(vision, D_REGION_FEATURE=region,
                                                 D_GRID_FEATURE=grid)
        pipe.config = ConfigNode(dual)
        if region == grid:
            assert pipe.backbone("patch", 3).dim == 13
        else:
            with pytest.raises(ValueError, match="D_REGION_FEATURE=13"):
                pipe.caption_images([image], grid=3)


def test_missing_and_jax_checkpoints_are_refused(region_ckpt, tmp_path):
    jax_config, config = region_ckpt
    run_dir = Path(config.TRAINING.CHECKPOINT_PATH) / config.MODEL.NAME
    empty = tmp_path / "no_checkpoint"
    empty.mkdir()
    (empty / "vocab.bin").write_bytes((run_dir / "vocab.bin").read_bytes())
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        CaptioningPipeline(config, checkpoint_dir=str(empty), device="cpu")
    jax_dir = Path(jax_config.TRAINING.CHECKPOINT_PATH) / jax_config.MODEL.NAME
    with pytest.raises(ValueError, match="not a checkpoint of openviic_tpu_torch"):
        CaptioningPipeline(config, checkpoint_dir=str(jax_dir), device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        CaptioningPipeline(config, mesh="auto", device="cpu")
    # the adaptive decoder, refused until RSTNet was ported: without a
    # checkpoint it is refused as the others are, and from weights in memory
    # it serves with its language-signal table
    from tests.torch_port_rstnet import rstnet_model

    adaptive = config.to_dict()
    adaptive["MODEL"] = rstnet_model()
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        CaptioningPipeline(ConfigNode(adaptive), checkpoint_dir=str(empty), device="cpu")
    pipe = CaptioningPipeline.from_state_dict(ConfigNode(adaptive), make_vocab(), device="cpu")
    assert pipe.language_table.shape == (len(make_vocab()), 16)


def _yaml_config(config, path, features_dir):
    data = config.to_dict()
    data["DATASET"] = {"FEATURE_PATH": {"FEATURES": str(features_dir)}}
    path.write_text(yaml.safe_dump(data))
    return str(path)


def test_predict_cli(region_ckpt, tiny_dataset_dir, jax_directory_captions, tmp_path):
    from openviic_tpu_torch import predict

    _, config = region_ckpt
    cfg = _yaml_config(config, tmp_path / "serve.yaml", tiny_dataset_dir / "features")
    out = tmp_path / "captions.json"
    predict.main(["--config-file", cfg, "--output", str(out), "--batch", "3", "--f32", "--cpu"])
    assert json.loads(out.read_text()) == jax_directory_captions


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli(region_ckpt, tiny_dataset_dir, tmp_path):
    """``python -m openviic_tpu_torch.serve --cpu`` answers /healthz and a
    features request with the caption of the same pipeline (bf16, as the
    CLI serves)."""
    _, config = region_ckpt
    cfg = _yaml_config(config, tmp_path / "serve.yaml", tiny_dataset_dir / "features")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "openviic_tpu_torch.serve", "--config-file", cfg, "--port",
         str(port), "--batch", "4", "--max-wait-ms", "5", "--cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline, health = time.monotonic() + 90, None
        while health is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
                assert time.monotonic() < deadline, "the server did not start in 90 s"
                time.sleep(0.2)
        assert health["status"] == "ok" and health["model"] == config.MODEL.NAME
        payload = np.load(tiny_dataset_dir / "features" / "2.npy", allow_pickle=True)[()]
        buf = io.BytesIO()
        np.savez(buf, **payload)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/caption_features",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            caption = json.loads(r.read())["caption"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    want = CaptioningPipeline(config, batch_size=4, device="cpu").caption_features(
        [{k: np.asarray(v, np.float32) for k, v in payload.items()}])
    assert caption == want[0]
