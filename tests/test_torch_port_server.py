"""The port's HTTP caption server (``openviic_tpu_torch/server.py``) on the
CPU, as ``tests/test_server.py`` holds the JAX package's: ``/healthz``,
images, features, a pickled body refused, concurrent requests batched, bad
payloads and paths.  Every caption it sends equals the port pipeline's
``caption_features`` of the same image, and an image's equals the JAX
package's ``caption_images`` on the same weights (f32, grid 3)."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from openviic_tpu.serving import CaptioningPipeline as JaxPipeline
from openviic_tpu_torch.data.extraction import PatchBackbone, extract_feature_dict, grid_boxes
from openviic_tpu_torch.server import CaptionServer
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.test_torch_port_support import write_checkpoints

GRID_DIM = 11


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, tiny_vocab):
    return write_checkpoints(tmp_path_factory.mktemp("server_ckpt"), tiny_vocab,
                             architecture="StandardTransformerUsingGrid", d_feature=GRID_DIM,
                             eos_gain=1.0)


@pytest.fixture(scope="module")
def server(checkpoints):
    _, config = checkpoints
    pipeline = CaptioningPipeline(config, batch_size=4, use_bf16=False, device="cpu")
    srv = CaptionServer(pipeline, port=0, max_batch=4, max_wait_ms=30.0, backbone="patch",
                        grid=3)
    srv.start()
    yield srv
    srv.stop()
    assert not srv.batcher._thread.is_alive()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 255, size=(24, 24, 3), dtype=np.uint8)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _direct(server, arr):
    """The pipeline's own caption of an image's patch features."""
    fd = extract_feature_dict(arr, PatchBackbone(3, GRID_DIM, device="cpu"), grid_boxes(3))
    return server.pipeline.caption_features([fd])[0]


def _health(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def test_healthz(server, checkpoints):
    data = _health(server)
    assert data["status"] == "ok" and data["model"] == checkpoints[1].MODEL.NAME
    assert set(data["batcher"]) == {"batches", "items", "mean_fill"}


def test_caption_image_matches_the_pipeline_and_jax(server, checkpoints, tmp_path):
    arr = _image()
    data = _post(server.port, "/caption", _png(arr))
    assert data["caption"] == _direct(server, arr)
    assert _post(server.port, "/caption", _png(arr))["caption"] == data["caption"]
    path = tmp_path / "photo.png"
    Image.fromarray(arr).save(path)
    jax_config, _ = checkpoints
    want = JaxPipeline(jax_config, batch_size=4, use_bf16=False).caption_images(
        [str(path)], backbone="patch", grid=3)
    assert data["caption"] == want[str(path)]


def test_caption_features(server):
    rng = np.random.default_rng(1)
    payload = {"grid_features": rng.normal(size=(9, GRID_DIM)).astype(np.float32),
               "grid_boxes": np.tile(np.asarray([[0.1, 0.1, 0.4, 0.4]], np.float32), (9, 1))}
    buf = io.BytesIO()
    np.savez(buf, **payload)
    data = _post(server.port, "/caption_features", buf.getvalue())
    assert data["caption"] == server.pipeline.caption_features([payload])[0]


def test_pickled_payload_rejected(server):
    payload = {"grid_features": np.zeros((4, GRID_DIM), np.float32)}
    buf = io.BytesIO()
    np.save(buf, payload, allow_pickle=True)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/caption_features", buf.getvalue())
    assert e.value.code == 400
    # a bare array is no archive either
    buf = io.BytesIO()
    np.save(buf, np.zeros((4, GRID_DIM), np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/caption_features", buf.getvalue())
    assert e.value.code == 400 and ".npz" in json.loads(e.value.read())["error"]


def test_concurrent_requests_batched(server):
    before = _health(server)["batcher"]
    results = {}

    def worker(i):
        results[i] = _post(server.port, "/caption", _png(_image(seed=i)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 6
    for i, r in results.items():
        assert r["caption"] == _direct(server, _image(seed=i))
    after = _health(server)["batcher"]
    items, batches = after["items"] - before["items"], after["batches"] - before["batches"]
    assert items == 6 and items / batches > 1  # requests shared batches
    assert after["mean_fill"] == round(after["items"] / after["batches"], 2)
    solo = _post(server.port, "/caption", _png(_image(seed=3)))
    assert solo["caption"] == results[3]["caption"]


def test_bad_payload_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/caption_features", b"not-an-npy")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/caption", b"not-an-image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/nope", b"")
    assert e.value.code == 404


def test_a_failed_item_fails_only_its_own_request(server):
    """A bad body and good ones in one batch: the good ones are answered."""
    batcher = server.batcher
    good = io.BytesIO()
    np.savez(good, grid_features=np.ones((9, GRID_DIM), np.float32))
    futures = [batcher.submit("features", good.getvalue()),
               batcher.submit("features", b"garbage"),
               batcher.submit("features", good.getvalue())]
    assert isinstance(futures[1].exception(timeout=60), Exception)
    assert futures[0].result(timeout=60) == futures[2].result(timeout=60)


def test_image_without_pillow_is_a_400_that_names_it(server, monkeypatch):
    body = _png(_image())
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/caption", body)
    assert e.value.code == 400 and "Pillow" in json.loads(e.value.read())["error"]


def test_batcher_stats_under_thread_stress(server):
    """More submitting threads than cores, switching threads every
    microsecond: every request is answered with its own caption and the
    batcher counts each once (a lost update of the shared stats would
    miss some)."""
    batcher = server.batcher
    rng = np.random.default_rng(5)
    grids = [rng.normal(size=(9, GRID_DIM)).astype(np.float32) for _ in range(4)]
    bodies = []
    for grid in grids:
        buf = io.BytesIO()
        np.savez(buf, grid_features=grid)
        bodies.append(buf.getvalue())
    want = server.pipeline.caption_features([{"grid_features": g} for g in grids])
    before = batcher.snapshot()
    got, threads = {}, []

    def worker(w):
        futures = [batcher.submit("features", bodies[(w + i) % 4]) for i in range(4)]
        got[w] = [f.result(timeout=120) for f in futures]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == {w: [want[(w + i) % 4] for i in range(4)] for w in range(16)}
    after = batcher.snapshot()
    assert after["items"] - before["items"] == 64
    assert 64 / batcher.max_batch <= after["batches"] - before["batches"] <= 64
