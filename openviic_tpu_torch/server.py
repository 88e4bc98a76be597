"""HTTP caption server with cross-request batching (the port's counterpart
of ``openviic_tpu/server.py``).  Standard library only.

 - ``POST /caption``          body: an image file's bytes, decoded with
                              Pillow (without Pillow: a 400 that says so)
                              -> ``{"caption": "..."}``
 - ``POST /caption_features`` body: an ``.npz`` archive of plain arrays
                              (``np.savez(buf, **feature_dict)``) -> caption.
                              Pickled or bare ``.npy`` bodies are refused:
                              the body comes from a network peer, and
                              unpickling it would run its code.
 - ``GET /healthz``           liveness, the model's name and the batcher's
                              ``batches``, ``items`` and ``mean_fill``

Requests go through a micro-batcher: it collects them for up to
``max_wait_ms`` (or until ``max_batch``) and decodes them as one batch in
its own thread, the only thread that decodes.  A request that fails fails
only its own reply."""

from __future__ import annotations

import io
import json
import queue
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from openviic_tpu_torch.data.extraction import extract_feature_dict, grid_boxes, open_image
from openviic_tpu_torch.utils import setup_logger

logger = setup_logger()


class _Batcher:
    """Collects (kind, payload) work items into pipeline-sized batches."""

    def __init__(self, pipeline, max_batch: int, max_wait_ms: float,
                 backbone: str = "patch", grid: int = 7):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.backbone = backbone
        self.grid = grid
        # batch-fill statistics for /healthz, updated and read under the
        # lock so that a batch is never seen without its items
        self.stats = {"batches": 0, "items": 0}
        self.stats_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, kind: str, payload) -> Future:
        fut: Future = Future()
        self._q.put((kind, payload, fut))
        return fut

    def close(self, timeout: float = 30.0) -> None:
        """Stop the batcher's thread after the items queued before."""
        self._q.put(None)
        self._thread.join(timeout)

    def snapshot(self) -> dict:
        with self.stats_lock:
            stats = dict(self.stats)
        stats["mean_fill"] = (round(stats["items"] / stats["batches"], 2)
                              if stats["batches"] else None)
        return stats

    def _drain(self):
        items = [self._q.get()]  # block for the first item
        timeout = self.max_wait
        while items[-1] is not None and len(items) < self.max_batch:
            try:
                items.append(self._q.get(timeout=timeout))
                timeout = 0.0  # after the second item: only take what is ready
            except queue.Empty:
                break
        return items

    def _feature_dict(self, kind: str, payload):
        if kind == "features":
            data = np.load(io.BytesIO(payload), allow_pickle=False)
            if not hasattr(data, "files"):
                raise ValueError("expected a .npz archive (np.savez of plain arrays); bare or "
                                 "pickled .npy payloads are not accepted")
            return {k: np.asarray(data[k], np.float32) for k in data.files}
        pixels = open_image(io.BytesIO(payload))  # kind == "image"
        gboxes = grid_boxes(self.grid)
        return extract_feature_dict(pixels, self.pipeline.backbone(self.backbone, self.grid),
                                    gboxes, gboxes if self.pipeline.needs_regions() else None)

    def _run(self):
        # grad mode is per thread: the extraction and the kernel wrappers
        # (which refuse inputs that need grad) run with it off
        with torch.no_grad():
            while True:
                items = self._drain()
                stop = items[-1] is None
                items = [item for item in items if item is not None]
                if items:
                    self._decode(items)
                if stop:
                    return

    def _decode(self, items) -> None:
        with self.stats_lock:
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
        feature_dicts, futures = [], []
        for kind, payload, fut in items:
            try:
                feature_dicts.append(self._feature_dict(kind, payload))
                futures.append(fut)
            except Exception as e:  # a bad payload fails its own request only
                fut.set_exception(e)
        if not futures:
            return
        try:
            captions = self.pipeline.caption_features(feature_dicts)
            for fut, cap in zip(futures, captions):
                fut.set_result(cap)
        except Exception as e:  # the batch's requests get the error; the thread goes on
            logger.exception("decoding a batch of %d failed", len(futures))
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)


class CaptionServer:
    """ThreadingHTTPServer around a ``CaptioningPipeline``;
    ``serve_forever``, or ``start`` and ``stop``."""

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: Optional[int] = None, max_wait_ms: float = 10.0,
                 backbone: str = "patch", grid: int = 7):
        self.pipeline = pipeline
        self.batcher = _Batcher(pipeline, max_batch or pipeline.batch_size, max_wait_ms,
                                backbone=backbone, grid=grid)
        batcher = self.batcher
        model_name = pipeline.config.MODEL.NAME

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj, ensure_ascii=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok", "model": model_name,
                                      "batcher": batcher.snapshot()})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(n)
                kind = {"/caption": "image", "/caption_features": "features"}.get(self.path)
                if kind is None:
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    caption = batcher.submit(kind, payload).result(timeout=120)
                    self._reply(200, {"caption": caption})
                except Exception as e:
                    self._reply(400, {"error": str(e)})

        class _Server(ThreadingHTTPServer):
            # a backlog above http.server's 5, so that a burst of clients
            # is not refused
            request_queue_size = 128

        self.httpd = _Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("caption server listening on :%d", self.port)

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.batcher.close()

    def serve_forever(self) -> None:
        logger.info("caption server listening on :%d", self.port)
        try:
            self.httpd.serve_forever()
        finally:
            self.httpd.server_close()
            self.batcher.close()
