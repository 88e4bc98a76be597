"""Serve captions over HTTP from a trained checkpoint of the port (the
counterpart of the JAX package's ``serve.py``):

    python -m openviic_tpu_torch.serve --config-file <yaml>
        [--checkpoint-dir DIR] [--host 127.0.0.1] [--port 8080] [--beam N]
        [--batch 32] [--max-wait-ms 10] [--backbone patch|hf:<vit>] [--grid 7] [--cpu]
        [KEY VALUE ...]

Endpoints (``openviic_tpu_torch/server.py``): ``POST /caption`` (an image
file's bytes; needs Pillow), ``POST /caption_features`` (an ``np.savez``
archive of plain arrays), ``GET /healthz``.  The model runs on the card
(``--cpu``: on the CPU).  The server binds 127.0.0.1 by default: pass
``--host 0.0.0.0`` only behind an authenticating proxy, since it has no
authentication or rate limit of its own.  PyYAML is imported only to
parse the file."""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="OpenViIC-TPU caption server, PyTorch port")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: the config's "
                         "TRAINING.CHECKPOINT_PATH/MODEL.NAME)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; 0.0.0.0 only behind a trusted proxy")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--backbone", default="patch",
                    help="image feature backbone: 'patch' or 'hf:<ViT directory or hub name "
                         "in the local cache>'")
    ap.add_argument("--grid", type=int, default=7)
    ap.add_argument("--cpu", action="store_true", help="serve on the CPU, not the card")
    ap.add_argument("opts", nargs="*", help="dotted config overrides")
    args = ap.parse_args(argv)

    from openviic_tpu_torch.config import get_config
    from openviic_tpu_torch.server import CaptionServer
    from openviic_tpu_torch.serving import CaptioningPipeline

    config = get_config(args.config_file, args.opts)
    pipeline = CaptioningPipeline(config, checkpoint_dir=args.checkpoint_dir,
                                  beam_size=args.beam, batch_size=args.batch,
                                  device="cpu" if args.cpu else "cuda")
    server = CaptionServer(pipeline, host=args.host, port=args.port, max_batch=args.batch,
                           max_wait_ms=args.max_wait_ms, backbone=args.backbone,
                           grid=args.grid)
    server.serve_forever()


if __name__ == "__main__":
    main()
