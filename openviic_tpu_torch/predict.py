"""Caption a directory of feature files with a trained checkpoint of the
port (the counterpart of the JAX package's ``predict.py``):

    python -m openviic_tpu_torch.predict --config-file <yaml>
        [--checkpoint-dir DIR] [--features-dir DIR] [--output captions.json]
        [--beam N] [--batch 32] [--f32] [--cpu]

It captions every ``<image_id>.npy`` of the features directory (default:
the config's ``DATASET.FEATURE_PATH.FEATURES``) on the card (``--cpu``: on
the CPU), in bf16 unless ``--f32``, and writes ``{id: caption}`` as JSON.
PyYAML is imported only to parse the file."""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="OpenViIC-TPU batch captioning, PyTorch port")
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="checkpoint directory (default: the config's "
                             "TRAINING.CHECKPOINT_PATH/MODEL.NAME)")
    parser.add_argument("--features-dir", type=str, default=None)
    parser.add_argument("--output", type=str, default="captions.json")
    parser.add_argument("--beam", type=int, default=None)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--f32", action="store_true", help="disable bf16 decode")
    parser.add_argument("--cpu", action="store_true", help="decode on the CPU, not the card")
    args = parser.parse_args(argv)

    from openviic_tpu_torch.config import get_config
    from openviic_tpu_torch.serving import CaptioningPipeline

    config = get_config(args.config_file)
    pipeline = CaptioningPipeline(config, checkpoint_dir=args.checkpoint_dir,
                                  beam_size=args.beam, batch_size=args.batch,
                                  use_bf16=not args.f32, device="cpu" if args.cpu else "cuda")
    features_dir = args.features_dir or config.DATASET.FEATURE_PATH.FEATURES
    captions = pipeline.caption_directory(features_dir)
    with open(args.output, "w") as f:
        json.dump(captions, f, ensure_ascii=False, indent=1)
    print(f"wrote {len(captions)} captions to {args.output}")


if __name__ == "__main__":
    main()
