"""Bring a run of the original (PyTorch) OpenViIC to the port (the
counterpart of the JAX package's ``scripts/import_reference_checkpoint.py``):

    python -m openviic_tpu_torch.import_reference_checkpoint \\
        --config-file <yaml> --checkpoint <run>/best_model.pth \\
        [--vocab-bin <run>/vocab.bin] [--out DIR] [--also-last] \\
        [--allow-missing] [--cpu]

It writes ``best_model.ckpt`` (the port's checkpoint) and ``vocab.bin``
into ``--out`` (default: the config's ``TRAINING.CHECKPOINT_PATH/MODEL.NAME``),
ready for ``openviic_tpu_torch.predict``, ``openviic_tpu_torch.serve`` and,
with ``--also-last``, for training on from it.  The vocab comes from
``--vocab-bin``, else the ``vocab.bin`` beside the checkpoint, else the
config's caption files.  A ``last_model.pth`` carries its Adam moments
across; the epoch, patience, SCST-phase flags and the learning-rate
schedule's position carry either way.  ``--allow-missing`` keeps the
random init of parameters the checkpoint lacks (and ignores its keys the
model does not use).  The model is built on the card unless ``--cpu``.
PyYAML is imported only to parse the file."""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Import an original OpenViIC .pth checkpoint into the PyTorch port")
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True, help="the original *.pth")
    parser.add_argument("--vocab-bin", type=str, default=None,
                        help="the original vocab.bin (default: beside the checkpoint, else "
                             "built from the config's caption files)")
    parser.add_argument("--out", type=str, default=None, help="output directory")
    parser.add_argument("--also-last", action="store_true",
                        help="also write last_model.ckpt, to train on from it")
    parser.add_argument("--allow-missing", action="store_true",
                        help="keep the random init of parameters the checkpoint lacks")
    parser.add_argument("--cpu", action="store_true", help="build the model on the CPU")
    args = parser.parse_args(argv)

    from openviic_tpu_torch.compat.migrate import import_reference_checkpoint
    from openviic_tpu_torch.config import get_config

    report = import_reference_checkpoint(
        get_config(args.config_file), args.checkpoint, out_dir=args.out,
        vocab_bin=args.vocab_bin, write_last=args.also_last,
        allow_missing=args.allow_missing, device="cpu" if args.cpu else "cuda")
    print(f"imported -> {report['best']} (epoch {report.get('epoch')}, step {report['step']}, "
          f"missing {len(report['missing'])}, unused reference keys {len(report['unused'])})")
    for name in report["missing"]:
        print(f"  missing (random init): {name}")


if __name__ == "__main__":
    main()
