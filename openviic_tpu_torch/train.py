"""Train a captioner with the port (the counterpart of the JAX package's
``train.py``):

    python -m openviic_tpu_torch.train --config-file <yaml> [--eval-only]
        [--max-epochs N] [--cpu] [KEY VALUE ...]

It builds the config's trainer on the card (``--cpu``: on the CPU), trains
from ``last_model`` or from scratch unless ``--eval-only``, then writes the
test split's predictions and scores (``test_results.json``).  ``KEY VALUE``
pairs override the config (e.g. ``TRAINING.WARMUP 100``).  PyYAML is
imported only to parse the file.

On a host with several cards it trains data parallel as the JAX
``train.py`` does on one host's devices: over ``gcd(FEATURE_BATCH_SIZE,
cards)`` cards when ``TRAINING.DATA_PARALLEL`` is on (the default), with
``FEATURE_BATCH_SIZE`` the global batch, by starting one process a card
itself (``parallel/launch.py``, NCCL); a rank that fails ends the run with
a non-zero exit.

Under ``torchrun`` (the JAX package's several hosts) it trains
data-parallel, one process a card:

    torchrun --nproc_per_node=N -m openviic_tpu_torch.train --config-file <yaml> [--cpu]

Each process takes the card ``cuda:<LOCAL_RANK>`` (``--cpu``: the CPU) and
starts the process group on it before the trainer is built, as the JAX
``train.py`` calls ``initialize_distributed()``: NCCL on the cards, gloo on
the CPU (``parallel/runtime.py``).  The config must then set
``DATASET.LOADER: grain`` and ``DATASET.MAX_REGIONS`` (or ``PAD_SIZES``);
``FEATURE_BATCH_SIZE`` is each process's share of the global batch."""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="OpenViIC-TPU, PyTorch port")
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--eval-only", action="store_true",
                        help="skip training; only run the test-set predictions")
    parser.add_argument("--max-epochs", type=int, default=None, help="cap training epochs")
    parser.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotted config overrides, e.g. TRAINING.WARMUP 100")
    args = parser.parse_args(argv)

    from openviic_tpu_torch.config import get_config
    from openviic_tpu_torch.parallel import initialize_distributed, launch, runtime

    config = get_config(args.config_file, args.opts or None)
    if not args.cpu and not all(k in os.environ for k in runtime.TORCHRUN_ENV):
        import torch

        axis = launch.data_axis(config, torch.cuda.device_count())
        if axis > 1:  # one process a card, started here
            from openviic_tpu_torch import train as importable  # (not __main__)

            launch.spawn(importable.run, [f"cuda:{i}" for i in range(axis)],
                         args=(config, args.eval_only, args.max_epochs))
            return
    device = "cpu" if args.cpu else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    started = initialize_distributed(device)
    try:
        run(device, config, args.eval_only, args.max_epochs)
    finally:
        if started:
            runtime.shutdown()


def run(device, config, eval_only: bool = False, max_epochs: Optional[int] = None) -> None:
    """Build the config's trainer on ``device``, train it unless
    ``eval_only``, then write the test split's predictions (one rank of a
    launched run, or the whole run)."""
    from openviic_tpu_torch.builders import build_trainer

    trainer = build_trainer(config, device=device)
    if not eval_only:
        trainer.start(max_epochs=max_epochs)
    trainer.get_predictions(get_scores=config.TRAINING.GET_SCORES)


if __name__ == "__main__":
    main()
