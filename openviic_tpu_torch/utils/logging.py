"""Coloured singleton logger (the port's copy of
``openviic_tpu/utils/logging.py``): a coloured stdout handler on rank 0 and
an optional file handler.  The rank comes from ``torch.distributed`` when
it is initialised, else 0."""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[36m",
        logging.INFO: "\x1b[32m",
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
        logging.CRITICAL: "\x1b[41m",
    }
    RESET = "\x1b[0m"

    def format(self, record: logging.LogRecord) -> str:
        color = self.COLORS.get(record.levelno, "")
        return f"{color}[{record.levelname}]{self.RESET} {super().format(record)}"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@functools.lru_cache()
def setup_logger(name: str = "OpenViIC-TPU-torch", output: Optional[str] = None,
                 distributed_rank: Optional[int] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank is None:
        distributed_rank = _rank()

    if distributed_rank == 0 and not logger.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(
            _ColorFormatter("%(asctime)s %(name)s: %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(handler)

    if output is not None:
        filename = output if output.endswith((".txt", ".log")) else os.path.join(output, "log.txt")
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger
