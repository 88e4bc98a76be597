"""Structured training metrics and profiler hooks (the port's counterpart
of ``openviic_tpu/utils/metrics.py``): per-step scalars appended to
``metrics.jsonl`` in the run directory (TensorBoard too where
``torch.utils.tensorboard`` imports), a throughput meter, and a
``torch.profiler`` trace over a window of steps."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    """One JSON line per ``log``: ``step``, ``time`` and the scalars, each
    name with ``prefix``.  ``enabled=False`` keeps the API and writes
    nothing (one writer per run directory)."""

    def __init__(self, output_dir: str, tensorboard: bool = False, enabled: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._file = open(self.path if enabled else os.devnull, "a", buffering=1)
        self._tb = None
        if tensorboard and enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))
            except ImportError:  # tensorboard is not installed
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for key, value in scalars.items():
            name = f"{prefix}{key}" if prefix else key
            record[name] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(name, float(value), int(step))
        self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Throughput meter: captions (or tokens) per second since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._items = 0

    def update(self, n_items: int) -> None:
        self._items += n_items

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else 0.0


class Profiler:
    """A ``torch.profiler`` trace (CPU, and CUDA where a card is present) of
    steps [start_step, start_step + num_steps), exported as a Chrome trace
    into ``<output_dir>/profile/``."""

    def __init__(self, output_dir: str, start_step: int = 10, num_steps: int = 5):
        self.output_dir = os.path.join(output_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def step(self, step: int) -> None:
        import torch

        if step == self.start_step and self._prof is None:
            os.makedirs(self.output_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(self.output_dir, f"trace_{self.start_step}_{self.stop_step}.json"))


def maybe_enable_nan_checks(enabled: bool) -> None:
    """``TRAINING.DEBUG_NANS``: ``torch.autograd.set_detect_anomaly(True)``.
    It differs from the JAX package's ``jax_debug_nans``: it checks the
    backward pass only (a NaN that a backward function returns raises, with
    the forward operation that made it), not every forward result, and it
    stays on for the process."""
    if enabled:
        import torch

        torch.autograd.set_detect_anomaly(True)
