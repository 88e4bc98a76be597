#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/H100 port, per decode path.

    python3 scripts/torch_decode_profile.py            # on a machine with one NVIDIA GPU
    python3 scripts/torch_decode_profile.py --cpu      # tiny widths, CPU (no device metrics)
    python3 scripts/torch_decode_profile.py --out report.json  # the JSON also to a file

Builds the flagship captioner of ``chip_smoke.py`` (random weights from
seed 0), then, for each decode path (head kernel, without and with
``OPENVIIC_PALLAS=1``; attention kernel + head kernel; resident kernel +
head kernel; non-resident, without a flag, with ``OPENVIIC_FUSED_STEP=1``
and with ``OPENVIIC_PALLAS=1``), decodes one warm-up request and one profiled
request of one full batch under ``torch.profiler``.  It prints, per path:
the host-clock seconds of the request and per decode step (the profiler's
own overhead included), the summed
device time of all kernels (a single stream, so the sum is the device's
busy time) and its share of the request (the rest is device idle, waiting
for the host), and the device time of the heaviest kernels.  The last line
is one JSON object with those numbers."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

PATHS = {
    "head_kernel": dict(head_kernel=1),
    "attn_kernel+head_kernel": dict(attn_kernel=True, head_kernel=1),
    "resident_kernel+head_kernel": dict(resident_kernel=True, head_kernel=1),
    "head_kernel+OPENVIIC_PALLAS": dict(head_kernel=1, pallas=True),
    "non_resident": dict(beam_resident=False),
    "non_resident+fused_step": dict(beam_resident=False, fused=True),
    "non_resident+OPENVIIC_PALLAS": dict(beam_resident=False, pallas=True),
}
ENV_FLAGS = {"fused": "OPENVIIC_FUSED_STEP", "pallas": "OPENVIIC_PALLAS"}


def device_times(prof):
    """{kernel name: device ms} summed over the profiled window."""
    out = {}
    for event in prof.key_averages():
        ms = getattr(event, "self_device_time_total", None)
        if ms is None:
            ms = getattr(event, "self_cuda_time_total", 0.0)
        if ms and event.device_type == torch.autograd.DeviceType.CUDA:
            out[event.key] = out.get(event.key, 0.0) + ms / 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="tiny widths on the CPU")
    parser.add_argument("--out", help="also write the JSON report to this file")
    args = parser.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: use --cpu", file=sys.stderr)
        return 1
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.serving import CaptioningPipeline

    s = chip_smoke.TINY if args.cpu else chip_smoke.FLAGSHIP
    device = torch.device("cpu" if args.cpu else "cuda:0")
    card = "the CPU" if args.cpu else chip_smoke.nvidia_smi_line()
    vocab = chip_smoke.make_vocab(s)
    pipe = CaptioningPipeline(chip_smoke.model_config(s), vocab, batch_size=s["batch"],
                              device=device, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2 * s["batch"], s["n_regions"], s["d_feature"]),
                                dtype=np.float32)
    warm = pipe._batch([{"region_features": f} for f in feats[: s["batch"]]])
    batch = pipe._batch([{"region_features": f} for f in feats[s["batch"] :]])
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    report = {"card": card, "batch": s["batch"], "beam": s["beam"], "paths": {}}
    for name, flags in PATHS.items():
        flags = dict(flags)
        for key, var in ENV_FLAGS.items():
            if flags.pop(key, False):
                os.environ[var] = "1"
            else:
                os.environ.pop(var, None)
        searcher = BeamSearcher(pipe.model, torch.bfloat16, **flags)
        searcher(warm, s["beam"])
        chip_smoke.sync(device)
        steps0 = searcher.steps
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            searcher(batch, s["beam"])
            chip_smoke.sync(device)
            seconds = time.perf_counter() - t0
        steps = searcher.steps - steps0
        kernels = device_times(prof)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        busy_ms = sum(kernels.values()) if device.type == "cuda" else None
        entry = {
            "request_s": seconds, "steps": steps, "ms_per_step": seconds * 1e3 / steps,
            "device_busy_ms": busy_ms,
            "device_busy_share": None if busy_ms is None else busy_ms / (seconds * 1e3),
            "top_kernels_ms": {k: v for k, v in top},
        }
        report["paths"][name] = entry
        busy = ("device busy not measured (CPU run)" if busy_ms is None else
                f"device busy {busy_ms:.2f} ms = {entry['device_busy_share']:.3f} of the request")
        print(f"{name}: {seconds:.4f} s under the profiler for {steps} steps "
              f"({entry['ms_per_step']:.3f} ms per step); {busy} on {card}", flush=True)
        for key, ms in top:
            print(f"    {ms:9.3f} ms  {key[:110]}", flush=True)
    for var in ENV_FLAGS.values():
        os.environ.pop(var, None)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
