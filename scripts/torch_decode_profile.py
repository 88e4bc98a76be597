#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/H100 port, per decode path.

    python3 scripts/torch_decode_profile.py            # on a machine with one NVIDIA GPU
    python3 scripts/torch_decode_profile.py --cpu      # tiny widths, CPU (no device metrics)
    python3 scripts/torch_decode_profile.py --out report.json  # the JSON also to a file

Builds the flagship captioner of ``chip_smoke.py`` (random weights from
seed 0) and its Object Relation Transformer with the trig embedding (seed
1, boxes in pixels), then, for each decode path (head kernel, without and
with ``OPENVIIC_PALLAS=1``; attention kernel + head kernel; resident kernel
+ head kernel; non-resident, without a flag, with ``OPENVIIC_FUSED_STEP=1``
and with ``OPENVIIC_PALLAS=1``; the ORT, path (g) of ``chip_smoke.py``,
without and with ``OPENVIIC_GEO_FUSED=1``), decodes one warm-up request and
one profiled request of one full batch under ``torch.profiler``.  It
prints, per path: the host-clock seconds of the request and per decode step
(the profiler's own overhead included), the summed device time of all
kernels (a single stream, so the sum is the device's busy time) and its
share of the request (the rest is device idle, waiting for the host), and
the device time and launches of the heaviest kernels and of every kernel
of the port's own (``csrc/``).  The last line is one JSON object with those
numbers."""

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
    "ort_trig(g)+head_kernel": dict(head_kernel=1, ort=True),
    "ort_trig(g)+head_kernel+OPENVIIC_GEO_FUSED": dict(head_kernel=1, ort=True, geo=True),
}
ENV_FLAGS = {"fused": "OPENVIIC_FUSED_STEP", "pallas": "OPENVIIC_PALLAS",
             "geo": "OPENVIIC_GEO_FUSED"}


# the kernels of the port's csrc/, by a part of their names as the profiler
# shows them (fused_attention's tiles are mma::, decode:: and simt::kernel)
PORT_KERNELS = ("head_topk_", "beam_select_", "step_kernel<", "geo_attention_", "::mma::kernel<",
                "::decode::kernel<", "::simt::kernel<")


def is_port_kernel(name: str) -> bool:
    return any(part in name for part in PORT_KERNELS)


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
    ort = CaptioningPipeline(chip_smoke.ort_config(s, trig=True), vocab, batch_size=s["batch"],
                             device=device, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2 * s["batch"], s["n_regions"], s["d_feature"]),
                                dtype=np.float32)
    boxes = chip_smoke.pixel_boxes(torch.Generator().manual_seed(8), 2 * s["batch"],
                                   s["n_regions"], torch.full((2 * s["batch"],), s["n_regions"]))
    images = [{"region_features": f, "region_boxes": b} for f, b in zip(feats, boxes.numpy())]
    inputs = {
        False: (pipe, s["beam"], pipe._batch([{"region_features": f} for f in feats[: s["batch"]]]),
                pipe._batch([{"region_features": f} for f in feats[s["batch"]:]])),
        True: (ort, ort.beam_size, ort._batch(images[: s["batch"]]),
               ort._batch(images[s["batch"]:])),
    }
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
        owner, beam, warm, batch = inputs[flags.pop("ort", False)]
        searcher = BeamSearcher(owner.model, torch.bfloat16, **flags)
        searcher(warm, beam)
        chip_smoke.sync(device)
        steps0 = searcher.steps
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            searcher(batch, beam)
            chip_smoke.sync(device)
            seconds = time.perf_counter() - t0
        steps = searcher.steps - steps0
        kernels = chip_smoke.device_times(prof)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        busy_ms = sum(ms for ms, _ in kernels.values()) if device.type == "cuda" else None
        entry = {
            "request_s": seconds, "steps": steps, "ms_per_step": seconds * 1e3 / steps,
            "device_busy_ms": busy_ms,
            "device_busy_share": None if busy_ms is None else busy_ms / (seconds * 1e3),
            "top_kernels_ms": {k: ms for k, (ms, _) in top},
            "top_kernels_launches": {k: count for k, (_, count) in top},
            "port_kernels": {k: {"ms": ms, "launches": count} for k, (ms, count) in kernels.items()
                             if is_port_kernel(k)},
        }
        report["paths"][name] = entry
        busy = ("device busy not measured (CPU run)" if busy_ms is None else
                f"device busy {busy_ms:.2f} ms = {entry['device_busy_share']:.3f} of the request")
        print(f"{name}: {seconds:.4f} s under the profiler for {steps} steps "
              f"({entry['ms_per_step']:.3f} ms per step); {busy} on {card}", flush=True)
        for key, (ms, count) in top:
            print(f"    {ms:9.3f} ms  {count:5d} launches  {key[:100]}", flush=True)
        for key, value in entry["port_kernels"].items():
            print(f"    port kernel: {value['ms']:9.3f} ms  {value['launches']:5d} launches "
                  f"({value['ms'] / value['launches']:.4f} ms each)  {key[:80]}", flush=True)
    for var in ENV_FLAGS.values():
        os.environ.pop(var, None)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
