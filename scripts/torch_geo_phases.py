#!/usr/bin/env python3
"""Where the geometry kernel's time goes, on the card.

    python3 scripts/torch_geo_phases.py     # on a machine with one NVIDIA GPU

Builds ``openviic_tpu_torch/csrc/geo_attention.cu`` three ways through
``ops/cuda_build.py``: the port's build, one without the MMA kernel's bias
build (``-DOPENVIIC_GEO_SKIP=1``: the attention then reads whatever the
bias planes hold) and one without its attention (``-DOPENVIIC_GEO_SKIP=2``:
no Q K^T, softmax, P V or output).  At the ORT encoder shape of
``chip_smoke.py`` (320 images, 56 boxes, 8 heads of 64, dim_g 64, random
inputs from seed 5) it times each build's call (a CUDA graph of 20 calls
between CUDA events), in turns full, without the bias, without the
attention, twice over, and prints the phases' shares: the bias build is
the full time less the time without it, the attention likewise, and the
rest (staging K, V and Q, the side inputs, the barriers) what is left.
Prints the card's name and power limit first."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from openviic_tpu_torch.ops import cuda_build, geo_attention  # noqa: E402

BUILDS = {"full": (), "without the bias build": ("-DOPENVIIC_GEO_SKIP=1",),
          "without the attention": ("-DOPENVIIC_GEO_SKIP=2",)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the kernel on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    full = geo_attention._library()
    libs = {}
    for name, defines in BUILDS.items():
        if defines:
            lib = cuda_build.load("geo_attention", defines)
            lib.openviic_geo_attention.argtypes = full.openviic_geo_attention.argtypes
            lib.openviic_geo_attention.restype = full.openviic_geo_attention.restype
            libs[name] = lib
        else:
            libs[name] = full

    gen = torch.Generator().manual_seed(5)
    s = chip_smoke.FLAGSHIP
    bs, h, d = s["batch"], s["heads"], s["d_model"] // s["heads"]
    n = -(-s["n_regions"] // 8) * 8
    live = torch.randint(n // 2, s["n_regions"] + 1, (bs,), generator=gen)
    boxes = chip_smoke.pixel_boxes(gen, bs, n, live).to(device)
    mask = (torch.arange(n)[None] >= live[:, None]).reshape(bs, 1, 1, n).to(device)
    q, k, v = (torch.randn((bs, n, h, d), generator=gen).to(device, torch.bfloat16)
               for _ in range(3))
    wg = ((torch.rand((h, d), generator=gen) * 2 - 1) * (6.0 / (d + 1)) ** 0.5).to(device).t()
    bg = (0.1 * torch.randn((h,), generator=gen)).to(device)
    args = (q, k, v, boxes, wg, bg, mask, 1.0 / d ** 0.5)

    times = {name: [] for name in libs}
    try:
        for _ in range(2):
            for name, lib in libs.items():
                geo_attention._lib = lib
                times[name].append(chip_smoke.time_cuda(
                    lambda: geo_attention.geo_fused_attention(*args), 20, graph=True))
    finally:
        geo_attention._lib = full
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    bias = ms["full"] - ms["without the bias build"]
    attention = ms["full"] - ms["without the attention"]
    for name, t in times.items():
        print(f"  {name}: {', '.join(f'{x:.4f}' for x in t)} ms", flush=True)
    print(f"geo_fused_attention at {tuple(q.shape)}: {ms['full']:.4f} ms = bias build "
          f"{bias:.4f} + attention {attention:.4f} + the rest {ms['full'] - bias - attention:.4f}"
          " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
