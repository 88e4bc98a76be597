#!/usr/bin/env python3
"""Where the resident layer-step kernel's time goes, phase by phase, on the card.

    python3 scripts/torch_resident_step_phases.py     # on a machine with one NVIDIA GPU

Builds ``openviic_tpu_torch/csrc/layer_step.cu`` four ways through
``ops/cuda_build.py``: clusters of two CTAs (the port's build) and of one
(``-DOPENVIIC_RESIDENT_CLUSTER=1``), each without and with its phase marks
(``-DOPENVIIC_PHASES``: the consumer warps read the GPU's global timer,
``%globaltimer``, after the staging of the inputs, after each product and
attention phase and at the end).  Then, at the flagship decode step of
``chip_smoke.py`` (N = 1600 rows, t = 12, layer-0 weights from seed 0), for
each cluster size: the kernel's time without the marks and with them (a
CUDA graph of 20 launches between CUDA events), its agreement with the
plain version, and the mean microseconds per CTA of each phase.  Prints
the card's name and power limit first."""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from openviic_tpu_torch.ops import cuda_build, layer_step  # noqa: E402

PHASES = ("stage inputs", "qkv product", "self-attention", "wo product + LN1", "wqc product",
          "cross-attention", "woc product + LN2", "w1 product", "w2 product + cluster sum",
          "LN3")
PHASE_CTAS, PHASE_SLOTS = 1024, 16  # csrc/layer_step.cu's phase_clock
CLUSTER_BUILDS = ((), ("-DOPENVIIC_RESIDENT_CLUSTER=1",))  # clusters of 2 CTAs, of 1
MARKS = ("-DOPENVIIC_PHASES",)


def resident_launch(lib, args, t, weights, n_heads):
    """One launch of the resident kernel of the build ``lib`` (the operands
    as ``resident_layer_step`` takes them); returns y."""
    x, k_cache, v_cache, cross_k, cross_v, anc, smask, cmask, is_pad = args
    x2 = x[:, 0]
    N, D = x2.shape
    _, beam, L = anc.shape
    y, k_new, v_new = (torch.empty_like(x2) for _ in range(3))
    ptrs = [x2.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cross_k.data_ptr(),
            cross_v.data_ptr(), anc.data_ptr(), smask.data_ptr(), cmask.data_ptr(),
            is_pad.data_ptr(), *layer_step.weight_ptrs(weights), y.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr()]
    layer_step.launch("resident_layer_step", True, ptrs, N, L, cross_k.shape[1], D,
                      weights["w1"].shape[1], n_heads, beam, t, x.device, lib=lib)
    return y


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    print(chip_smoke.nvidia_smi_line(), flush=True)

    builds = [defines + marks for defines in CLUSTER_BUILDS for marks in ((), MARKS)]
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc each, all at once
        list(pool.map(lambda defines: cuda_build.build(["layer_step"], defines=defines),
                      builds))

    from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step_reference
    from openviic_tpu_torch.serving import CaptioningPipeline

    s = chip_smoke.FLAGSHIP
    pipe = CaptioningPipeline(chip_smoke.model_config(s), chip_smoke.make_vocab(s),
                              batch_size=s["batch"], device=device, seed=0)
    weights = pipe.model.decoder.layers[0].fused_weights(torch.bfloat16)
    L, M, h, D, F = s["max_len"], s["n_regions"], s["heads"], s["d_model"], s["d_ff"]
    img, t = s["batch"], L // 2
    N = img * s["beam"]
    c = chip_smoke.step_case(torch.Generator().manual_seed(2), img, s, t, device)
    args = (c["x"][:, None], c["k"], c["v"], c["ck"], c["cv"], c["anc"],
            c["smask"].reshape(N, 1, 1, L), c["cmask"].reshape(img, 1, 1, M), c["is_pad"])
    want = resident_layer_step_reference(*args, t, weights, h)[0][:, 0]

    for defines in CLUSTER_BUILDS:
        plain_lib, marked = layer_step.library(defines), layer_step.library(defines + MARKS)
        occ = layer_step.resident_occupancy(N, D, F, L, M, h, lib=plain_lib)
        times, ulps = [], 0.0
        for lib in (plain_lib, marked):
            y = resident_launch(lib, args, t, weights, h)
            torch.cuda.synchronize()
            assert y.shape == want.shape
            ulps = max(ulps, chip_smoke.ulp_errors(y, want, floor=1.0)[1])
            times.append(chip_smoke.time_cuda(
                lambda: resident_launch(lib, args, t, weights, h), 20, graph=True))
        resident_launch(marked, args, t, weights, h)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (PHASE_CTAS * PHASE_SLOTS))()
        marked.openviic_phase_clock.argtypes = [ctypes.c_void_p]
        cuda_build.check_launch("phase clock copy",
                                marked.openviic_phase_clock(ctypes.addressof(buf)))
        clock = np.array(buf, dtype=np.float64).reshape(PHASE_CTAS, PHASE_SLOTS)[: occ["grid"]]
        per_phase = np.diff(clock[:, : len(PHASES) + 1], axis=1).mean(axis=0) / 1e3
        span = (clock[:, len(PHASES)].max() - clock[:, 0].min()) / 1e3
        print(f"cluster {occ['cluster']} ({occ['grid']} CTAs, tiles of {occ['rows_per_tile']} "
              f"rows, {occ['registers']} registers, {occ['local_bytes']} local bytes): kernel "
              f"{times[0]:.4f} ms, {times[1]:.4f} ms with the timer reads, y within {ulps:.1f} "
              f"bf16 ulps of the plain version; first CTA start to last CTA end {span:.1f} us; "
              f"mean us per CTA: "
              + ", ".join(f"{name} {us:.1f}" for name, us in zip(PHASES, per_phase)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
