#!/usr/bin/env python3
"""Where the layer-step kernels' time goes, phase by phase, on the card.

    python3 scripts/torch_resident_step_phases.py     # on a machine with one NVIDIA GPU

Builds ``openviic_tpu_torch/csrc/layer_step.cu`` four ways through
``ops/cuda_build.py``: both kernels with clusters of two CTAs (the port's
build) and of one (``-DOPENVIIC_RESIDENT_CLUSTER=1``), each without and
with its phase marks (``-DOPENVIIC_PHASES``: the consumer warps read the
GPU's global timer, ``%globaltimer``, after the staging of the inputs,
after each product and attention phase and at the end).  Then, at the
flagship decode step of ``chip_smoke.py`` (N = 1600 rows, t = 12, layer-0
weights from seed 0): for the resident and the fused (non-resident) kernel
at each cluster size, the kernel's time without the marks and with them (a
CUDA graph of 20 launches between CUDA events), its agreement with the
plain version, and the mean microseconds per CTA of each phase.  Prints the card's name and
power limit first."""

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
FUSED_PHASES = ("stage inputs", "qkv product", "self-attention", "wo product + LN1",
                "wqc product", "cross-attention", "woc product + LN2",
                "FFN (w1 and w2 by chunks of 128)", "cluster sum", "LN3")
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


def fused_launch(lib, ins, kc, vc, t, weights, n_heads):
    """One launch of the fused kernel of the build ``lib`` (it writes row t
    of the caches in place, the same values each time); returns y."""
    x, cross_k, cross_v, smask, cmask = ins
    N, D = x.shape
    y = torch.empty_like(x)
    ptrs = [x.data_ptr(), kc.data_ptr(), vc.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            None, smask.data_ptr(), cmask.data_ptr(), None, *layer_step.weight_ptrs(weights),
            y.data_ptr(), kc.data_ptr(), vc.data_ptr()]
    layer_step.launch("fused_layer_step", False, ptrs, N, kc.shape[1], cross_k.shape[1], D,
                      weights["w1"].shape[1], n_heads, 1, t, x.device, lib=lib)
    return y


def phase_table(lib, grid, names):
    """Mean microseconds per CTA of each phase of the last launch of ``lib``,
    and the span from the first CTA's start to the last CTA's end."""
    buf = (ctypes.c_ulonglong * (PHASE_CTAS * PHASE_SLOTS))()
    lib.openviic_phase_clock.argtypes = [ctypes.c_void_p]
    cuda_build.check_launch("phase clock copy", lib.openviic_phase_clock(ctypes.addressof(buf)))
    clock = np.array(buf, dtype=np.float64).reshape(PHASE_CTAS, PHASE_SLOTS)[:grid]
    per_phase = np.diff(clock[:, : len(names) + 1], axis=1).mean(axis=0) / 1e3
    span = (clock[:, len(names)].max() - clock[:, 0].min()) / 1e3
    return per_phase, span


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
        occ = layer_step.occupancy(True, N, D, F, L, M, h, lib=plain_lib)
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
        per_phase, span = phase_table(marked, occ["grid"], PHASES)
        print(f"resident, cluster {occ['cluster']} ({occ['grid']} CTAs, tiles of "
              f"{occ['rows_per_tile']} "
              f"rows, {occ['registers']} registers, {occ['local_bytes']} local bytes): kernel "
              f"{times[0]:.4f} ms, {times[1]:.4f} ms with the timer reads, y within {ulps:.1f} "
              f"bf16 ulps of the plain version; first CTA start to last CTA end {span:.1f} us; "
              f"mean us per CTA: "
              + ", ".join(f"{name} {us:.1f}" for name, us in zip(PHASES, per_phase)),
              flush=True)

    # the fused step at the same shape: per-row cross K/V, f32 numerics
    from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step_reference

    c = chip_smoke.step_case(torch.Generator().manual_seed(3), img, s, t, device)
    rows = lambda a: a.reshape(img, M, D).repeat_interleave(s["beam"], dim=0)  # noqa: E731
    ins = (c["x"], rows(c["ck"]), rows(c["cv"]), c["smask"],
           c["cmask"].repeat_interleave(s["beam"], dim=0))
    k0, v0 = c["k"].reshape(N, L, D).clone(), c["v"].reshape(N, L, D).clone()
    want = fused_layer_step_reference(ins[0], k0.clone(), v0.clone(), *ins[1:], t, weights,
                                      h)[0]
    for defines in CLUSTER_BUILDS:
        plain_lib, marked = layer_step.library(defines), layer_step.library(defines + MARKS)
        occ = layer_step.occupancy(False, N, D, F, L, M, h, lib=plain_lib)
        times, ulps = [], 0.0
        for lib in (plain_lib, marked):
            y = fused_launch(lib, ins, k0, v0, t, weights, h)
            torch.cuda.synchronize()
            ulps = max(ulps, chip_smoke.ulp_errors(y, want)[1])
            times.append(chip_smoke.time_cuda(
                lambda: fused_launch(lib, ins, k0, v0, t, weights, h), 20, graph=True))
        fused_launch(marked, ins, k0, v0, t, weights, h)
        torch.cuda.synchronize()
        per_phase, span = phase_table(marked, occ["grid"], FUSED_PHASES)
        print(f"fused, cluster {occ['cluster']} ({occ['grid']} CTAs, tiles of "
              f"{occ['rows_per_tile']} rows, {occ['registers']} registers, {occ['local_bytes']} "
              f"local bytes): kernel {times[0]:.4f} ms, {times[1]:.4f} ms with the timer reads, "
              f"y within {ulps:.1f} bf16 ulps of the plain version; first CTA start to last CTA "
              f"end {span:.1f} us; mean us per CTA: "
              + ", ".join(f"{name} {us:.1f}" for name, us in zip(FUSED_PHASES, per_phase)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
