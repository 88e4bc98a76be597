#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``openviic_tpu_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100
    python3 chip_smoke.py --cpu    # rehearsal at tiny widths on the CPU

On the card it runs these phases, each printing its seconds:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when CUDA is unavailable;
2. build: nvcc over ``openviic_tpu_torch/csrc/*.cu`` (one process per
   source, all started together), the ptxas register/spill report, and at
   the flagship shape the occupancy of both layer-step kernels (CTAs per
   SM, cluster size, rows per tile, grid, registers, spills, shared
   memory) and of the head kernel's partial pass at k = 5, 16 and 128;
   the occupancy of both beam-select kernels and of the geo MMA kernel
   (with its slabs per phase and persistent grid); the counts of wgmma,
   mma.sync, TMA and local-memory instructions in the head, layer-step,
   beam-select and geo kernels' machine code (``cuobjdump -sass``; the geo
   MMA kernels must hold mma.sync);
3. head kernel: the ``head_topk`` CUDA kernel against its plain PyTorch
   version at the flagship decode shape (N = 320 x 5 beams = 1600 rows,
   D = 512, V = 10 000, k = 5), at the first step's 320 rows, at a ragged
   shape (N = 37, V = 7 094 and 277) and in a constructed tie case, then
   its device time (a CUDA graph) beside its bound, the plain version's and
   matmul + logsumexp + topk's, and its cost launched from Python; k = 32
   and k = 128 (the shared-memory lists) at 1600 and 320 rows against the
   plain version, with their device times; the head-kernel gate
   sweep: one beam-resident selection step through the kernel and through
   fast select from one image to 3200 rows at beams 1, 3, 5, 8 and 16,
   with the crossover (``_head_kernel_wins`` holds what it gave);
4. serve: the flagship captioner (StandardTransformerUsingRegion, d_model
   512, 8 heads, 3+3 layers, d_ff 2048, 50 x 1024-d region features, vocab
   10 000, max_len 25, random weights from a seed) built through the port's
   ``build_model`` and served through ``CaptioningPipeline.caption_features``
   at beam 5, batch 320, bf16, head kernel forced (``head_kernel=1``):
   three requests (320, 320 and 7 images).  The kernel's launch count must
   equal the decode steps, every id must lie in the vocab, and the captions
   must agree with the fast-select path on >= 95% of the images; it prints
   what the auto gate (``head_kernel=True``) resolves to there;
5. kernels vs plain: ``beam_select_attention`` (both mask axes) at a
   mid-decode step, at t = 0 and t = L - 1, with q sliced from a fused qkv
   projection, at a ragged shape (35 rows) with a fully masked row, at
   L = 40 and at the general kernel's shape (4 heads of 100), timed at
   t = 0, L // 2 and L - 1; ``resident_layer_step`` and ``fused_layer_step``
   (rows other than t bit-unchanged) at a mid-decode step and a ragged
   shape (35 rows), at N = 1600 with t = 0 and t = L - 1, and at 37 images,
   whose 185 rows leave the last cluster tile short, with the flagship's
   layer-0 weights;
   ``fused_attention`` at the encoder, the non-resident step's self- and
   cross-attention, the ORT's full-bias and a ragged f32 shape with a fully
   masked row, and at its tiles' edges (nq = 1 with nk = 1, 200 and 300,
   nq = 65, bf16 q/k/v 2 bytes off 16-byte alignment), the edge cases also
   through the tile their nq does not choose (within 2e-5; the masked row
   finite and uniform); ``geo_fused_attention`` at the ORT encoder shape,
   a ragged one, n = 72 (the MMA kernel past 64 rows), bf16 boxes and
   n = 160 (the SIMT kernel) (2 bf16 ulps on 99% of the elements, 0.05
   everywhere);
   then each one's time beside its bound, its plain version's and a PyTorch
   yardstick's (the gather + SDPA composite, the eager
   ``DecoderLayer.step``, SDPA, or box embedding + fc_gs + SDPA); every
   kernel's time is a device time (a CUDA graph of the calls), and so are
   the plain versions' and the yardsticks', fused_attention's at the
   encoder and both step shapes with the DECODE/MMA crossover over nq;
   beside them each launch's cost from
   Python (CUDA events and the host's clock, without a graph);
6. decode paths at the serve shape over the same requests: (a)
   ``TRAINING.DECODE_ATTN_KERNEL`` in the pipeline, (b) ``resident_kernel``,
   (c) ``beam_resident=False`` with ``OPENVIIC_FUSED_STEP=1`` and without;
   each asserts its kernels' launches per step, valid ids and a mean
   best-beam log-prob within 0.5% of its reference path's, and prints its
   captions/s and caption agreement; path (a)'s own beam-select inputs at
   t = L // 2 (layer 0), captured while it serves a request, against the
   plain version, timed beside the kernel's mean time per launch over a
   request of path (a) under torch.profiler;
7. forced decode: the served captions fed back through each kernel path
   and the eager step, per-step log-probs compared;
8. attention paths: (d) ``OPENVIIC_PALLAS=1`` on the served path (the
   encoder), (e) the same with ``beam_resident=False`` (the decoder's
   attention too), (f) the Object Relation Transformer
   (``configs/object_relation_transformer.yaml`` at full width, beam 3) with
   the trig embedding off, with and without ``OPENVIIC_PALLAS=1``, (g) with
   it on, with and without ``OPENVIIC_GEO_FUSED=1``; launches per request
   and step, valid ids and score parity with each flag-off twin, then the
   forced decode of (d), (e) and (g) against their twins ((g) with the
   pipeline's f32 boxes and with the bf16 boxes the beam search casts);
9. the last line: ``{"ok": true, "device": {...}}``.

The line before the last is a JSON object with one entry per kernel (six:
its launches on its decode path, error, times and bound); the line before
that is the card's name and power limit.  Any failure raises, and the
script exits non-zero without those lines.  ``--cpu`` runs phases 3-8 at
tiny widths with the plain versions on the CPU and ends with ``cpu
rehearsal ok`` instead.  The script writes nothing outside
``openviic_tpu_torch/_build/``.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True  # write nothing into the checkout but _build/

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (dense, no sparsity) for the bound column.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# transcendentals (sin, cos, exp, log) at the special-function rate: 16
# MUFU results per SM per clock, 132 SMs, the 1.98 GHz boost clock
PEAK_SFU_OPS = 132 * 16 * 1.98e9

FLAGSHIP = dict(d_model=512, heads=8, layers=3, d_ff=2048, d_feature=1024,
                n_regions=50, vocab=10_000, max_len=25, beam=5, batch=320, ort_beam=3)
TINY = dict(d_model=32, heads=2, layers=2, d_ff=64, d_feature=24,
            n_regions=7, vocab=300, max_len=12, beam=5, batch=8, ort_beam=3)
AGREEMENT_MIN = 0.95
LSE_ATOL = 1e-3
ULP_FLOOR = 1 / 16  # bf16 ulps are counted at magnitudes of at least this
# resident_layer_step's y against its plain version: both round the same
# intermediates through bf16 (products' operands, q.k products, softmax
# weights); an f32 sum taken in another order can flip one such rounding,
# which moves y by a few ulps at most
RESIDENT_Y_ULPS = 4
RESIDENT_Y_SHARE = 0.01
# a decode path's mean best-beam log-prob against its reference path's
SCORE_RTOL = 0.005
# a forced token's per-step log-prob through a kernel path against the
# eager step's: two bf16 ulps of a logit in [16, 32), as the head's bf16
# logits round at 0.125 there
FORCED_ATOL = 0.25
FORCED_SHARE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def model_config(s, attn_kernel: bool = False):
    from openviic_tpu_torch.config import ConfigNode

    def attn():
        return {
            "ARCHITECTURE": "ScaledDotProductAttention", "HEAD": s["heads"],
            "D_MODEL": s["d_model"], "D_KEY": s["d_model"] // s["heads"],
            "D_VALUE": s["d_model"] // s["heads"], "D_FF": s["d_ff"],
            "D_FEATURE": s["d_ff"], "MEMORY": 40, "USE_AOA": False,
            "CAN_BE_STATEFUL": False, "DROPOUT": 0.1,
        }

    model = {
        "ARCHITECTURE": "StandardTransformerUsingRegion",
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding",
                             "D_FEATURE": s["d_feature"], "D_MODEL": s["d_model"],
                             "DROPOUT": 0.1},
        "ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": s["d_model"],
                    "LAYERS": s["layers"], "SELF_ATTENTION": attn()},
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": s["d_model"], "LAYERS": s["layers"],
            "ATTENTION": {"D_MODEL": s["d_model"], "SELF_ATTENTION": attn(),
                          "ENC_ATTENTION": attn()},
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": s["d_model"],
                               "D_EMBEDDING": 300, "WORD_EMBEDDING": None,
                               "WORD_EMBEDDING_CACHE": None, "DROPOUT": 0.1},
        },
    }
    # an int forces the head kernel (True is the measured auto gate): the
    # paths below hold it to one launch per decode step
    training = {"EVALUATING_BEAM_SIZE": s["beam"], "DECODE_HEAD_KERNEL": 1,
                "DECODE_ATTN_KERNEL": attn_kernel}
    return ConfigNode({"MODEL": model, "TRAINING": training})


def make_vocab(s):
    from openviic_tpu_torch.data import Vocab

    specials = ["<pad>", "<bos>", "<eos>", "<unk>"]
    return Vocab(specials + [f"w{i}" for i in range(s["vocab"] - 4)], s["max_len"])


# ---------------------------------------------------------------- phase 3
def exact_inputs(gen, n, d, v, device):
    """bf16 inputs whose products and f32 sums are exact (multiples of
    1/512 below 2^15 in magnitude), so every summation order gives the same
    logits and ids must match exactly."""
    x = torch.randint(-8, 9, (n, d), generator=gen).float() / 8
    w = torch.randint(-8, 9, (v, d), generator=gen).float() / 64
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def gaussian_inputs(gen, n, d, v, device):
    """Decode-like inputs: a layer-normed hidden state and the head's init."""
    x = torch.randn((n, d), generator=gen)
    w = (torch.rand((v, d), generator=gen) * 2 - 1) / d ** 0.5
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, exponent = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exponent - 8)


def compare(name, x, w, k, exact: bool):
    """Kernel (wrapper) against the plain version on the same inputs.
    Returns the largest absolute error over values and lse."""
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference

    vals, idxs, lse = head_topk(x, w, k)
    rv, ri, rl = head_topk_reference(x, w, k + 1)
    if x.is_cuda:
        torch.cuda.synchronize()
    if vals.shape != (x.shape[0], k) or idxs.shape != vals.shape or lse.shape != (x.shape[0],):
        raise AssertionError(f"{name}: output shapes {vals.shape}, {idxs.shape}, {lse.shape}")
    if not (torch.isfinite(vals).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: non-finite output")
    val_err = (vals - rv[:, :k]).abs()
    if (val_err > bf16_ulp(rv[:, :k])).any():
        raise AssertionError(f"{name}: values differ by more than 1 bf16 ulp "
                             f"(max {val_err.max().item()})")
    lse_err = (lse - rl).abs().max().item()
    if lse_err > LSE_ATOL:
        raise AssertionError(f"{name}: lse differs by {lse_err} > {LSE_ATOL}")
    same = (idxs == ri[:, :k]).all(dim=1)
    if exact:
        excluded = torch.zeros_like(same)
    else:
        # a gap of at most one ulp among the top k+1 is a near-tie that two
        # summation orders may round either way
        gaps = rv[:, :-1] - rv[:, 1:]
        excluded = (gaps <= bf16_ulp(rv[:, :-1])).any(dim=1)
    bad = int((~same & ~excluded).sum())
    if bad:
        raise AssertionError(f"{name}: ids differ on {bad} rows")
    err = max(val_err.max().item(), lse_err)
    log(f"  {name}: N={x.shape[0]} D={x.shape[1]} V={w.shape[0]} k={k}: ids equal"
        f"{'' if exact else f' on {int((~excluded).sum())} rows without a 1-ulp near-tie ({int(excluded.sum())} near-tie rows, {int((~same).sum())} of them differ)'}"
        f", max |dval| {val_err.max().item():.3g}, max |dlse| {lse_err:.3g}")
    return err, (vals, idxs, lse)


def tie_case(gen, device, k):
    """Duplicated head rows give exactly equal logits; the lower id must come
    first, in the kernel as in the plain version."""
    from openviic_tpu_torch.ops.head_topk import head_topk_reference

    x, w = exact_inputs(gen, 64, 512, FLAGSHIP["vocab"], device)
    V = w.shape[0]
    top = head_topk_reference(x, w, 1)[1][:, 0].long().unique()
    for orig in top.tolist():
        w[(orig + V // 2) % V] = w[orig]  # the copy lands above or below
    _, (vals, idxs, _) = compare("tie case", x, w, k, exact=True)
    tied = vals[:, 0] == vals[:, 1]
    if int(tied.sum()) == 0 or not (idxs[tied, 0] < idxs[tied, 1]).all():
        raise AssertionError("tie case: no tie, or a tie not resolved to the lower id")
    log(f"  tie case: {int(tied.sum())} rows with a tied top-2, all resolved to the lower id")


def time_cuda(fn, iters: int, graph: bool = False) -> float:
    """ms per call of ``fn`` over ``iters`` calls, between CUDA events.  With
    ``graph`` the calls are captured once into a CUDA graph and replayed, so
    the time is the device's alone, without the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        captured.replay()
        run = captured.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_costs(fn, iters: int) -> dict:
    """What ``fn`` costs launched from Python, one call after another: ms
    per call between CUDA events (``launch_ms``; the device's time, or the
    host's where the host is slower) and ms of the host's clock per call
    until the last one returns (``host_ms``: the wrapper's own cost, its
    checks, ctypes call and launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(launch_ms=start.elapsed_time(end) / iters, host_ms=host * 1e3 / iters)


def head_bound(N, D, V, k):
    """The head kernel's bound: its bf16 products at the tensor-core peak
    against x and w read once and the outputs written once."""
    flops = 2.0 * N * D * V
    bytes_moved = (N * D + V * D) * 2 + N * k * (4 + 4) + N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, bytes_moved


def kernel_phase(device, s):
    """head_topk against its plain version at the decode rows (N = batch x
    beam) and the first step's (N = batch), a ragged shape at two vocab
    sizes and the tie case; then device times (CUDA graphs) of the kernel,
    its plain version and matmul + logsumexp + topk, and the kernel's host
    cost per call launched from Python."""
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference

    gen = torch.Generator().manual_seed(0)
    N, D, V, k = s["batch"] * s["beam"], s["d_model"], s["vocab"], s["beam"]
    compare("main shape, exact inputs", *exact_inputs(gen, N, D, V, device), k, exact=True)
    x, w = gaussian_inputs(gen, N, D, V, device)
    err, _ = compare("main shape, gaussian inputs", x, w, k, exact=False)
    x0, w0 = gaussian_inputs(gen, s["batch"], D, V, device)
    err = max(err, compare("first step's rows, gaussian inputs", x0, w0, k, exact=False)[0])
    for ragged_v in ((7094, 277) if s is FLAGSHIP else (277,)):
        compare("ragged shape", *exact_inputs(gen, 37, D, ragged_v, device), k, exact=True)
    if s is FLAGSHIP:
        tie_case(gen, device, k)
    if device.type != "cuda":
        return None

    def library():
        logits = x @ w.T
        return torch.logsumexp(logits.float(), dim=1), torch.topk(logits, k, dim=1)

    ms = time_cuda(lambda: head_topk(x, w, k), 50, graph=True)
    plain_ms = time_cuda(lambda: head_topk_reference(x, w, k), 10, graph=True)
    library_ms = time_cuda(library, 50, graph=True)
    costs = host_costs(lambda: head_topk(x, w, k), 50)
    ms0 = time_cuda(lambda: head_topk(x0, w0, k), 50, graph=True)
    bound_ms, bound_by, flops, bytes_moved = head_bound(N, D, V, k)
    log(f"  head_topk at N={N} D={D} V={V} k={k}: kernel {ms:.4f} ms (launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, matmul+logsumexp+topk {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.2f} MB); "
        f"at N={s['batch']}: kernel {ms0:.4f} ms, "
        f"bound {head_bound(s['batch'], D, V, k)[0]:.4f} ms")
    return entry("head_topk", "openviic_tpu_torch/csrc/head_topk.cu",
                 "openviic_tpu/ops/head_topk.py:103", err, ms, plain_ms, bound_ms, bound_by,
                 library_ms, first_step_ms=ms0, **costs)


# ---------------------------------------------------------------- phase 4
def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_requests(device, requests, decode):
    """decode(request) -> (captions, ids[, totals]) over each request,
    host-timed around work that ends in a synchronize.  Returns (results,
    seconds)."""
    results, seconds = [], []
    for request in requests:
        t0 = time.perf_counter()
        out = decode(request)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        results.append(out)
    return results, seconds


def check_outputs(name, s, vocab, requests, results) -> None:
    """Every request gets one caption of vocab words per image and ids of
    the right shape, all inside the vocab."""
    for request, (captions, ids, *_) in zip(requests, results):
        if len(captions) != len(request) or ids.shape != (len(request), s["max_len"]):
            raise AssertionError(f"{name}: {len(captions)} captions, ids {ids.shape} for "
                                 f"{len(request)} images")
        if ids.min() < 0 or ids.max() >= len(vocab):
            raise AssertionError(f"{name}: token id outside [0, {len(vocab)}): "
                                 f"{ids.min()}..{ids.max()}")
        for caption in captions:
            if not isinstance(caption, str) or any(
                tok not in vocab.stoi or tok in vocab.specials for tok in caption.split()
            ):
                raise AssertionError(f"{name}: caption not made of vocab words: {caption!r}")


def agreement(results, other) -> float:
    """The share of images whose captions are identical in two runs."""
    pairs = [(a, b) for ra, rb in zip(results, other) for a, b in zip(ra[0], rb[0])]
    return float(np.mean([a == b for a, b in pairs]))


def throughput(s, seconds) -> float:
    """Captions per second over the two full-batch requests."""
    return 2 * s["batch"] / (seconds[0] + seconds[1])


def serve_phase(device, s, card: str):
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.serving import CaptioningPipeline

    config, vocab = model_config(s), make_vocab(s)
    pipe = CaptioningPipeline(config, vocab, batch_size=s["batch"], device=device, seed=0)
    rng = np.random.default_rng(0)
    n_images = 2 * s["batch"] + 7
    feats = rng.standard_normal((n_images, s["n_regions"], s["d_feature"]), dtype=np.float32)
    images = [{"region_features": f} for f in feats]
    requests = [images[: s["batch"]], images[s["batch"] : 2 * s["batch"]], images[2 * s["batch"] :]]
    pipe.caption_features(requests[2])  # warm-up: cuBLAS handles, allocator

    sync(device)
    head_topk.launches = 0
    steps0 = pipe.searcher.steps
    results, seconds = run_requests(
        device, requests, lambda request: pipe.caption_features(request, return_ids=True))
    launches = head_topk.launches
    steps = pipe.searcher.steps - steps0
    expected = steps if device.type == "cuda" else 0
    if steps <= 0 or launches != expected:
        raise AssertionError(f"head_topk launched {launches} times over {steps} decode steps")
    check_outputs("serve", s, vocab, requests, results)
    log(f"  served {sum(len(r) for r in requests)} images in requests of "
        f"{[len(r) for r in requests]}: {[round(t, 4) for t in seconds]} s; "
        f"{steps} decode steps, {launches} head_topk launches")
    log(f"  decode throughput at batch {s['batch']}, beam {s['beam']}: "
        f"{throughput(s, seconds):.1f} captions/s on {card}")
    auto = BeamSearcher(pipe.model, head_kernel=True).effective_head_kernel(
        pipe._batch(requests[0]), s["beam"])
    log(f"  head_kernel=True (the auto gate) resolves to {auto} at {s['batch']} images x "
        f"beam {s['beam']}; the serve phase forces the kernel with head_kernel=1")
    log(f"  sample caption: {results[0][0][0]!r}")

    fast = CaptioningPipeline(config, vocab, batch_size=s["batch"], head_kernel=False,
                              device=device, seed=0)
    fast_captions = fast.caption_features(requests[0])
    same = np.mean([a == b for a, b in zip(results[0][0], fast_captions)])
    log(f"  captions identical to the fast-select path: {same:.4f} of {len(fast_captions)}")
    if same < AGREEMENT_MIN:
        raise AssertionError(f"agreement {same:.4f} < {AGREEMENT_MIN}")
    return dict(launches=launches, pipe=pipe, vocab=vocab, requests=requests,
                results=results, steps=steps)


# ---------------------------------------------------------------- phase 5
def ulp_errors(got: torch.Tensor, want: torch.Tensor, floor: float = ULP_FLOOR):
    """(max |error|, max error in bf16 ulps, share of elements beyond one
    ulp); ulps are counted at max(|want|, floor): below the floor, f32 sums
    of unit-size terms in another order differ by more than a bf16 ulp of
    the small result."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulps = err / bf16_ulp(w.abs().clamp_min(floor))
    return err.max().item(), ulps.max().item(), (ulps > 1).float().mean().item()


def step_case(gen, img, s, t, device):
    """Inputs of one mid-decode step (bf16 activations and caches): an
    ancestry whose own slot holds position t, <pad> input tokens on ~5% of
    the rows, raw per-slot <pad> flags at ~10% of the earlier positions after
    0 (at t, the slot's own input token's), positions past t masked, images
    with 25-50 live regions."""
    beam, L, M, D, h = s["beam"], s["max_len"], s["n_regions"], s["d_model"], s["heads"]
    N, d = img * beam, D // h

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    anc = torch.randint(0, beam, (img, beam, L), generator=gen)
    anc[:, :, t] = torch.arange(beam)
    is_pad = torch.rand((N, 1), generator=gen) < 0.05
    pads = torch.rand((N, L), generator=gen) < 0.1
    pads[:, 0] = False
    pads[:, t] = is_pad[:, 0]  # each slot's flag at t is its current input token's
    live_regions = torch.randint(M // 2, M + 1, (img,), generator=gen)
    case = dict(
        x=randn(N, D), k=randn(N, L, h, d), v=randn(N, L, h, d),
        ck=randn(img, M, h, d), cv=randn(img, M, h, d), anc=anc,
        smask=pads | (torch.arange(L) > t)[None],
        cmask=torch.arange(M)[None] >= live_regions[:, None], is_pad=is_pad,
    )
    return {k: v.to(device) for k, v in case.items()}


def distinct_rows(rows: torch.Tensor, live: torch.Tensor) -> int:
    """How many distinct cache rows the live (row, position) pairs read."""
    return int(torch.unique(rows[live]).numel())


def bound(flops: float, peak_flops: float, nbytes: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def unit_bound(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0,
               sfu_ops: float = 0.0):
    """The bound of a call whose operations run on several units at once:
    products of bf16 operands (f32 accumulation) at the tensor-core peak,
    products with an f32 operand at the f32 peak, transcendentals at the
    special-function rate; the largest of those times and the bytes' time.
    Returns (bound_ms, bound_by, {term: ms})."""
    times = {"bytes": nbytes / PEAK_HBM_BYTES * 1e3,
             "bf16 products": bf16_flops / PEAK_BF16_FLOPS * 1e3,
             "f32 products": f32_flops / PEAK_F32_FLOPS * 1e3,
             "transcendentals": sfu_ops / PEAK_SFU_OPS * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes" else "operations", times


def bound_detail(times) -> str:
    return ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())


def entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **extra)


def check_beam_select(name, args, mask_axis, device):
    """The kernel against its plain version within one bf16 ulp; returns
    max |error|."""
    from openviic_tpu_torch.ops.beam_select_attention import (
        beam_select_attention, beam_select_attention_reference, kernel_route)

    got = beam_select_attention(*args, mask_axis=mask_axis)
    want = beam_select_attention_reference(*args, mask_axis=mask_axis)
    sync(device)
    err, ulps, _ = ulp_errors(got, want)
    if not torch.isfinite(got).all() or ulps > 1:
        raise AssertionError(f"beam_select_attention {name} mask_axis={mask_axis}: "
                             f"{ulps:.2f} bf16 ulps (max |err| {err:.3g}) > 1")
    route = kernel_route(*args[:3]) if device.type == "cuda" else "plain"
    log(f"  beam_select_attention {name} mask_axis={mask_axis} (route {route}): "
        f"max |err| {err:.3g} = {ulps:.2f} bf16 ulps")
    return err


def beam_select_phase(device, s):
    """ops.beam_select_attention against its plain version: the main shape
    at mid-decode (t = L // 2) with both mask axes, at t = 0 and t = L - 1,
    q sliced from a fused qkv projection (as the decode gives it), a ragged
    shape (7 images, 35 rows) at the last step with a fully masked row,
    L = 40 (two chunks of 32 positions) and the general kernel's shape (4
    heads of 100); then times at t = 0, L // 2 and L - 1, the bound and the
    yardstick at t = L // 2."""
    from openviic_tpu_torch.ops.beam_select_attention import (
        ancestor_rows, beam_select_attention, beam_select_attention_reference)

    gen = torch.Generator().manual_seed(1)
    beam, L, D, h = s["beam"], s["max_len"], s["d_model"], s["heads"]
    worst, timed = 0.0, {}

    def args_of(c, img, LL, axis):
        N = img * beam
        src = ancestor_rows(c["anc"])
        mask = c["smask"] if axis == "p" else c["smask"][src, torch.arange(LL, device=device)]
        return (c["x"].reshape(N, 1, h, D // h), c["k"], c["v"], c["anc"],
                mask.reshape(N, 1, 1, LL).contiguous())

    for img, t, LL, axes in ((s["batch"], L // 2, L, ("p", "q")), (s["batch"], 0, L, ("p",)),
                             (s["batch"], L - 1, L, ("p",)), (7, L - 1, L, ("p", "q")),
                             (40, 37, 40, ("p", "q"))):
        c = step_case(gen, img, dict(s, max_len=LL), t, device)
        for axis in axes:
            args = args_of(c, img, LL, axis)
            if img == 7 and axis == "q":  # a fully masked row: uniform over all L positions
                args[4][3] = True
            name = f"N={img * beam} L={LL} h={h} t={t}"
            if img == 7 and axis == "q":
                name += ", row 3 fully masked"
            worst = max(worst, check_beam_select(name, args, axis, device))
            if img == s["batch"] and axis == "p":
                timed[t] = (args, c)
    # q as the decode gives it: a slice of the fused qkv projection's rows
    args, c = timed[L // 2]
    N = s["batch"] * beam
    qkv = torch.randn((N, 1, 3 * D), generator=gen).to(device, torch.bfloat16)
    sliced = (qkv[..., :D].reshape(N, 1, h, D // h),) + args[1:]
    worst = max(worst, check_beam_select(f"N={N} t={L // 2}, q sliced from qkv", sliced, "p",
                                         device))
    # the general kernel's shape: rows of 4 x 100 elements
    g = torch.Generator().manual_seed(2)
    odd = tuple(torch.randn(shape, generator=g).to(device, torch.bfloat16)
                for shape in ((35, 1, 4, 100), (35, L, 4, 100), (35, L, 4, 100)))
    odd += (torch.randint(0, beam, (7, beam, L), generator=g).to(device),
            (torch.rand((35, 1, 1, L), generator=g) < 0.3).to(device))
    worst = max(worst, check_beam_select("N=35 h=4 d=100", odd, "q", device))
    if device.type != "cuda":
        return None

    q, k, v, anc, mask = args
    h, d = q.shape[2], q.shape[3]
    src = ancestor_rows(anc)
    pos = torch.arange(L, device=device)
    dead = c["smask"][src, pos]

    def library():  # torch.gather of the ancestor K/V, then SDPA; timed here only
        idx = anc[..., None].expand(-1, -1, -1, h * d)
        b_s = anc.shape[0]
        ks = torch.gather(k.reshape(b_s, beam, L, h * d), 1, idx).reshape(N, L, h, d)
        vs = torch.gather(v.reshape(b_s, beam, L, h * d), 1, idx).reshape(N, L, h, d)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
            attn_mask=~dead[:, None, None, :])

    times = {t: time_cuda(lambda: beam_select_attention(*a, mask_axis="p"), 50, graph=True)
             for t, (a, _) in timed.items()}
    ms = times[L // 2]
    plain_ms = time_cuda(lambda: beam_select_attention_reference(*args, mask_axis="p"), 10,
                         graph=True)
    library_ms = time_cuda(library, 50, graph=True)
    costs = host_costs(lambda: beam_select_attention(*sliced, mask_axis="p"), 50)
    live = ~dead
    rows = distinct_rows(src * L + pos, live)
    nbytes, flops = beam_select_work(N, L, h, d, rows, int(live.sum()))
    bound_ms, bound_by = bound(flops, PEAK_F32_FLOPS, nbytes)
    log(f"  beam_select_attention at N={N} L={L}: kernel {times[0]:.4f} / {ms:.4f} / "
        f"{times[L - 1]:.4f} ms at t = 0 / {L // 2} / {L - 1} (synthetic ancestry: "
        f"{rows} distinct live cache rows at t = {L // 2}); at t = {L // 2}: launched from "
        f"Python {costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call (q sliced "
        f"from qkv), plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return entry("beam_select_attention", "openviic_tpu_torch/csrc/beam_select_attention.cu",
                 "openviic_tpu/ops/beam_select_attention.py:173", worst, ms, plain_ms,
                 bound_ms, bound_by, library_ms, ms_t0=times[0], ms_tlast=times[L - 1], **costs)


def beam_select_work(N, L, h, d, rows, n_live):
    """(bytes, flops) one beam-select call must move and do: the distinct
    live K and V cache rows read once, q read and the output written, the
    ancestry and mask read; a dot and a weighted add per live position."""
    return rows * h * d * 2 * 2 + 2 * N * h * d * 2 + N * L * (8 + 1), 4.0 * n_live * h * d


def captured_beam_select(device, s, pipe, request, t):
    """Path (a)'s own inputs to beam_select_attention at decode step t
    (layer 0's call), captured while the pipeline serves ``request``: the
    kernel against its plain version within one bf16 ulp, both timed (CUDA
    graphs), and beside them the kernel's mean device time per launch
    over one profiled request of path (a) (torch.profiler)."""
    import openviic_tpu_torch.models.attention as attention
    from openviic_tpu_torch.ops.beam_select_attention import (
        ancestor_rows, beam_select_attention, beam_select_attention_reference)

    n_layers = len(pipe.model.decoder.layers)
    calls, captured = [0], {}

    def capture(q_t, k, v, ancestry, position_mask, mask_axis="q"):
        if calls[0] == t * n_layers:
            q_copy = torch.empty_strided(q_t.shape, q_t.stride(), dtype=q_t.dtype,
                                         device=q_t.device)
            q_copy.copy_(q_t)  # with the decode's row stride
            captured.update(args=(q_copy, k.clone(), v.clone(), ancestry.clone(),
                                  position_mask.clone()), mask_axis=mask_axis)
        calls[0] += 1
        return beam_select_attention(q_t, k, v, ancestry, position_mask, mask_axis=mask_axis)

    attention.beam_select_attention = capture
    try:
        pipe.caption_features(request, return_ids=True)
    finally:
        attention.beam_select_attention = beam_select_attention
    if not captured:
        raise AssertionError(f"path (a) made {calls[0]} beam-select calls, none at step {t}")
    args, axis = captured["args"], captured["mask_axis"]
    err = check_beam_select(f"captured from path (a) at t={t}", args, axis, device)
    if device.type != "cuda":
        return {}
    q, k, v, anc, mask = args
    N, L = k.shape[:2]
    src = ancestor_rows(anc)
    pos = torch.arange(L, device=device)
    pm = mask.reshape(N, L)
    live = ~(pm[src, pos] if axis == "p" else pm)
    rows = distinct_rows(src * L + pos, live)
    ms = time_cuda(lambda: beam_select_attention(*args, mask_axis=axis), 50, graph=True)
    plain_ms = time_cuda(lambda: beam_select_attention_reference(*args, mask_axis=axis), 10,
                         graph=True)
    nbytes, flops = beam_select_work(N, L, q.shape[2], q.shape[3], rows, int(live.sum()))
    bound_ms, _ = bound(flops, PEAK_F32_FLOPS, nbytes)
    profile_ms, launches = profiled_kernel_ms(
        device, lambda: pipe.caption_features(request, return_ids=True), "beam_select")
    per_launch = profile_ms / max(launches, 1)
    log(f"  beam_select_attention, path (a)'s inputs at t={t}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({rows} distinct live cache rows, "
        f"{int(live.sum())} live positions of {N} rows); profiled path (a) request: "
        f"{launches} launches, {profile_ms:.3f} ms, {per_launch:.4f} ms per launch (every step)")
    return dict(captured_t=t, captured_err=err, captured_ms=ms, captured_plain_ms=plain_ms,
                captured_bound_ms=bound_ms, profile_ms_per_launch=per_launch,
                profile_launches=launches)


def device_times(prof) -> dict:
    """{kernel name: (device ms, launches)} summed over a torch.profiler
    window."""
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us and event.device_type == torch.autograd.DeviceType.CUDA:
            total, count = out.get(event.key, (0.0, 0))
            out[event.key] = (total + us / 1e3, count + event.count)
    return out


def profiled_kernel_ms(device, fn, match: str):
    """(device ms, launches) of the CUDA kernels whose name holds ``match``
    over one call of ``fn`` under torch.profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        sync(device)
    found = [v for key, v in device_times(prof).items() if match in key]
    if not found:
        raise AssertionError(f"the profile shows no kernel named like {match!r}")
    return sum(ms for ms, _ in found), sum(count for _, count in found)


def layer_step_phase(device, s, layer, resident: bool):
    """ops.resident_layer_step (resident) or ops.fused_layer_step against its
    plain version, with the flagship's layer-0 weights: the main shape at a
    mid-decode step and a ragged shape (7 images, 35 rows) at the last
    step, and for the resident step the main shape at t = 0 and t = L - 1
    and 37 images (185 rows, which on the card leave the last cluster tile
    short: asserted) at a mid-decode step too; then times (a CUDA graph's,
    and launched from Python), the unfused eager ``DecoderLayer.step`` it
    replaces, and the bound."""
    from openviic_tpu_torch.ops.beam_select_attention import ancestor_rows
    from openviic_tpu_torch.ops.fused_decoder_step import (
        fused_layer_step, fused_layer_step_reference)
    from openviic_tpu_torch.ops.resident_layer_step import (
        resident_layer_step, resident_layer_step_reference)

    name = "resident_layer_step" if resident else "fused_layer_step"
    gen = torch.Generator().manual_seed(2 if resident else 3)
    weights = layer.fused_weights(torch.bfloat16)
    beam, L, M, D, h = s["beam"], s["max_len"], s["n_regions"], s["d_model"], s["heads"]
    F = weights["w1"].shape[1]
    worst, timed_case = 0.0, None
    shapes = [(s["batch"], L // 2), (7, L - 1), (s["batch"], 0), (s["batch"], L - 1),
              (37, L // 2)]
    for img, t in shapes:
        c = step_case(gen, img, s, t, device)
        N = img * beam
        if resident:
            args = (c["x"][:, None], c["k"], c["v"], c["ck"], c["cv"], c["anc"],
                    c["smask"].reshape(N, 1, 1, L), c["cmask"].reshape(img, 1, 1, M), c["is_pad"])
            got = resident_layer_step(*args, t, weights, h)
            want = resident_layer_step_reference(*args, t, weights, h)
            sync(device)
            y_err, y_ulps, y_share = ulp_errors(got[0], want[0], floor=1.0)
            kv = [ulp_errors(g, w) for g, w in zip(got[1:], want[1:])]
            ok = (torch.isfinite(got[0]).all() and y_ulps <= RESIDENT_Y_ULPS
                  and y_share <= RESIDENT_Y_SHARE and all(u <= 1 for _, u, _ in kv))
            detail = (f"y {y_ulps:.2f} ulps of max(|y|, 1) (max |err| {y_err:.3g}, "
                      f"{y_share:.2e} beyond 1 ulp); k_new/v_new "
                      f"{max(u for _, u, _ in kv):.2f} ulps")
            err = max(y_err, *(e for e, _, _ in kv))
        else:
            rows = lambda a: a.reshape(img, M, D).repeat_interleave(beam, dim=0)  # noqa: E731
            k0, v0 = c["k"].reshape(N, L, D), c["v"].reshape(N, L, D)
            ins = (c["x"], rows(c["ck"]), rows(c["cv"]), c["smask"],
                   c["cmask"].repeat_interleave(beam, dim=0))
            kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
            y = fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)[0]
            y_ref = fused_layer_step_reference(ins[0], kp, vp, *ins[1:], t, weights, h)[0]
            sync(device)
            others = torch.arange(L, device=device) != t
            untouched = bool(torch.equal(kk[:, others], k0[:, others])
                             and torch.equal(vk[:, others], v0[:, others]))
            errs = [ulp_errors(y, y_ref), ulp_errors(kk[:, t], kp[:, t]),
                    ulp_errors(vk[:, t], vp[:, t])]
            ok = torch.isfinite(y).all() and untouched and all(u <= 1 for _, u, _ in errs)
            detail = (f"y {errs[0][1]:.2f} ulps (max |err| {errs[0][0]:.3g}), cache row t "
                      f"{max(errs[1][1], errs[2][1]):.2f} ulps, other rows "
                      f"{'bit-unchanged' if untouched else 'CHANGED'}")
            err = max(e for e, _, _ in errs)
            args = (ins, k0, v0)
        if not ok:
            raise AssertionError(f"{name} N={N} t={t}: {detail}")
        if img == 37 and device.type == "cuda":
            from openviic_tpu_torch.ops.layer_step import occupancy

            tile = occupancy(resident, N, D, F, L, M, h)["rows_per_tile"]
            if N % tile == 0:
                raise AssertionError(f"{name} N={N}: tiles of {tile} rows leave "
                                     f"no short tile; pick another row count")
            detail += f"; tiles of {tile} rows, the last of {N % tile}"
        worst = max(worst, err)
        log(f"  {name} N={N} L={L} M={M} D={D} F={F} t={t}: {detail}")
        if timed_case is None:
            timed_case = (c, args, img, t)
    if device.type != "cuda":
        return None

    c, args, img, t = timed_case
    N = img * beam
    if resident:
        kernel = lambda: resident_layer_step(*args, t, weights, h)  # noqa: E731
        plain = lambda: resident_layer_step_reference(*args, t, weights, h)  # noqa: E731
        cache = {"self": {"k": c["k"].clone(), "v": c["v"].clone()},
                 "cross": {"k": c["ck"], "v": c["cv"]}}
        eager = lambda: layer.step(  # noqa: E731
            c["x"][:, None], cache, t, args[6], args[7], ancestry=c["anc"],
            beam_select=beam, mask_axis="p")
    else:
        ins, k0, v0 = args
        kk, vk = k0.clone(), v0.clone()
        kernel = lambda: fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)  # noqa: E731
        plain = lambda: fused_layer_step_reference(  # noqa: E731
            ins[0], kk, vk, *ins[1:], t, weights, h)
        cache = {"self": {"k": k0.clone().reshape(N, L, h, D // h),
                          "v": v0.clone().reshape(N, L, h, D // h)},
                 "cross": {"k": ins[1].reshape(N, M, h, D // h),
                           "v": ins[2].reshape(N, M, h, D // h)}}
        eager = lambda: layer.step(  # noqa: E731
            c["x"][:, None], cache, t, ins[3].reshape(N, 1, 1, L), ins[4].reshape(N, 1, 1, M))
    ms = time_cuda(kernel, 20, graph=True)
    plain_ms = time_cuda(plain, 5, graph=True)
    eager_ms = time_cuda(eager, 20)
    costs = host_costs(kernel, 20)
    # how far the kernel's numerics sit from the eager bf16 step it replaces
    # (informational: the eager step rounds every intermediate to bf16)
    y_kernel, y_eager = kernel()[0].reshape(N, D), eager().reshape(N, D)
    keep = ~c["is_pad"][:, 0] if resident else torch.ones(N, dtype=torch.bool, device=device)
    e_err, e_ulps, e_share = ulp_errors(y_kernel[keep], y_eager[keep], floor=1.0)
    log(f"  {name} against the eager DecoderLayer.step: max |dy| {e_err:.3g} = {e_ulps:.1f} "
        f"ulps of max(|y|, 1), {e_share:.3f} of the elements beyond 1 ulp")

    # the bound: what this step's inputs need
    pos = torch.arange(L, device=device)
    weight_bytes = sum(w.numel() for w in weights.values()) * 2
    gemm_flops = 2.0 * N * D * (6 * D + 2 * F)
    if resident:
        src = ancestor_rows(c["anc"])
        live = ~(c["smask"][src, pos] | (pos == t))
        self_rows = distinct_rows(src * L + pos, live)
        cross_rows = int((~c["cmask"]).sum())  # image granularity
        live_cross = int((~c["cmask"]).sum(dim=1).repeat_interleave(beam).sum())
        nbytes = ((self_rows + cross_rows) * D * 2 * 2 + weight_bytes + 4 * N * D * 2
                  + N * L * (8 + 1) + img * M + N)
        flops = gemm_flops + 4.0 * (int(live.sum()) + N + live_cross) * D
    else:
        live = ~c["smask"] & (pos != t)
        live_cross = int((~ins[4]).sum())  # one copy per row
        nbytes = ((int(live.sum()) + live_cross) * D * 2 * 2 + weight_bytes + 2 * N * D * 2
                  + 2 * N * D * 2 + N * (L + M))
        # f32 products go to the tensor cores as three bf16 terms each
        flops = 3 * gemm_flops + 4.0 * (int(live.sum()) + N + live_cross) * D
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    log(f"  {name} at N={N} t={t}: kernel {ms:.4f} ms (launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, eager DecoderLayer.step {eager_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    replaces = ("openviic_tpu/ops/resident_layer_step.py:201" if resident
                else "openviic_tpu/ops/fused_decoder_step.py:190")
    return entry(name, "openviic_tpu_torch/csrc/layer_step.cu", replaces, worst, ms, plain_ms,
                 bound_ms, bound_by, None, eager_ms=eager_ms, **costs)


# ---------------------------------------------------------------- phase 6
def counted_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from openviic_tpu_torch.ops.beam_select_attention import beam_select_attention
    from openviic_tpu_torch.ops.fused_attention import fused_attention
    from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step
    from openviic_tpu_torch.ops.geo_attention import geo_fused_attention
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step

    return (head_topk, beam_select_attention, resident_layer_step, fused_layer_step,
            fused_attention, geo_fused_attention)


@contextlib.contextmanager
def env_flag(name: str, value: str = "1"):
    """Set one of the port's environment flags for the block."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def searcher_decode(pipe, searcher, vocab, beam):
    """decode(request) -> (captions, ids, best-beam total log-probs)."""
    def decode(request):
        outputs, log_probs = searcher(pipe._batch(request), beam)
        ids = outputs[: len(request)].cpu().numpy()
        totals = log_probs[: len(request)].sum(-1).cpu().numpy()
        return vocab.decode_caption(ids), ids, totals
    return decode


def drive(name, device, s, vocab, requests, searcher, decode, card, per_step=None,
          per_request=None):
    """Warm up (on the card), zero every count, run the requests, read the
    counts.  ``per_step`` and ``per_request`` map kernel names to their
    launches per decode step and per request; every other kernel must not
    launch.  Returns (results, launches by name)."""
    cuda = device.type == "cuda"
    counted = counted_wrappers()
    if cuda:
        decode(requests[2])
        sync(device)
    for fn in counted:
        fn.launches = 0
    steps0 = searcher.steps
    results, seconds = run_requests(device, requests, decode)
    steps = searcher.steps - steps0
    launches = {fn.__name__: fn.launches for fn in counted}
    per_step, per_request = per_step or {}, per_request or {}
    want = {fn.__name__: (per_step.get(fn.__name__, 0) * steps
                          + per_request.get(fn.__name__, 0) * len(requests) if cuda else 0)
            for fn in counted}
    if steps <= 0 or launches != want:
        raise AssertionError(f"{name}: launches {launches} over {steps} decode steps and "
                             f"{len(requests)} requests, expected {want}")
    check_outputs(name, s, vocab, requests, results)
    log(f"  {name}: {[round(t, 4) for t in seconds]} s per request, "
        f"{throughput(s, seconds):.1f} captions/s on {card}; {steps} steps, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return results, launches


def rescore(device, requests, decode, results, name):
    """Best-beam total log-probs of a run whose decode returned none:
    decoded again (uncounted), and the ids must come out the same."""
    rescored = run_requests(device, requests, decode)[0]
    for (_, ids, *_), (_, again, _) in zip(results, rescored):
        if not np.array_equal(ids, again):
            raise AssertionError(f"{name}: a second decode of the same batch differs")
    return rescored


def score_parity(name, results, ref, ref_name):
    """Print caption agreement and gate the mean best-beam log-prob within
    SCORE_RTOL of the reference path's."""
    same = agreement(results, ref)
    got = np.concatenate([r[2] for r in results])
    want = np.concatenate([r[2] for r in ref])
    gap = np.abs(got - want)
    rel = abs(got.mean() - want.mean()) / abs(want.mean())
    log(f"  {name} against {ref_name}: captions identical {same:.4f}; mean best-beam "
        f"log-prob {got.mean():.4f} against {want.mean():.4f} (relative {rel:.2e}); "
        f"|difference| <= 0.5 on {np.mean(gap <= 0.5):.4f} of the images")
    if rel > SCORE_RTOL:
        raise AssertionError(f"{name}: mean best-beam log-prob differs by {rel:.2e} > "
                             f"{SCORE_RTOL} from {ref_name}")
    return same


def decode_paths_phase(device, s, served, card: str):
    """Three more decode paths of the flagship at the serve shape, over the
    same three requests: (a) CaptioningPipeline with DECODE_ATTN_KERNEL and
    the head kernel; (b) resident_kernel with the head kernel; (c) the
    non-resident path with OPENVIIC_FUSED_STEP=1, and without it.  Each
    path's launches per decode step are asserted, its ids must lie in the
    vocab, and the mean best-beam log-prob of its captions must be within
    SCORE_RTOL of its reference path's; caption agreement is printed beside
    that of two eager paths (non-resident against beam-resident), since
    with random weights at bf16 near-equal beams make captions flip under
    any change of rounding.  Returns each step kernel's launches on its
    path, and the reference paths' results."""
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.serving import CaptioningPipeline

    vocab, requests, pipe = (served[k] for k in ("vocab", "requests", "pipe"))
    n_layers = len(pipe.model.decoder.layers)
    beam = s["beam"]

    def run(name, searcher, decode, **expect):
        return drive(name, device, s, vocab, requests, searcher, decode, card, **expect)

    out = {}
    base = rescore(device, requests, searcher_decode(pipe, pipe.searcher, vocab, beam),
                   served["results"], "serve")

    attn_pipe = CaptioningPipeline(model_config(s, attn_kernel=True), vocab,
                                   batch_size=s["batch"], device=device, seed=0)
    res_a, launches = run(
        "(a) DECODE_ATTN_KERNEL + head kernel", attn_pipe.searcher,
        lambda request: attn_pipe.caption_features(request, return_ids=True),
        per_step={"beam_select_attention": n_layers, "head_topk": 1})
    out["beam_select_attention"] = launches["beam_select_attention"]
    out["beam_select_captured"] = captured_beam_select(device, s, attn_pipe, requests[0],
                                                       s["max_len"] // 2)
    res_a = rescore(device, requests, searcher_decode(attn_pipe, attn_pipe.searcher, vocab, beam),
                    res_a, "(a)")
    score_parity("(a)", res_a, base, "the head-kernel path")

    resident = BeamSearcher(pipe.model, torch.bfloat16, head_kernel=1, resident_kernel=True)
    res_b, launches = run("(b) resident_kernel + head kernel", resident,
                          searcher_decode(pipe, resident, vocab, beam),
                          per_step={"resident_layer_step": n_layers, "head_topk": 1})
    out["resident_layer_step"] = launches["resident_layer_step"]
    score_parity("(b)", res_b, base, "the head-kernel path")

    with env_flag("OPENVIIC_FUSED_STEP"):
        fused = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
        res_c, launches = run("(c) non-resident, OPENVIIC_FUSED_STEP=1", fused,
                              searcher_decode(pipe, fused, vocab, beam),
                              per_step={"fused_layer_step": n_layers})
    out["fused_layer_step"] = launches["fused_layer_step"]
    plain = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
    res_nr, _ = run("(c) non-resident, no step kernel", plain,
                    searcher_decode(pipe, plain, vocab, beam))
    score_parity("(c)", res_c, res_nr, "the non-resident path without the flag")
    score_parity("non-resident (eager)", res_nr, base, "the beam-resident head-kernel path")
    out["refs"] = {"base": base, "non_resident": res_nr}
    return out


# ---------------------------------------------------------------- phase 7
@torch.no_grad()
def forced_scores(model, batch, ids, vocab, resident: bool, **flags):
    """Per-step log-probs of the tokens ``ids`` (one full batch of images,
    max_len) fed back one step at a time, beam 1, through
    ``model.decode_step``, beam-resident or not."""
    from openviic_tpu_torch.models.base import make_decode_cache

    L = vocab.max_caption_length
    tokens = torch.cat([torch.full_like(ids[:, :1], vocab.bos_idx), ids[:, :-1]], dim=1)
    memory, mask = model.encoder_forward(batch)
    b_s = memory.shape[0]
    cache = make_decode_cache(model.config.DECODER, vocab, b_s, dtype=torch.bfloat16,
                              device=ids.device)
    cache = model.prepare_cache(cache, memory)
    ancestry = torch.zeros((b_s, 1, L), dtype=torch.long, device=ids.device) if resident else None
    per_step = []
    for t in range(L):
        log_probs, cache = model.decode_step(
            t, tokens[:, t : t + 1], cache, mask, ancestry=ancestry,
            beam_select=1 if resident else None, **flags)
        per_step.append(torch.gather(log_probs, 1, ids[:, t : t + 1])[:, 0])
    return torch.stack(per_step, dim=1)


def check_forced(name, ids, vocab, got, want, gate=True):
    """Per-step |d log-prob| of the forced tokens (steps up to the first
    <eos>): at least FORCED_SHARE of them within FORCED_ATOL."""
    is_eos = (ids == vocab.eos_idx).long()
    scored = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
    diff = (got - want).abs()[scored]
    share = (diff <= FORCED_ATOL).float().mean().item()
    totals = ((got - want) * scored).sum(dim=1).abs()
    log(f"  {name}: per-step |d log-prob| max {diff.max().item():.4g}, mean "
        f"{diff.mean().item():.3g}, within {FORCED_ATOL} on {share:.4f} of "
        f"{diff.numel()} steps; per-caption |d total| mean {totals.mean().item():.3g}, "
        f"max {totals.max().item():.3g}")
    if gate and share < FORCED_SHARE:
        raise AssertionError(f"{name}: {share:.4f} of the forced steps within "
                             f"{FORCED_ATOL} < {FORCED_SHARE}")


def forced_phase(device, s, served):
    """The step kernels inside a whole decode with the tokens forced: the
    serve phase's captions of the first request are fed back one step at a
    time (beam 1) through the eager step and through each kernel path, and
    each step's log-prob of the forced token must agree with the eager
    path's within FORCED_ATOL on at least FORCED_SHARE of the scored
    (image, step) pairs (steps up to the first <eos>).  Unlike caption
    agreement, a rounding difference cannot turn into another caption."""
    pipe, vocab, model = served["pipe"], served["vocab"], served["pipe"].model
    ids = torch.from_numpy(served["results"][0][1]).to(device)
    batch = pipe._batch(served["requests"][0])

    def score(resident, **flags):
        return forced_scores(model, batch, ids, vocab, resident, **flags)

    def check(name, got, want):
        check_forced(name, ids, vocab, got, want)

    eager = score(True)
    check("(a) attention kernel against the eager step", score(True, attn_kernel=True), eager)
    check("(b) resident kernel against the eager step", score(True, resident_kernel=True), eager)
    eager_nr = score(False)
    with env_flag("OPENVIIC_FUSED_STEP"):
        fused = score(False)
    check("(c) fused step against the eager non-resident step", fused, eager_nr)
    check("eager non-resident against eager beam-resident", eager_nr, eager)
    return {"eager": eager, "eager_nr": eager_nr}


# ---------------------------------------------------------------- phase 9
def ort_config(s, trig: bool):
    """The Object Relation Transformer of ``configs/object_relation_transformer.yaml``
    at the widths of ``s`` (3+3 layers, d_model 512, 8 heads, d_ff 2048,
    1024-d features at full width), the yaml's beam 3, with
    ``ENCODER.TRIGNOMETRIC_EMBEDDING`` set to ``trig`` (the yaml has it
    false; true is the ORT paper's dim_g = 64, wave_len 1000)."""
    config = model_config(s)
    model = config.MODEL.to_dict()
    model["ARCHITECTURE"] = "ObjectRelationTransformer"
    model["ENCODER"]["ARCHITECTURE"] = "GeometricEncoder"
    model["ENCODER"]["TRIGNOMETRIC_EMBEDDING"] = trig
    model["ENCODER"]["SELF_ATTENTION"]["ARCHITECTURE"] = "AugmentedGeometryScaledDotProductAttention"
    training = dict(config.TRAINING.to_dict(), EVALUATING_BEAM_SIZE=s["ort_beam"])
    from openviic_tpu_torch.config import ConfigNode

    return ConfigNode({"MODEL": model, "TRAINING": training})


def attention_paths_phase(device, s, served, paths, card: str):
    """The decode paths of the two attention kernels at the serve shape:
    (d) OPENVIIC_PALLAS=1 on the served beam-resident flagship (the encoder:
    one fused_attention per encoder layer and request); (e) the same with
    beam_resident=False (also one per decoder self- and cross-attention per
    step); (f) the ORT with the trig embedding off, with and without
    OPENVIIC_PALLAS=1 (its (B, h, n, n) geometric bias through the kernel);
    (g) the ORT with the trig embedding on, with and without
    OPENVIIC_GEO_FUSED=1 (one geo_fused_attention per encoder layer and
    request).  Each asserts its launches, valid ids and score parity with
    its flag-off twin, and prints captions/s and caption agreement; (d),
    (e) and (g) then pass the forced decode against their twins.  Returns
    each kernel's launches on its path."""
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.serving import CaptioningPipeline

    vocab, requests, pipe = (served[k] for k in ("vocab", "requests", "pipe"))
    n_enc = len(pipe.model.encoder.layers)
    n_dec = len(pipe.model.decoder.layers)
    beam = s["beam"]
    refs = paths["refs"]
    out = {}

    def run(name, searcher, decode, reqs=requests, **expect):
        return drive(name, device, s, vocab, reqs, searcher, decode, card, **expect)

    with env_flag("OPENVIIC_PALLAS"):
        res_d, launches = run("(d) OPENVIIC_PALLAS=1, served path", pipe.searcher,
                              lambda request: pipe.caption_features(request, return_ids=True),
                              per_step={"head_topk": 1}, per_request={"fused_attention": n_enc})
        out["fused_attention"] = launches["fused_attention"]
        res_d = rescore(device, requests, searcher_decode(pipe, pipe.searcher, vocab, beam),
                        res_d, "(d)")
        non_resident = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
        res_e, _ = run("(e) OPENVIIC_PALLAS=1, beam_resident=False", non_resident,
                       searcher_decode(pipe, non_resident, vocab, beam),
                       per_step={"fused_attention": 2 * n_dec},
                       per_request={"fused_attention": n_enc})
    score_parity("(d)", res_d, refs["base"], "the served path without the flag")
    score_parity("(e)", res_e, refs["non_resident"], "the non-resident path without the flag")

    # the ORT: the same images, with boxes in pixels (all 50 regions live;
    # the pipeline pads features and boxes to 56 rows of zeros)
    gen = torch.Generator().manual_seed(8)
    boxes = pixel_boxes(gen, sum(len(r) for r in requests), s["n_regions"],
                        torch.full((sum(len(r) for r in requests),), s["n_regions"])).numpy()
    flat = [dict(image, region_boxes=b) for r in requests for image, b in zip(r, boxes)]
    sizes = np.cumsum([0] + [len(r) for r in requests])
    ort_requests = [flat[a:b] for a, b in zip(sizes[:-1], sizes[1:])]
    ort_forced = {}
    for trig, flag, kernel in ((False, "OPENVIIC_PALLAS", "fused_attention"),
                               (True, "OPENVIIC_GEO_FUSED", "geo_fused_attention")):
        tag = "(g) ORT trig-on" if trig else "(f) ORT trig-off"
        ort = CaptioningPipeline(ort_config(s, trig), vocab, batch_size=s["batch"], head_kernel=1,
                                 device=device, seed=1)
        beam_o = ort.beam_size
        decode = searcher_decode(ort, ort.searcher, vocab, beam_o)
        res_off, _ = run(f"{tag}, no flag", ort.searcher, decode, reqs=ort_requests,
                         per_step={"head_topk": 1})
        with env_flag(flag):
            res_on, launches = run(f"{tag}, {flag}=1", ort.searcher, decode, reqs=ort_requests,
                                   per_step={"head_topk": 1}, per_request={kernel: n_enc})
        if trig:
            out["geo_fused_attention"] = launches["geo_fused_attention"]
        score_parity(tag, res_on, res_off, "its path without the flag")
        if trig:
            ort_forced = dict(pipe=ort, ids=res_off[0][1], request=ort_requests[0], flag=flag)

    # forced decodes of (d), (e) and (g) against their flag-off twins
    ids = torch.from_numpy(served["results"][0][1]).to(device)
    batch = pipe._batch(requests[0])
    eager, eager_nr = paths["forced"]["eager"], paths["forced"]["eager_nr"]
    with env_flag("OPENVIIC_PALLAS"):
        check_forced("(d) OPENVIIC_PALLAS=1 against the served eager step", ids, vocab,
                     forced_scores(pipe.model, batch, ids, vocab, True), eager)
        check_forced("(e) OPENVIIC_PALLAS=1 against the eager non-resident step", ids, vocab,
                     forced_scores(pipe.model, batch, ids, vocab, False), eager_nr)
    # (g) with the boxes as the pipeline gives them (f32), then in bf16, as
    # the beam search casts every floating input (the JAX package's rule):
    # there the eager path computes its log displacements in bf16, so the
    # trig embedding's 100-rad-per-unit frequencies carry errors of order
    # 1 rad that the kernel's f32 displacements do not, in the JAX package
    # as here (tests/test_torch_port_ort.py, ROADMAP.md section C).  The
    # bf16 case is gated on the card, at the served width; at the CPU
    # rehearsal's two heads and random weights that gap alone exceeds
    # FORCED_ATOL (as JAX's own does in the test), so there it is printed
    ort = ort_forced["pipe"]
    ids_g = torch.from_numpy(ort_forced["ids"]).to(device)
    batch_g = ort._batch(ort_forced["request"])
    batch_bf16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in batch_g.items()}
    for boxes, batch_x in (("f32", batch_g), ("bf16", batch_bf16)):
        off = forced_scores(ort.model, batch_x, ids_g, vocab, True)
        with env_flag(ort_forced["flag"]):
            on = forced_scores(ort.model, batch_x, ids_g, vocab, True)
        check_forced(f"(g) OPENVIIC_GEO_FUSED=1 against the ORT eager encoder, {boxes} boxes",
                     ids_g, vocab, on, off, gate=boxes == "f32" or device.type == "cuda")
    return out


# ---------------------------------------------------------------- phase 8
FUSED_ATOL = 2e-5  # the JAX test's bar (tests/test_pallas_attention.py)
GEO_ULPS, GEO_SHARE, GEO_ATOL = 2, 0.99, 0.05


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """The -1e30 additive form of a True = masked mask, as ``_attend`` makes it."""
    return torch.zeros(mask.shape, device=mask.device).masked_fill(mask, -1e30)


def fused_attention_cases(gen, s, device):
    """(name, q, k, v, bias) at the shapes the decode paths give the kernel:
    the encoder (images x regions padded to a multiple of 8, mask bias), the
    non-resident step's self- (nq = 1, nk = max_len, position mask; q/k/v
    strided slices of one fused projection, as ``project_qkv_fused`` gives
    them) and cross-attention (nk = regions), the ORT trig-off encoder's full
    (B, h, n, n) bias, a ragged f32 shape (7 images, nk = 13) with one fully
    masked row; then the tiles' edges: nq = 1 at nk = 1, nk = 200 (past
    64-key tiles) and nk = 300 (past the decode tile's 256 kept scores),
    nq = 65 (past a 64-query tile), and bf16 q/k/v sliced 2 bytes off
    16-byte alignment with odd strides (the kernel loads them element by
    element) at the encoder's and the step's nq."""
    img, beam, L, h, D = s["batch"], s["beam"], s["max_len"], s["heads"], s["d_model"]
    d, n = D // h, -(-s["n_regions"] // 8) * 8
    N = img * beam

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(device, dtype)

    def unaligned(B, m):  # (B, m, h, d) bf16 views 2 bytes past 16-byte alignment
        return randn(B, m, h * d + 1)[..., 1:].view(B, m, h, d)

    def random_mask(B, nq, nk, p=0.2):
        mask = torch.rand((B, 1, nq, nk), generator=gen) < p
        mask[..., 0] = False
        return mask_bias(mask).to(device)

    live = torch.randint(n // 2, s["n_regions"] + 1, (img,), generator=gen)
    enc_mask = (torch.arange(n)[None] >= live[:, None]).reshape(img, 1, 1, n)
    q_s = randn(N, 1, 3 * D)[..., :D].reshape(N, 1, h, d)  # strided, as sliced from q|k|v
    t = L // 2
    pos_mask = (torch.rand((N, L), generator=gen) < 0.1) | (torch.arange(L) > t)[None]
    pos_mask[:, 0] = False
    cross_live = live.repeat_interleave(beam)
    cross_mask = (torch.arange(n)[None] >= cross_live[:, None]).reshape(N, 1, 1, n)
    geo_bias = torch.log(torch.clamp_min(torch.relu(torch.randn((img, h, n, n), generator=gen)),
                                         1e-6)) + mask_bias(enc_mask.expand(img, h, n, n))
    ragged_mask = torch.rand((7, 1, 1, 13), generator=gen) < 0.3
    ragged_mask[..., 0] = False
    ragged_mask[3] = True  # every key of image 3: its rows are uniform
    few = 16  # images of the edge cases
    return [
        ("encoder", randn(img, n, h, d), randn(img, n, h, d), randn(img, n, h, d),
         mask_bias(enc_mask).to(device)),
        ("step self", q_s, randn(N, L, h, d), randn(N, L, h, d),
         mask_bias(pos_mask.reshape(N, 1, 1, L)).to(device)),
        ("step cross", q_s, randn(N, n, h, d), randn(N, n, h, d),
         mask_bias(cross_mask).to(device)),
        ("ORT trig-off bias", randn(img, n, h, d), randn(img, n, h, d), randn(img, n, h, d),
         geo_bias.to(device)),
        ("ragged f32", randn(7, 13, h, d, dtype=torch.float32),
         randn(7, 13, h, d, dtype=torch.float32), randn(7, 13, h, d, dtype=torch.float32),
         mask_bias(ragged_mask).to(device)),
        ("nq 1, nk 1", randn(few, 1, h, d), randn(few, 1, h, d), randn(few, 1, h, d), None),
        ("nq 1, nk 200", randn(few, 1, h, d), randn(few, 200, h, d), randn(few, 200, h, d),
         random_mask(few, 1, 200)),
        ("nq 1, nk 300", randn(few, 1, h, d), randn(few, 300, h, d), randn(few, 300, h, d),
         random_mask(few, 1, 300)),
        ("nq 65, nk 200", randn(few, 65, h, d), randn(few, 200, h, d), randn(few, 200, h, d),
         random_mask(few, 65, 200)),
        ("unaligned bf16 encoder", unaligned(few, n), unaligned(few, n), unaligned(few, n),
         random_mask(few, 1, n)),
        ("unaligned bf16 step", unaligned(few, 1), unaligned(few, L), unaligned(few, L),
         random_mask(few, 1, L)),
    ]


CROSSOVER_NQ = (1, 2, 4, 8, 16, 32)


def attention_bound(q, k, v, bias):
    """fused_attention's bound on these inputs, counting the work their
    masks leave: q read once (its live columns only); the K and V rows of
    the keys that some query of their (batch, head) can see (a bias above
    -5e29), with every key of a fully masked row (its output is the mean of
    V); the f32 bias as given and the f32 output; q.k of bf16 operands at
    the tensor-core peak, p.v (an f32 operand) at the f32 peak and one
    exponent, each over the (query, key) pairs so counted."""
    B, nq, h, d = q.shape
    nk, dv = k.shape[1], v.shape[3]
    if bias is None:
        seen = torch.ones((B, h, nq, nk), dtype=torch.bool, device=q.device)
    else:
        seen = (bias > -5e29).expand(B, h, nq, nk)
    seen = seen | ~seen.any(dim=-1, keepdim=True)
    pairs, keys = int(seen.sum()), int(seen.any(dim=2).sum())
    nbytes = ((q[..., 0].numel() * d + keys * (d + dv)) * q.element_size()
              + (0 if bias is None else bias.numel() * 4) + B * nq * h * dv * 4)
    qk_flops, pv_flops = 2.0 * pairs * d, 2.0 * pairs * dv
    return unit_bound(nbytes, bf16_flops=qk_flops, f32_flops=pv_flops, sfu_ops=pairs) + (
        qk_flops, nbytes, keys / (B * h * nk))


def fused_attention_phase(device, s):
    """ops.fused_attention against its plain version at every case of
    ``fused_attention_cases`` (within FUSED_ATOL; the fully masked rows
    finite and uniform; the edge cases also through the tile that their nq
    does not choose), then its time at the encoder and the two step shapes
    beside its bound, the plain version's and SDPA's on f32 copies with the
    same float mask, and the DECODE/MMA crossover over nq."""
    from openviic_tpu_torch.ops import fused_attention as fa

    fused_attention, fused_attention_reference = fa.fused_attention, fa.fused_attention_reference
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    cases = fused_attention_cases(gen, s, device)
    forced = {"nq 1, nk 200": fa.MMA, "nq 1, nk 300": fa.MMA, "nq 65, nk 200": fa.DECODE,
              "unaligned bf16 encoder": fa.DECODE, "unaligned bf16 step": fa.MMA}
    for name, q, k, v, bias in cases:
        tiles = [None] + ([forced[name]] if name in forced else [])
        want = fused_attention_reference(q, k, v, bias)
        for tile in tiles:
            got = fused_attention(q, k, v, bias, tile=tile)
            sync(device)
            err = (got - want).abs().max().item()
            if (got.dtype != torch.float32 or got.shape != want.shape
                    or not torch.isfinite(got).all()):
                raise AssertionError(f"fused_attention {name}: {got.dtype} {tuple(got.shape)}, "
                                     f"finite {bool(torch.isfinite(got).all())}")
            if err > FUSED_ATOL:
                raise AssertionError(f"fused_attention {name}: max |err| {err:.3g} > {FUSED_ATOL}")
            detail = ""
            if name == "ragged f32":
                uniform = v[3].float().mean(dim=0, keepdim=True).expand_as(got[3])
                u_err = (got[3] - uniform).abs().max().item()
                if u_err > FUSED_ATOL:
                    raise AssertionError(f"fused_attention: a fully masked row is not uniform "
                                         f"(max |err| {u_err:.3g} against the mean of v)")
                detail = f"; fully masked rows finite and uniform (max |err| {u_err:.3g})"
            worst = max(worst, err)
            used = fa.resolve_tile(q.shape[1], q.dtype, tile)
            log(f"  fused_attention {name} ({fa.TILE_NAMES[used]} tile): q {tuple(q.shape)} "
                f"{str(q.dtype)[6:]}, nk {k.shape[1]}, bias "
                f"{None if bias is None else tuple(bias.shape)}: max |err| {err:.3g}{detail}")
    if device.type != "cuda":
        return None

    rows = {}
    for name, q, k, v, bias in cases[:3]:
        qf, kf, vf = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))

        def library():  # SDPA in f32 with the same float mask; timed here only
            return torch.nn.functional.scaled_dot_product_attention(qf, kf, vf, attn_mask=bias)

        ms = time_cuda(lambda: fused_attention(q, k, v, bias), 50, graph=True)
        plain_ms = time_cuda(lambda: fused_attention_reference(q, k, v, bias), 10, graph=True)
        library_ms = time_cuda(library, 50, graph=True)
        costs = host_costs(lambda: fused_attention(q, k, v, bias), 50)
        lib_err = (library().transpose(1, 2) - fused_attention(q, k, v, bias)).abs().max().item()
        bound_ms, bound_by, times, flops, nbytes, seen = attention_bound(q, k, v, bias)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, **costs)
        log(f"  fused_attention at the {name} shape {tuple(q.shape)}, nk {k.shape[1]} "
            f"({fa.TILE_NAMES[fa.choose_tile(q.shape[1], q.dtype)]} tile): kernel {ms:.4f} ms "
            f"(launched from Python: {costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} "
            f"ms per call), plain {plain_ms:.4f} ms, SDPA f32 {library_ms:.4f} ms (max |diff| "
            f"{lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}; {bound_detail(times)}; "
            f"{flops / 1e9:.3f} GFLOP q.k, {nbytes / 1e6:.2f} MB with {seen:.3f} of the keys "
            f"seen)")

    # the DECODE/MMA crossover: the encoder's images, heads and keys, nq queries
    _, q, k, v, bias = cases[0]
    cells, crossover = [], None
    for nq in CROSSOVER_NQ:
        qn = q[:, :1].expand(-1, nq, -1, -1).contiguous()
        t_dec = time_cuda(lambda: fused_attention(qn, k, v, bias, tile=fa.DECODE), 20, graph=True)
        t_mma = time_cuda(lambda: fused_attention(qn, k, v, bias, tile=fa.MMA), 20, graph=True)
        cells.append(f"nq {nq}: decode {t_dec:.4f} / mma {t_mma:.4f} ms")
        if t_dec <= t_mma:
            crossover = nq
    log(f"  fused_attention tiles over nq at {tuple(k.shape)} keys: {'; '.join(cells)}; decode "
        f"wins up to nq {crossover}; the port's DECODE_MAX_NQ is {fa.DECODE_MAX_NQ}")

    enc = rows["encoder"]
    return entry("fused_attention", "openviic_tpu_torch/csrc/fused_attention.cu",
                 "openviic_tpu/ops/pallas_attention.py:164", worst, enc["ms"],
                 enc["plain_ms"], enc["bound_ms"], enc["bound_by"], enc["library_ms"],
                 launch_ms=enc["launch_ms"], host_ms=enc["host_ms"],
                 step_self=rows["step self"], step_cross=rows["step cross"])


def pixel_boxes(gen, bs, n, live):
    """(bs, n, 4) f32 boxes in pixels of a 640 x 480 image, zero past each
    image's ``live`` regions (as the pipeline pads them)."""
    x0 = torch.rand((bs, n), generator=gen) * 600
    y0 = torch.rand((bs, n), generator=gen) * 440
    w = 8 + torch.rand((bs, n), generator=gen) * (640 - x0 - 8)
    hh = 8 + torch.rand((bs, n), generator=gen) * (480 - y0 - 8)
    boxes = torch.stack([x0, y0, x0 + w, y0 + hh], dim=-1)
    return boxes * (torch.arange(n)[None] < live[:, None])[..., None]


def geo_attention_phase(device, s):
    """ops.geo_fused_attention against its plain version at the ORT encoder
    shape (images x regions padded to 8, the trig embedding's dim_g =
    d_model / heads), a ragged shape (7 images, n = 13, f32), n 16 rows
    longer than the encoder's (the MMA kernel past 64 rows: its 8-warp,
    128-key instance, one slab per phase), the encoder shape with bf16
    boxes (the kernel's own bf16 geometry rows) and n = 160 (the SIMT
    kernel): within
    GEO_ULPS bf16 ulps on GEO_SHARE of the elements and GEO_ATOL
    everywhere; then its time beside its bound, the plain version's and the
    composite of box_relational_embedding + fc_gs + SDPA with the
    materialised bias."""
    from openviic_tpu_torch.models.geometry import box_relational_embedding
    from openviic_tpu_torch.ops.geo_attention import (
        geo_fused_attention, geo_fused_attention_reference, kernel_route)

    gen = torch.Generator().manual_seed(5)
    h, D = s["heads"], s["d_model"]
    d, n = D // h, -(-s["n_regions"] // 8) * 8
    dim_g = d
    bound_g = (6.0 / (dim_g + 1)) ** 0.5  # _per_head_xavier
    worst, timed_case = 0.0, None
    for bs, nn_, dtype, box_dtype in ((s["batch"], n, torch.bfloat16, torch.float32),
                                      (7, 13, torch.float32, torch.float32),
                                      (40, n + 16, torch.bfloat16, torch.float32),
                                      (s["batch"], n, torch.bfloat16, torch.bfloat16),
                                      (20, 160, torch.bfloat16, torch.float32)):
        most = min(nn_, s["n_regions"])
        live = torch.randint(min(nn_ // 2, most), most + 1, (bs,), generator=gen)
        boxes = pixel_boxes(gen, bs, nn_, live).to(device, box_dtype)
        mask = (torch.arange(nn_)[None] >= live[:, None]).reshape(bs, 1, 1, nn_).to(device)
        q, k, v = (torch.randn((bs, nn_, h, d), generator=gen).to(device, dtype) for _ in range(3))
        wg = ((torch.rand((dim_g, h), generator=gen) * 2 - 1) * bound_g).to(device)
        bg = (0.1 * torch.randn((h,), generator=gen)).to(device)
        args = (q, k, v, boxes, wg, bg, mask, 1.0 / d ** 0.5)
        got = geo_fused_attention(*args)
        want = geo_fused_attention_reference(*args)
        sync(device)
        err, ulps, share = ulp_errors(got, want)
        beyond = float(((got.float() - want.float()).abs()
                        > GEO_ULPS * bf16_ulp(want.float().abs().clamp_min(ULP_FLOOR))).float().mean())
        if (got.dtype != q.dtype or not torch.isfinite(got).all() or err > GEO_ATOL
                or beyond > 1 - GEO_SHARE):
            raise AssertionError(f"geo_fused_attention bs={bs} n={nn_}: max |err| {err:.3g}, "
                                 f"{beyond:.4f} of the elements beyond {GEO_ULPS} bf16 ulps")
        worst = max(worst, err)
        route = (kernel_route(*(t.to(torch.bfloat16) for t in (q, k, v)), dim_g // 8)
                 if device.type == "cuda" else "plain")
        log(f"  geo_fused_attention bs={bs} n={nn_} h={h} dk={d} dim_g={dim_g} "
            f"{str(dtype)[6:]}, {str(box_dtype)[6:]} boxes (route {route}): max |err| "
            f"{err:.3g} = {ulps:.2f} bf16 ulps, {share:.2e} beyond 1 ulp, {beyond:.2e} beyond "
            f"{GEO_ULPS}")
        if timed_case is None:
            timed_case = args
    if device.type != "cuda":
        return None
    q, k, v, boxes, wg, bg, mask, scale = timed_case
    bs, n, h, d = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():  # the materialised path: embedding, fc_gs, SDPA with the bias
        emb = box_relational_embedding(boxes, dim_g=dim_g)
        wts = torch.relu(emb @ wg + bg).permute(0, 3, 1, 2)
        bias = torch.log(torch.clamp_min(wts, 1e-6)) + mask_bias(mask)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias.to(q.dtype), scale=scale)

    ms = time_cuda(lambda: geo_fused_attention(*timed_case), 20, graph=True)
    plain_ms = time_cuda(lambda: geo_fused_attention_reference(*timed_case), 3, graph=True)
    library_ms = time_cuda(library, 20, graph=True)
    costs = host_costs(lambda: geo_fused_attention(*timed_case), 20)
    pairs = bs * n * n
    mma = 2.0 * pairs * h * 2 * d  # q.k and p.v: bf16 operands, f32 accumulation
    fold = 2.0 * pairs * h * 2 * 4 * (dim_g // 8)  # the f32 fold of the sin/cos planes
    sincos = pairs * 2 * 4 * (dim_g // 8)
    sfu = sincos + pairs * (2 + 2 * h)  # and the displacements' logs, each bias's log and exp
    nbytes = 4 * bs * n * h * d * 2 + bs * n * (4 * 4 + 1)
    bound_ms, bound_by, times = unit_bound(nbytes, bf16_flops=mma, f32_flops=fold, sfu_ops=sfu)
    log(f"  geo_fused_attention at {tuple(q.shape)}: kernel {ms:.4f} ms (launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, embedding+fc_gs+SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; "
        f"{bound_detail(times)}; {mma / 1e9:.2f} GFLOP bf16 at 989 TFLOP/s, {fold / 1e9:.2f} "
        f"GFLOP f32 at 67 TFLOP/s, {sfu / 1e6:.1f} M transcendentals ({sincos / 1e6:.1f} M "
        f"sin/cos) at {PEAK_SFU_OPS / 1e12:.2f} T/s (16 per SM per clock, 132 SMs, 1.98 GHz), "
        f"{nbytes / 1e6:.2f} MB at 3.35 TB/s)")
    return entry("geo_fused_attention", "openviic_tpu_torch/csrc/geo_attention.cu",
                 "openviic_tpu/ops/geo_attention.py:134", worst, ms, plain_ms, bound_ms,
                 bound_by, library_ms, **costs)


def head_large_k_phase(device, s):
    """head_topk at k = 32 and k = 128 (the shared-memory lists) against its
    plain version at the decode rows (exact and gaussian inputs) and the
    first step's rows (gaussian), with the kernel's device time at each."""
    from openviic_tpu_torch.ops.head_topk import head_topk

    gen = torch.Generator().manual_seed(6)
    D, V = s["d_model"], s["vocab"]
    worst = 0.0
    for k in (32, 128):
        k = min(k, V - 1)
        for N in (s["batch"] * s["beam"], s["batch"]):
            if N > s["batch"]:
                compare(f"k={k}, exact inputs", *exact_inputs(gen, N, D, V, device), k,
                        exact=True)
            x, w = gaussian_inputs(gen, N, D, V, device)
            err, _ = compare(f"k={k}, gaussian inputs", x, w, k, exact=False)
            worst = max(worst, err)
            if device.type == "cuda":
                log(f"  head_topk k={k} at N={N}: "
                    f"{time_cuda(lambda: head_topk(x, w, k), 10, graph=True):.4f} ms")
    return worst


GATE_BEAMS = (1, 3, 5, 8, 16)  # 16: the largest k of the register lists


def head_gate_phase(device, s):
    """One beam-resident selection step both ways at each (rows, beam): the
    head kernel + ``_finish_select`` against fast select (the head's raw
    logits, their logsumexp and ``_select_topk_hier``), at images x beam
    rows (the row count rounded down to a multiple of the beam).  Prints
    the times and, per beam, the crossover: the fewest rows from which the
    kernel wins at every larger row count measured."""
    from openviic_tpu_torch.decoding.beam_search import (
        _finish_select, _head_kernel_wins, _select_topk_hier)
    from openviic_tpu_torch.ops.head_topk import head_topk

    gen = torch.Generator().manual_seed(7)
    D, V = s["d_model"], s["vocab"]
    w = gaussian_inputs(gen, 1, D, V, device)[1]
    row_counts = ((1, 2, 4, 8, 16, 24, 40, 80, 160, 320, 480, 960, 1600, 3200)
                  if device.type == "cuda"
                  else (16, 32))
    table = {}
    for beam in GATE_BEAMS:
        for nominal in row_counts:
            b_s = nominal // beam
            if b_s < 1:
                continue
            x = gaussian_inputs(gen, b_s * beam, D, V, device)[0]
            seq = torch.randn((b_s, beam), generator=gen).to(device) * 5
            fin = torch.zeros((b_s, beam), dtype=torch.bool, device=device)

            def kernel():
                vals, idxs, lse = head_topk(x, w, beam)
                lse = lse.reshape(b_s, beam)
                return _finish_select(vals.reshape(b_s, beam, beam),
                                      idxs.long().reshape(b_s, beam, beam),
                                      seq - lse, fin, seq, beam)

            def fast():
                logits = torch.nn.functional.linear(x, w).float()
                lse = torch.logsumexp(logits, dim=-1).reshape(b_s, beam)
                return _select_topk_hier(logits.reshape(b_s, beam, V), seq - lse, fin, seq, beam)

            if device.type == "cuda":
                table[beam, b_s * beam] = (time_cuda(kernel, 20), time_cuda(fast, 20))
            else:
                kernel(), fast()
                table[beam, b_s * beam] = (0.0, 0.0)
    if device.type != "cuda":
        return table
    log("  selection step, ms (kernel + _finish_select / fast select), NVIDIA H100 per run:")
    for beam in GATE_BEAMS:
        rows = sorted(r for b, r in table if b == beam)
        cells = [f"{r}: {table[beam, r][0]:.4f}/{table[beam, r][1]:.4f}" for r in rows]
        wins = [table[beam, r][0] < table[beam, r][1] for r in rows]
        cross = next((r for i, r in enumerate(rows) if all(wins[i:])), None)
        gate = [r for r in rows if _head_kernel_wins(r // beam, beam)]
        log(f"  beam {beam}: {'; '.join(cells)}; kernel wins from "
            f"{cross if cross is not None else 'no row count measured'}; the port's gate "
            f"takes the kernel at {gate or 'none'}")
    return table


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(logs) -> str:
    keep = []
    for name, text in logs.items():
        for line in text.splitlines():
            line = line.replace("ptxas info    :", "").strip()
            if line.startswith(("Compiling entry", "Used")) or "spill" in line:
                keep.append(f"{name}: {line}")
    return " | ".join(keep)


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDL", "STL")  # wgmma, mma.sync, TMA loads, local memory


def sass_table(name: str) -> dict:
    """Per kernel of csrc/<name>.cu's library (mangled name), how many of
    SASS_OPS its machine code holds (``cuobjdump -sass``)."""
    import re

    from openviic_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func = found.group(1)
            counts[func] = dict.fromkeys(SASS_OPS, 0)
        elif func:
            op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op and op.group(1) in counts[func]:
                counts[func][op.group(1)] += 1
    return counts


def sass_counts(name: str) -> str:
    """sass_table as a line: the evidence that a kernel is built on wgmma,
    mma.sync and TMA, and spills nothing."""
    import re

    table = sass_table(name)
    if not table:
        return f"{name}: cuobjdump not found"
    out = []
    for func, c in table.items():
        # the kernel's own name and its template arguments, out of the mangled name
        found = re.search(r"\d+([a-z_]*(?:kernel|partial|merge|fast|general|mma|simt)\w*)", func)
        label = found.group(1) if found else f"...{func[-44:]}"
        out.append(f"{name}: {label[:60]}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    return " | ".join(out)


def occupancy_lines(s):
    """How the layer-step kernels, the head kernel, the beam-select kernels
    and the geo MMA kernel run at the main shape on this card (the ptxas
    report gives the same registers and spills)."""
    from openviic_tpu_torch.ops.beam_select_attention import kernel_route as beam_route
    from openviic_tpu_torch.ops.beam_select_attention import occupancy as beam_occupancy
    from openviic_tpu_torch.ops.geo_attention import occupancy as geo_occupancy
    from openviic_tpu_torch.ops.head_topk import occupancy as head_occupancy
    from openviic_tpu_torch.ops.layer_step import occupancy

    N = s["batch"] * s["beam"]
    lines = []
    for resident in (True, False):
        occ = occupancy(resident, N, s["d_model"], s["d_ff"], s["max_len"],
                        -(-s["n_regions"] // 8) * 8, s["heads"])  # the regions as padded
        name = "resident_layer_step" if resident else "fused_layer_step"
        lines.append(f"{name} occupancy at N = {N}: "
                     + ", ".join(f"{k} {v}" for k, v in occ.items()))
    for k in (s["beam"], 16, 128):
        occ = head_occupancy(s["d_model"], k)
        lines.append(f"head_topk partial kernel at D = {s['d_model']}, k = {k}: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    h, d = s["heads"], s["d_model"] // s["heads"]
    meta = torch.empty((N, 1, h, d), dtype=torch.bfloat16, device="meta")
    route = beam_route(meta, meta, meta)
    for r in sorted({route, 0}):
        occ = beam_occupancy(r, s["beam"], h, s["max_len"])
        lines.append(f"beam_select_attention {'fast' if r else 'general'} kernel (route {r}) "
                     f"at beam {s['beam']}, {h} heads of {d}: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    n = -(-s["n_regions"] // 8) * 8
    for nn_ in (n, n + 16):
        occ = geo_occupancy(s["batch"], nn_, h, d // 8)
        lines.append(f"geo_fused_attention MMA kernel at bs {s['batch']}, n {nn_}, {h} heads: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse phases 3-8 at tiny widths on the CPU")
    args = parser.parse_args()
    t_start = time.perf_counter()

    if args.cpu:
        import openviic_tpu_torch  # noqa: F401  (fails outside a checkout)

        device = torch.device("cpu")
        # tiny widths: one thread is fastest, and keeps the rehearsal's cost
        # steady when other processes share the cores
        torch.set_num_threads(1)
        all_phases(device, TINY, "the CPU")
        log(f"total: {time.perf_counter() - t_start:.3f} s")
        log("cpu rehearsal ok")
        return 0

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import openviic_tpu_torch  # noqa: F401  (fails outside a checkout)
    from openviic_tpu_torch.ops import cuda_build

    # f32 products in the plain versions run in full f32, and bf16 GEMMs
    # accumulate in f32, as in the JAX reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    device = torch.device("cuda:0")
    smi = timed("device", nvidia_smi_line)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"  nvidia-smi: {smi}; torch: {kind}, {count} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    logs = timed("build", lambda: cuda_build.build(force=True))
    log(f"  ptxas: {ptxas_summary(logs)}")
    for line in occupancy_lines(FLAGSHIP):
        log(f"  {line}")
    for name in ("head_topk", "layer_step", "beam_select_attention", "geo_attention"):
        log(f"  sass: {sass_counts(name)}")
    if not any(c["HMMA"] and "geo_attention_mma" in f
               for f, c in sass_table("geo_attention").items()):
        raise AssertionError("the geo MMA kernels hold no HMMA (mma.sync) instruction")
    entries = all_phases(device, FLAGSHIP, smi)
    log(f"total: {time.perf_counter() - t_start:.3f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def all_phases(device, s, card: str):
    """Phases 3-8.  Returns the per-kernel entries (none on the CPU), each
    with its launches on its decode path."""
    head = timed("kernel vs plain", lambda: kernel_phase(device, s))
    timed("head_topk k = 32, 128 vs plain", lambda: head_large_k_phase(device, s))
    timed("head-kernel gate sweep", lambda: head_gate_phase(device, s))
    served = timed("serve", lambda: serve_phase(device, s, card))
    layer = served["pipe"].model.decoder.layers[0]
    found = [
        head,
        timed("beam_select_attention vs plain", lambda: beam_select_phase(device, s)),
        timed("resident_layer_step vs plain", lambda: layer_step_phase(device, s, layer, True)),
        timed("fused_layer_step vs plain", lambda: layer_step_phase(device, s, layer, False)),
        timed("fused_attention vs plain", lambda: fused_attention_phase(device, s)),
        timed("geo_fused_attention vs plain", lambda: geo_attention_phase(device, s)),
    ]
    paths = timed("decode paths (a)-(c)", lambda: decode_paths_phase(device, s, served, card))
    paths["forced"] = timed("forced decode (a)-(c)", lambda: forced_phase(device, s, served))
    launches = timed("attention decode paths (d)-(g), forced (d), (e), (g)",
                     lambda: attention_paths_phase(device, s, served, paths, card))
    launches.update(paths, head_topk=served["launches"])
    if device.type != "cuda":
        return []
    found[1].update(paths["beam_select_captured"])
    for e in found:
        e["launches"] = launches[e["name"]]
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its decode path")
    return found


if __name__ == "__main__":
    sys.exit(main())
