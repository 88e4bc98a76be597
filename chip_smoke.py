#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``openviic_tpu_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100
    python3 chip_smoke.py --cpu    # rehearsal at tiny widths on the CPU

On the card it runs five phases, each printing its seconds:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when CUDA is unavailable;
2. build: nvcc over ``openviic_tpu_torch/csrc/*.cu`` (one process per
   source) and the ptxas register/spill report;
3. kernel vs plain: the ``head_topk`` CUDA kernel against its plain PyTorch
   version on the card, at the flagship decode shape (N = 320 x 5 beams =
   1600 rows, D = 512, V = 10 000, k = 5), at a ragged shape (N = 37,
   V = 7 094) and in a constructed tie case; then its time beside its
   bound, the plain version's time and a PyTorch composite's;
4. serve: the flagship captioner (StandardTransformerUsingRegion, d_model
   512, 8 heads, 3+3 layers, d_ff 2048, 50 x 1024-d region features, vocab
   10 000, max_len 25, random weights from a seed) built through the port's
   ``build_model`` and served through ``CaptioningPipeline.caption_features``
   at beam 5, batch 320, bf16, head kernel on: three requests (320, 320 and
   7 images).  The kernel's launch count must equal the decode steps, every
   id must lie in the vocab, and the captions must agree with the
   fast-select path (head kernel off) on >= 95% of the images;
5. the last line: ``{"ok": true, "device": {...}}``.

The line before the last is a JSON object with one entry per kernel of the
path (launches on the serve phase, error, times and bound).  Any failure
raises, and the script exits non-zero without that line.  ``--cpu`` runs
phases 3-4 at tiny widths with the plain versions on the CPU and ends with
``cpu rehearsal ok`` instead.  The script writes nothing outside
``openviic_tpu_torch/_build/``.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True  # write nothing into the checkout but _build/

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (dense, no sparsity) for the bound column.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FLAGSHIP = dict(d_model=512, heads=8, layers=3, d_ff=2048, d_feature=1024,
                n_regions=50, vocab=10_000, max_len=25, beam=5, batch=320)
TINY = dict(d_model=32, heads=2, layers=2, d_ff=64, d_feature=24,
            n_regions=7, vocab=300, max_len=12, beam=5, batch=8)
AGREEMENT_MIN = 0.95
LSE_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def model_config(s):
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
    training = {"EVALUATING_BEAM_SIZE": s["beam"], "DECODE_HEAD_KERNEL": True}
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


def time_cuda(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(device, s):
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference

    gen = torch.Generator().manual_seed(0)
    N, D, V, k = s["batch"] * s["beam"], s["d_model"], s["vocab"], s["beam"]
    compare("main shape, exact inputs", *exact_inputs(gen, N, D, V, device), k, exact=True)
    x, w = gaussian_inputs(gen, N, D, V, device)
    err, _ = compare("main shape, gaussian inputs", x, w, k, exact=False)
    ragged_v = 7094 if s is FLAGSHIP else 277
    compare("ragged shape", *exact_inputs(gen, 37, D, ragged_v, device), k, exact=True)
    if s is FLAGSHIP:
        tie_case(gen, device, k)
    if device.type != "cuda":
        return None

    def library():
        logits = x @ w.T
        return torch.logsumexp(logits.float(), dim=1), torch.topk(logits, k, dim=1)

    ms = time_cuda(lambda: head_topk(x, w, k), 50)
    plain_ms = time_cuda(lambda: head_topk_reference(x, w, k), 10)
    library_ms = time_cuda(library, 50)
    flops = 2.0 * N * D * V
    bytes_moved = (N * D + V * D) * 2 + N * k * (4 + 4) + N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    log(f"  head_topk at N={N} D={D} V={V} k={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"matmul+logsumexp+topk {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.1f} GFLOP, "
        f"{bytes_moved / 1e6:.2f} MB)")
    return {
        "name": "head_topk", "route": "cuda",
        "source": "openviic_tpu_torch/csrc/head_topk.cu",
        "replaces": "openviic_tpu/ops/head_topk.py:103",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------- phase 4
def serve_phase(device, s, card: str):
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

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    head_topk.launches = 0
    steps0 = pipe.searcher.steps
    results, seconds = [], []
    for request in requests:
        t0 = time.perf_counter()
        captions, ids = pipe.caption_features(request, return_ids=True)
        sync()
        seconds.append(time.perf_counter() - t0)
        results.append((captions, ids))
    launches = head_topk.launches
    steps = pipe.searcher.steps - steps0
    expected = steps if device.type == "cuda" else 0
    if steps <= 0 or launches != expected:
        raise AssertionError(f"head_topk launched {launches} times over {steps} decode steps")
    for request, (captions, ids) in zip(requests, results):
        if len(captions) != len(request) or ids.shape != (len(request), s["max_len"]):
            raise AssertionError(f"{len(captions)} captions, ids {ids.shape} for {len(request)} images")
        if ids.min() < 0 or ids.max() >= len(vocab):
            raise AssertionError(f"token id outside [0, {len(vocab)}): {ids.min()}..{ids.max()}")
        for caption in captions:
            if not isinstance(caption, str) or any(
                tok not in vocab.stoi or tok in vocab.specials for tok in caption.split()
            ):
                raise AssertionError(f"caption not made of vocab words: {caption!r}")
    rate = 2 * s["batch"] / (seconds[0] + seconds[1])
    log(f"  served {sum(len(r) for r in requests)} images in requests of "
        f"{[len(r) for r in requests]}: {[round(t, 4) for t in seconds]} s; "
        f"{steps} decode steps, {launches} head_topk launches")
    log(f"  decode throughput at batch {s['batch']}, beam {s['beam']}: {rate:.1f} captions/s on {card}")
    log(f"  sample caption: {results[0][0][0]!r}")

    fast = CaptioningPipeline(config, vocab, batch_size=s["batch"], head_kernel=False,
                              device=device, seed=0)
    fast_captions = fast.caption_features(requests[0])
    same = np.mean([a == b for a, b in zip(results[0][0], fast_captions)])
    log(f"  captions identical to the fast-select path: {same:.4f} of {len(fast_captions)}")
    if same < AGREEMENT_MIN:
        raise AssertionError(f"agreement {same:.4f} < {AGREEMENT_MIN}")
    return launches


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse phases 3-4 at tiny widths on the CPU")
    args = parser.parse_args()
    t_start = time.perf_counter()

    if args.cpu:
        import openviic_tpu_torch  # noqa: F401  (fails outside a checkout)

        device = torch.device("cpu")
        timed("kernel vs plain (cpu, plain versions)", lambda: kernel_phase(device, TINY))
        timed("serve (cpu)", lambda: serve_phase(device, TINY, "the CPU"))
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
    entry = timed("kernel vs plain", lambda: kernel_phase(device, FLAGSHIP))
    entry["launches"] = timed("serve", lambda: serve_phase(device, FLAGSHIP, smi))
    log(f"total: {time.perf_counter() - t_start:.3f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
