#!/usr/bin/env python3
"""Both layer-step kernels at several encoder lengths M, on the card.

    python3 scripts/torch_layer_step_lengths.py TAG [check]

Run from the root of a checkout (the one whose ``openviic_tpu_torch`` and
``chip_smoke.py`` it imports: the current directory).  Builds
``csrc/layer_step.cu`` if needed; then, with the flagship's layer-0
weights (``chip_smoke.FLAGSHIP``, seed 0), for M = 50, 56, 99, 112 and 200
prints each kernel's shared memory per block and its time (a CUDA graph of
20 launches between CUDA events) at the flagship decode step (320 images x
beam 5 = 1600 rows, t = 12, ``chip_smoke.step_case``'s inputs).  With
``check`` it first holds each kernel against its plain version there and
at 35 rows at the last step.  A checkout whose kernels refuse a length
(more shared memory than the card offers) prints the refusal.  To compare
two commits in one call, run it from an unpacked archive of each, in
turns; every line starts with TAG."""

import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openviic_tpu_torch.builders import build_model  # noqa: E402
from openviic_tpu_torch.ops import cuda_build  # noqa: E402
from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step  # noqa: E402
from openviic_tpu_torch.ops.layer_step import library  # noqa: E402
from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step  # noqa: E402

LENGTHS = (50, 56, 99, 112, 200)


def main() -> int:
    tag = sys.argv[1]
    check = len(sys.argv) > 2 and sys.argv[2] == "check"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(tag, cs.nvidia_smi_line(), flush=True)
    logs = cuda_build.build(["layer_step"])
    print(tag, "ptxas:", cs.ptxas_summary(logs), flush=True)
    s = cs.FLAGSHIP
    model = build_model(cs.model_config(s).MODEL, cs.make_vocab(s), device=dev)
    weights = model.decoder.layers[0].fused_weights(torch.bfloat16)
    h, L, beam, D = s["heads"], s["max_len"], s["beam"], s["d_model"]
    lib = library()
    for M in LENGTHS:
        for resident in (True, False):
            name = "resident" if resident else "fused"
            smem = lib.openviic_layer_step_smem(int(resident), D, s["d_ff"], L, M)
            print(tag, name, "M", M, "smem", smem, flush=True)
            gen = torch.Generator().manual_seed(7)
            for img, t in ((s["batch"], L // 2), (7, L - 1)):
                c = cs.step_case(gen, img, dict(s, n_regions=M), t, dev)
                N = img * beam
                if resident:
                    args = (c["x"][:, None], c["k"], c["v"], c["ck"], c["cv"], c["anc"],
                            c["smask"].reshape(N, 1, 1, L), c["cmask"].reshape(img, 1, 1, M),
                            c["is_pad"])
                    fn = lambda: resident_layer_step(*args, t, weights, h)  # noqa: E731
                    if check:
                        print(tag, name, M, N, t,
                              cs.check_resident_step(name, args, t, weights, h, dev), flush=True)
                else:
                    rows = lambda a: a.reshape(img, M, D).repeat_interleave(beam, 0)  # noqa: E731
                    k0, v0 = c["k"].reshape(N, L, D), c["v"].reshape(N, L, D)
                    ins = (c["x"], rows(c["ck"]), rows(c["cv"]), c["smask"],
                           c["cmask"].repeat_interleave(beam, dim=0))
                    kk, vk = k0.clone(), v0.clone()
                    fn = lambda: fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)  # noqa
                    if check:
                        print(tag, name, M, N, t,
                              cs.check_fused_step(name, ins, k0, v0, t, weights, h, dev),
                              flush=True)
                if img == s["batch"]:
                    try:
                        ms = cs.time_cuda(fn, 20, graph=True)
                        print(tag, name, "M", M, "N", N, "t", t, "ms", round(ms, 4), flush=True)
                    except ValueError as exc:  # a kernel whose shared memory grows with M
                        print(tag, name, "M", M, "refused:", str(exc)[:200], flush=True)
    print(tag, "done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
