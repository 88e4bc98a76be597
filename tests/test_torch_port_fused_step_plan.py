"""The plan of the port's fused decode-step kernel (``csrc/layer_step.cu``,
``fused::``) emulated in PyTorch on the CPU, held against the JAX package's
Pallas kernel ``openviic_tpu/ops/fused_decoder_step.py::fused_layer_step``
run in interpret mode.

The CUDA kernel cannot run here; what it does differently from one f32
product per matrix is its plan, and the plan is what this emulates:

 - every f32 A operand (the attention outputs, x1, x2, each hidden chunk)
   split once into three bf16 planes (hi + mid + lo), each multiplied by the
   bf16 weights with f32 sums; x itself is bf16, one plane;
 - a cluster of C CTAs splitting each D-wide product's columns, the heads
   and the FFN's hidden columns, the LayerNorm sums added over the CTAs;
 - the score at position t from this step's unrounded q . k_new, summed
   over each 8 columns first (the kernel's k epilogue);
 - the FFN in chunks of hidden columns, each chunk's relu(x2 W1 + b1) split
   into planes and multiplied by its W2 rows at once, the partial sums of
   each CTA's share of the depth added across the cluster.

Tolerance: the existing f32 bar of the fused step (``ATOL_F32`` = 1e-5 in
``test_torch_port_decode_kernels.py``), at the flagship widths (D = 512, 8
heads, F = 2048) with a few rows: the plan sums the same f32 products as
the JAX kernel in another order, and three bf16 planes carry an f32
operand's 24 significand bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.ops.fused_decoder_step import fused_layer_step as jax_fused_step

ATOL_F32 = 1e-5
NEG = -1e30
LN_EPS = 1e-5
IMG, BEAM, L, M, D, H, F = 2, 3, 6, 7, 512, 8, 2048
N = IMG * BEAM


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def split3(a: torch.Tensor):
    """The three bf16 planes of an f32 operand."""
    hi = _bf16(a)
    mid = _bf16(a - hi)
    return hi, mid, _bf16(a - hi - mid)


def mm3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An f32 operand times bf16-valued weights, plane by plane, f32 sums."""
    hi, mid, lo = split3(a)
    return hi @ w + mid @ w + lo @ w


def cluster_layer_norm(parts):
    """The JAX _ln over all columns, before its scale and shift, when each
    CTA holds its own: the row sums and then the squared deviations added
    over the CTAs."""
    mean = sum(p.sum(-1, keepdim=True) for p in parts) / D
    var = sum(((p - mean) ** 2).sum(-1, keepdim=True) for p in parts) / D
    inv = 1.0 / torch.sqrt(var + LN_EPS)
    return [(p - mean) * inv for p in parts]


def fused_plan(x, kc, vc, ck, cv, smask, cmask, t, w, cluster, chunk):
    """y of one fused decode step, computed as the CUDA tile plans it."""
    C = cluster
    Dc, Fc, d = D // C, F // C, D // H
    scale = 1.0 / d ** 0.5
    own = [slice(c * Dc, (c + 1) * Dc) for c in range(C)]

    def ln(xs_parts, key):
        s, b = w[f"{key}s"], w[f"{key}b"]
        return torch.cat([n * s[o] + b[o] for n, o in zip(cluster_layer_norm(xs_parts), own)],
                         dim=1)

    # qkv: x is bf16, so one plane is exact; each CTA its own columns of q, k, v
    qkv = x @ w["wqkv"] + w["bqkv"]
    q, k_new, v_new = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    s_new = (q * k_new).reshape(N, D // 8, 8).sum(-1)  # the k epilogue's sums by 8 columns
    s_new = s_new.reshape(N, H, d // 8).sum(-1) * scale

    def attend(qv, keys, values, mask, at_t=None):
        """f32 scores, final max, the 1e-30 guard; each CTA computes its own
        heads, and heads are independent, so all of them at once here."""
        qh = qv.reshape(N, H, d)
        kh = keys.reshape(N, -1, H, d)
        scores = (kh * qh[:, None]).sum(-1) * scale  # (N, S, h)
        if at_t is not None:
            scores[:, t] = at_t
        scores = torch.where(mask[:, :, None], torch.full_like(scores, NEG), scores)
        e = torch.exp(scores - scores.amax(dim=1, keepdim=True))
        wts = e / torch.clamp_min(e.sum(dim=1, keepdim=True), 1e-30)
        vh = values.reshape(N, -1, H, d)
        return (vh * wts[..., None]).sum(dim=1).reshape(N, D)

    vself = vc.clone()
    vself[:, t] = v_new
    att = attend(q, kc, vself, smask, at_t=s_new)  # each CTA computes its heads' columns
    x1 = ln([x[:, o] + (mm3(att, w["wo"][:, o]) + w["bo"][o]) for o in own], "ln1")
    q2 = mm3(x1, w["wqc"]) + w["bqc"]
    att2 = attend(q2, ck, cv, cmask)
    x2 = ln([x1[:, o] + (mm3(att2, w["woc"][:, o]) + w["boc"][o]) for o in own], "ln2")

    partial = []  # each CTA's share of the depth, summed over its chunks, every column
    for c in range(C):
        acc = torch.zeros(N, D)
        for c0 in range(0, Fc, chunk):
            cols = slice(c * Fc + c0, c * Fc + min(c0 + chunk, Fc))
            hid = torch.relu(mm3(x2, w["w1"][:, cols]) + w["b1"][cols])
            acc = acc + mm3(hid, w["w2"][cols])
        partial.append(acc)
    x3 = []
    for c, o in enumerate(own):
        total = partial[c][:, o]
        for other in range(C):
            if other != c:
                total = total + partial[other][:, o]
        x3.append(x2[:, o] + (total + w["b2"][o]))
    return ln(x3, "ln3")


def _inputs(seed, t):
    """bf16-valued f32 inputs and weights (the kernel's operands), a
    mid-decode step's masks."""
    rng = np.random.default_rng(seed)
    w = {"wqkv": rng.normal(size=(D, 3 * D)) / np.sqrt(D), "bqkv": 0.1 * rng.normal(size=3 * D),
         "w1": rng.normal(size=(D, F)) / np.sqrt(D), "b1": 0.1 * rng.normal(size=F),
         "w2": rng.normal(size=(F, D)) / np.sqrt(F)}
    for key in ("wo", "wqc", "woc"):
        w[key] = rng.normal(size=(D, D)) / np.sqrt(D)
    for key in ("bo", "bqc", "boc", "b2", "ln1b", "ln2b", "ln3b"):
        w[key] = 0.1 * rng.normal(size=D)
    for key in ("ln1s", "ln2s", "ln3s"):
        w[key] = 1.0 + 0.1 * rng.normal(size=D)
    w = {k: _bf16(torch.from_numpy(v.astype(np.float32))) for k, v in w.items()}
    x = _bf16(torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)))
    kc, vc = (_bf16(torch.from_numpy(rng.normal(size=(N, L, D)).astype(np.float32)))
              for _ in range(2))
    ck, cv = (_bf16(torch.from_numpy(np.repeat(rng.normal(size=(IMG, M, D)), BEAM, axis=0)
                                     .astype(np.float32))) for _ in range(2))
    smask = rng.random((N, L)) < 0.2
    smask[:, t + 1:] = True
    smask[:, 0] = False
    cmask = np.repeat(rng.random((IMG, M)) < 0.3, BEAM, axis=0)
    cmask[:, 0] = False
    return x, kc, vc, ck, cv, torch.from_numpy(smask), torch.from_numpy(cmask), w


def _jax_y(x, kc, vc, ck, cv, smask, cmask, t, w):
    y, _, _ = jax_fused_step(
        jnp.asarray(x.numpy()), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
        jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()), jnp.asarray(smask.numpy()),
        jnp.asarray(cmask.numpy()), jnp.asarray(t),
        {k: jnp.asarray(v.numpy()) for k, v in w.items()}, n_heads=H, block_rows=N,
    )
    return np.asarray(y)


@pytest.mark.parametrize("cluster,chunk", [(2, 128), (1, 128), (2, 384)],
                         ids=["cluster2-chunk128", "cluster1-chunk128", "cluster2-ragged-chunk"])
@pytest.mark.parametrize("seed,t", [(0, 3), (1, 0), (2, L - 1)])
def test_fused_tile_plan_matches_jax_kernel(seed, t, cluster, chunk):
    """The kernel's plan (three planes once per operand, the FFN by chunks,
    the cluster's split of columns, heads and depth) against the JAX kernel
    at f32; chunk 384 leaves a short last chunk of each CTA's 1024 hidden
    columns (the kernel's chunk is 128, and a short one where F / 2 is not
    a multiple of it)."""
    case = _inputs(seed, t)
    want = _jax_y(*case[:7], t, case[7])
    got = fused_plan(*case[:7], t, case[7], cluster, chunk)
    assert got.shape == (N, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)


def test_three_planes_carry_an_f32_operand():
    """hi + mid + lo gives back the f32 value (24 significand bits in three
    8-bit terms), so each plane's product with a bf16 weight is exact and
    only the f32 sums round; two planes would not."""
    a = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 512)).astype(np.float32))
    hi, mid, lo = split3(a)
    assert torch.equal(hi + mid + lo, a)
    assert not torch.equal(hi + mid, a)
