"""The plan of the port's tensor-core geometry kernel
(``csrc/geo_attention.cu``, ``mma::kernel``) emulated in PyTorch on the CPU,
held against the JAX package's Pallas kernel
``openviic_tpu/ops/geo_attention.py::geo_fused_attention`` run in interpret
mode.

The CUDA kernel cannot run here; what it does differently from the plain
version is its plan, and the plan is what this emulates:

 - the geometry rows computed from the boxes in the kernel, each op in f32
   rounded to the boxes' dtype (as torch computes ``_operands``);
 - the bias built once per box pair for every head: the four
   displacements, sin and cos by the kernel's branch-free reduction and
   polynomials (``sincos_reduced``), the fold ``acc + ws * sin + wc * cos``
   as two FMAs per (s, f), then ``log(max(relu(acc + b), 1e-6))`` plus the
   mask term;
 - Q K^T as mma.sync m16n8k16 steps: bf16 q and k, each 16-deep chunk's
   exact products summed into the f32 accumulator once, chunk after chunk;
   ``s * scale + bias`` as one FMA;
 - the full-row softmax with each lane's pairs of keys summed, then the
   lane quad's tree; p = e * (1 / sum) rounded to bf16;
 - P V as 16-key chunks into f32 accumulators, the output in q's dtype.

FMA steps are emulated in float64 and rounded once to float32.  Tolerance:
``test_torch_port_ort.py::test_geo_plain_matches_jax_kernel``'s bar, >= 99%
of the elements within one bf16 ulp of max(|want|, 1) and 1e-2 everywhere
(both round q, k, v and p to bf16 at the same points; f32 sums in other
orders can flip one such rounding), at the ORT encoder's widths (8 heads
of 64, dim_g 64) with n = 56 (the padded 50 regions) and a ragged n = 13."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.ops.geo_attention import geo_fused_attention as jax_geo_fused_attention
from openviic_tpu_torch.ops.geo_attention import (
    _frequencies,
    _operands,
    geo_fused_attention,
    kernel_route,
)

NEG = -1e30
H, DK, DIM_G = 8, 64, 64


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fmaf elementwise: a * b + c rounded once to float32."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def kernel_geometry(boxes: torch.Tensor) -> torch.Tensor:
    """(bs, 4, n) f32 geometry rows as the kernel's load_side computes them
    from boxes of any of its dtypes: each op in f32, rounded to the boxes'
    dtype."""
    dt = boxes.dtype
    x0, y0, x1, y1 = boxes.float().unbind(-1)
    return torch.stack([
        _rounded(_rounded(x0 + x1, dt) * 0.5, dt),
        _rounded(_rounded(y0 + y1, dt) * 0.5, dt),
        _rounded(torch.log(_rounded(_rounded(x1 - x0, dt) + 1.0, dt)), dt),
        _rounded(torch.log(_rounded(_rounded(y1 - y0, dt) + 1.0, dt)), dt),
    ], dim=1)


def sincos_reduced(x: torch.Tensor):
    """csrc/geo_attention.cu's sincos_reduced, op by op in float32."""
    j = torch.round(x * np.float32(0.636619772))  # rintf: ties to even
    t = _fma(j, -1.5707962512969971e+00, x)
    t = _fma(j, float(np.float32(-7.5497894158615964e-08)), t)
    t = _fma(j, float(np.float32(-5.3903029534742384e-15)), t)
    t2 = t * t

    def c(v):
        return float(np.float32(v))

    ps = _fma(torch.full_like(t2, c(-1.95152959e-4)), t2, c(8.33216087e-3))
    ps = _fma(ps, t2, c(-1.66666546e-1))
    ps = _fma(ps * t2, t, t)
    pc = _fma(torch.full_like(t2, c(2.44331571e-5)), t2, c(-1.38873163e-3))
    pc = _fma(pc, t2, c(4.16666457e-2))
    pc = _fma(pc, t2, -0.5)
    pc = _fma(pc, t2, 1.0)
    q = j.to(torch.int64)
    s0 = torch.where(q % 2 == 1, pc, ps)
    c0 = torch.where(q % 2 == 1, ps, pc)
    sn = torch.where((q & 2) != 0, -s0, s0)
    cs = torch.where(((q + 1) & 2) != 0, -c0, c0)
    return sn, cs


def plan_bias(geo, mask, w, fb, omega):
    """(bs, h, n, n) f32 bias planes, the kernel's build_bias."""
    cx, cy, lw, lh = geo.unbind(1)
    n_freq = omega.numel()
    disp = [
        torch.log(torch.clamp_min(((cx[:, :, None] - cx[:, None, :])
                                   / lw.exp()[:, :, None]).abs(), 1e-3)),
        torch.log(torch.clamp_min(((cy[:, :, None] - cy[:, None, :])
                                   / lh.exp()[:, :, None]).abs(), 1e-3)),
        lw[:, :, None] - lw[:, None, :],
        lh[:, :, None] - lh[:, None, :],
    ]
    half = w.shape[0] // 2
    acc = torch.zeros(disp[0].shape + (w.shape[1],), dtype=torch.float32)
    for s in range(4):
        for f in range(n_freq):
            sn, cs = sincos_reduced(disp[s] * omega[f])
            row = s * n_freq + f
            acc = _fma(w[row], sn[..., None], acc)
            acc = _fma(w[half + row], cs[..., None], acc)
    g = torch.clamp_min(torch.relu(acc + fb), 1e-6)
    bias = torch.log(g) + (mask.float() * NEG)[:, None, :, None]
    return bias.permute(0, 3, 1, 2)


def _chunked(a: torch.Tensor, b: torch.Tensor, eq: str, da: int, db: int) -> torch.Tensor:
    """An m16n8k16 product chain: the contraction axis (``da`` of ``a``,
    ``db`` of ``b``) in 16-deep chunks, each chunk's products summed exactly
    and added to the f32 accumulator with one rounding."""
    depth = a.shape[da]
    acc = None
    for c0 in range(0, depth, 16):
        width = min(16, depth - c0)
        part = torch.einsum(eq, a.narrow(da, c0, width).double(),
                            b.narrow(db, c0, width).double())
        acc = part.float() if acc is None else (acc.double() + part).float()
    return acc


def mma_plan(q, k, v, boxes, fc_g, fc_b, padding_mask, scale, wave_len=1000.0):
    bs, n, h, dk = q.shape
    geo = kernel_geometry(boxes)
    omega = _frequencies(fc_g.shape[0] // 8, wave_len, torch.device("cpu"))
    bias = plan_bias(geo, padding_mask.reshape(bs, n), fc_g.float(), fc_b.float(), omega)
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    acc = _chunked(qb, kb, "bqhd,bkhd->bhqk", 3, 3)
    s = _fma(acc, scale, bias)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    # lane (g, c) holds keys 8 t + 2 c, 8 t + 2 c + 1: pairs, summed per lane,
    # then the quad's tree
    pad = (-n) % 8
    ep = torch.nn.functional.pad(e, (0, pad)).reshape(bs, h, n, -1, 4, 2)
    per_lane = torch.zeros(ep.shape[:3] + (4,), dtype=torch.float32)
    for t in range(ep.shape[3]):
        per_lane = per_lane + (ep[:, :, :, t, :, 0] + ep[:, :, :, t, :, 1])
    total = (per_lane[..., 0] + per_lane[..., 1]) + (per_lane[..., 2] + per_lane[..., 3])
    p = (e * (1.0 / total)[..., None]).to(torch.bfloat16).float()
    out = _chunked(p, vb, "bhqk,bkhd->bqhd", 3, 1)
    return out.to(q.dtype)


def _boxes(rng, bs, n):
    x0, y0 = rng.uniform(0, 560, (bs, n)), rng.uniform(0, 400, (bs, n))
    w, hh = rng.uniform(4, 80, (bs, n)), rng.uniform(4, 80, (bs, n))
    boxes = np.stack([x0, y0, x0 + w, y0 + hh], axis=-1).astype(np.float32)
    boxes[0, -1] = 0.0  # a padded region
    return boxes


def _case(bs, n, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bs, n, H, DK)).astype(np.float32) for _ in range(3))
    wg = (rng.normal(size=(DIM_G, H)) * 0.2).astype(np.float32)
    bg = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    pad = np.zeros((bs, 1, 1, n), bool)
    pad[0, ..., -1] = True
    pad[-1, ..., n // 2:] = True
    return q, k, v, _boxes(rng, bs, n), wg, bg, pad


@pytest.mark.parametrize("bs,n", [(2, 56), (3, 13)], ids=["n56", "n13"])
def test_mma_plan_matches_jax_kernel(bs, n):
    case = _case(bs, n, seed=n)
    scale = 1 / math.sqrt(DK)
    want = np.asarray(jax_geo_fused_attention(*(jnp.asarray(a) for a in case), sm_scale=scale))
    got = mma_plan(*(torch.from_numpy(a) for a in case), scale).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    _, exponent = np.frexp(np.maximum(np.abs(want), 1.0))
    assert (err <= np.ldexp(1.0, exponent - 8)).mean() >= 0.99
    assert err.max() <= 1e-2, err.max()


def test_sincos_reduced_is_accurate_over_the_argument_range():
    """Within 2**-22 of float64 sin and cos for |x| up to 100 * 88.8 (the
    largest argument finite f32 boxes can give), and at the multiples of
    pi / 2 where the reduction cancels most."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-8880, 8880, 200_000), rng.uniform(-7, 7, 20_000),
                        np.arange(-5650, 5651) * (np.pi / 2)]).astype(np.float32)
    sn, cs = sincos_reduced(torch.from_numpy(x))
    xd = x.astype(np.float64)
    assert np.abs(sn.numpy() - np.sin(xd)).max() <= 2.0**-22
    assert np.abs(cs.numpy() - np.cos(xd)).max() <= 2.0**-22


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_geometry_rounds_like_torch(dtype):
    """The kernel's geometry rows from boxes of each dtype it reads equal
    the plain version's, torch's ops in that dtype, widened to f32."""
    boxes = torch.from_numpy(_boxes(np.random.default_rng(3), 4, 50)).to(dtype)
    want = _operands(boxes, torch.zeros(DIM_G, H), torch.zeros(H),
                     torch.zeros(4, 1, 1, 50, dtype=torch.bool), 1000.0)[0]
    torch.testing.assert_close(kernel_geometry(boxes), want, atol=0, rtol=0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n,h,dk,route", [(56, 8, 64, 1), (80, 8, 64, 1), (88, 8, 64, 0),
                                          (13, 16, 64, 1), (56, 8, 32, 0), (160, 4, 64, 0)])
def test_kernel_route(n, h, dk, route):
    """The MMA kernel takes d_k = 64 up to n = 128 within one block's shared
    memory (n = 80 at 8 heads, its 64-query tiles above 64); the SIMT
    kernel every other shape the wrapper takes."""
    q = _meta(2, n, h, dk)
    assert kernel_route(q, q, q, DIM_G // 8) == route


def test_wrapper_refuses_box_and_weight_dtypes_the_kernel_does_not_read():
    bs, n, h, dk = 2, 10, 4, 8
    args = [_meta(bs, n, h, dk), _meta(bs, n, h, dk), _meta(bs, n, h, dk),
            _meta(bs, n, 4, dtype=torch.float64), _meta(64, h, dtype=torch.float32),
            _meta(h, dtype=torch.float32), _meta(bs, 1, 1, n, dtype=torch.bool)]
    launches = geo_fused_attention.launches
    with pytest.raises(TypeError, match="boxes, fc_g"):
        geo_fused_attention(*args, sm_scale=0.3)
    args[3], args[4] = _meta(bs, n, 4, dtype=torch.float32), _meta(64, h, dtype=torch.int32)
    with pytest.raises(TypeError, match="boxes, fc_g"):
        geo_fused_attention(*args, sm_scale=0.3)
    assert geo_fused_attention.launches == launches
