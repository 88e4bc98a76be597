"""The plan of the port's fast beam-select kernel
(``csrc/beam_select_attention.cu``, ``fast::kernel``) emulated in PyTorch on
the CPU, held against the JAX package's Pallas kernel
``openviic_tpu/ops/beam_select_attention.py::beam_select_attention`` run in
interpret mode.

The CUDA kernel cannot run here; what it does differently from the plain
version (one softmax over all L positions, then PV) is its order of work,
and that is what this emulates, at bf16 inputs with f32 arithmetic:

 - one warp per beam row over every head: lane l holds elements
   [16 l, 16 l + 16) of a row of h * d_k = 512 (the flagship's 8 heads of
   64), so a head's dot is four lanes' partial sums, each of 16 products
   in sequence, added in a tree (shuffles 1, 2);
 - positions in chunks of 32; in a chunk the live ones in order (all of
   them when the row has none: the fully masked row is uniform), in
   batches of 4;
 - an online softmax across batches: the batch max, the running
   denominator and the PV sums rescaled by ``exp(m_old - m_new)``, the
   batch's exponentials summed in sequence, PV summed position by
   position; at the end the sums divided by the denominator.

FMA steps are emulated in float64 and rounded once to float32.  Tolerance:
``ATOL_F32`` = 1e-5, the f32 bar of ``test_torch_port_decode_kernels.py``
(the plan sums the same f32 terms as the JAX kernel in another order),
at the flagship widths (8 heads of 64) with a few images, at L = 25 and at
L = 40 (two chunks of positions)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.ops.beam_select_attention import beam_select_attention as jax_beam_select
from openviic_tpu_torch.ops.beam_select_attention import (
    ancestor_rows,
    beam_select_attention,
    kernel_route,
)

ATOL_F32 = 1e-5
IMG, BEAM, H, D = 3, 5, 8, 64
CHUNK = 32
E = 16  # elements per lane at h * d_k = 512
BATCH = 4  # positions per batch at h * d_k = 512


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf elementwise: a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _tree(xs):
    """The xor-shuffle tree over a power-of-two count of values: pairs of
    neighbours first."""
    xs = list(xs)
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] for i in range(0, len(xs), 2)]
    return xs[0]


def _dots(k_row: torch.Tensor, q_row: torch.Tensor) -> torch.Tensor:
    """(h,) dots of one position: each lane sums its E products in sequence
    (products of bf16 values are exact in f32), then the head's lanes."""
    h, d_k = q_row.shape
    kl, ql = k_row.reshape(h, d_k // E, E), q_row.reshape(h, d_k // E, E)
    part = torch.zeros((h, d_k // E), dtype=torch.float32)
    for i in range(E):
        part = part + kl[..., i] * ql[..., i]
    return _tree(part.unbind(-1))


def fast_plan(q, k, v, anc, pmask, mask_axis):
    """(N, 1, h, d_v) float32: the fast kernel's order of work."""
    N, _, h, d_k = q.shape
    L = k.shape[1]
    src = ancestor_rows(anc)
    pm = pmask.reshape(N, L)
    dead = pm[src, torch.arange(L)] if mask_axis == "p" else pm
    scale = torch.tensor(1.0 / math.sqrt(d_k), dtype=torch.float32)
    out = torch.empty((N, h, d_k), dtype=torch.float32)
    for n in range(N):
        uniform = bool(dead[n].all())
        m = torch.full((h,), -math.inf)
        den = torch.zeros(h)
        acc = torch.zeros((h, d_k))
        for j0 in range(0, L, CHUNK):
            sel = [j for j in range(j0, min(j0 + CHUNK, L)) if uniform or not dead[n, j]]
            for b0 in range(0, len(sel), BATCH):
                batch = sel[b0:b0 + BATCH]
                s = torch.full((BATCH, h), -math.inf)
                for i, p in enumerate(batch):
                    s[i] = 0.0 if uniform else _dots(k[src[n, p], p], q[n, 0]) * scale
                mn = torch.maximum(m, s.amax(0))
                alpha = torch.exp(m - mn)  # exp(-inf) = 0 on the first batch
                m = mn
                e = torch.exp(s - m)
                es = torch.zeros(h)
                for i in range(BATCH):
                    es = es + e[i]
                den = _fma(den, alpha, es)
                acc = acc * alpha[:, None]
                for i, p in enumerate(batch):
                    acc = _fma(v[src[n, p], p], e[i][:, None], acc)
        out[n] = acc / den[:, None]
    return out.reshape(N, 1, h, d_k)


def _bf16_values(rng, *shape) -> np.ndarray:
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _inputs(L: int, t: int, seed: int = 11):
    """A mid-decode step at position t: random ancestry, random pads among
    the earlier positions, positions past t masked, and row 4 (image 0)
    fully masked."""
    rng = np.random.default_rng(seed)
    N = IMG * BEAM
    q = _bf16_values(rng, N, 1, H, D)
    k = _bf16_values(rng, N, L, H, D)
    v = _bf16_values(rng, N, L, H, D)
    anc = rng.integers(0, BEAM, size=(IMG, BEAM, L))
    pmask = (rng.random((N, L)) < 0.2) | (np.arange(L) > t)[None]
    pmask[:, 0] = False
    pmask[4] = True
    return q, k, v, anc, pmask.reshape(N, 1, 1, L)


@pytest.mark.parametrize("L,t", [(25, 12), (25, 24), (40, 37)], ids=["L25_t12", "L25_t24",
                                                                      "L40_t37"])
@pytest.mark.parametrize("mask_axis", ["p", "q"])
def test_fast_plan_matches_jax_kernel(L, t, mask_axis):
    q, k, v, anc, pmask = _inputs(L, t)
    want = np.asarray(jax_beam_select(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(anc, jnp.int32), jnp.asarray(pmask),
                                      mask_axis=mask_axis))
    got = fast_plan(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, anc, pmask)),
                    mask_axis)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=ATOL_F32)


def test_fully_masked_row_is_uniform_in_the_plan():
    """The rare branch: every position of row 4 masked reads all L
    positions with equal weights."""
    q, k, v, anc, pmask = (torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs(25, 12))
    got = fast_plan(q, k, v, anc, pmask, "q")[4, 0]
    src = ancestor_rows(anc)[4]
    mean = v[src, torch.arange(25)].double().mean(0)
    np.testing.assert_allclose(got.numpy(), mean.numpy(), atol=ATOL_F32, rtol=0)


def _meta(shape, dtype=torch.bfloat16, strides=None):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t if strides is None else t.as_strided(shape, strides)


@pytest.mark.parametrize("h,d,route", [(8, 64, 2), (4, 64, 1), (16, 64, 4), (4, 128, 2),
                                        (32, 16, 2), (4, 96, 0), (12, 64, 0), (4, 100, 0),
                                        (2, 6, 0)])
def test_kernel_route_by_row_width(h, d, route):
    """The fast kernel takes rows of h * d = 256, 512 or 1024 elements, each
    lane's 8, 16 or 32 of them within one head; the general kernel the
    rest."""
    q = _meta((10, 1, h, d))
    k = _meta((10, 7, h, d))
    assert kernel_route(q, k, k) == route


def test_wrapper_takes_a_row_strided_q_and_refuses_other_strides():
    """q_t sliced from a fused qkv projection (rows 3 h d apart) passes
    every check up to the device's; a q_t whose heads are not contiguous
    within a row is refused."""
    N, L, h, d = 10, 7, 4, 8
    k, anc = _meta((N, L, h, d)), _meta((2, 5, L), torch.int64)
    mask = _meta((N, 1, 1, L), torch.bool)
    sliced = _meta((N, 1, h, d), strides=(3 * h * d, 3 * h * d, d, 1))
    with pytest.raises(ValueError, match="cuda"):
        beam_select_attention(sliced, k, k, anc, mask)
    transposed = _meta((N, 1, h, d), strides=(h * d, h * d, 1, h))
    with pytest.raises(ValueError, match="heads"):
        beam_select_attention(transposed, k, k, anc, mask)
