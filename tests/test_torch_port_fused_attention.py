"""The port's fused attention (``openviic_tpu_torch/ops/fused_attention.py``)
and its ``OPENVIIC_PALLAS`` switch against the JAX package, on the CPU.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``.  The JAX
kernel runs in interpret mode, as the JAX package's own tests run it.

Tolerances:
 - the plain version against JAX ``fused_attention`` at f32: 2e-5, the
   bar of ``tests/test_pallas_attention.py`` (both sum f32 products, in
   other orders);
 - ``_attend`` at bf16 under the flag: 1e-6 (bf16 inputs are exact in
   f32, and both return f32);
 - one ``MultiHeadAttention`` at bf16 under the flag: 1 bf16 ulp of
   max(|y|, 1) (both project, attend and normalise in f32 and round the
   output once; the bf16 q/k/v projections may round differently);
 - whole decodes at f32 under the flag: tokens equal, log-probs within
   1e-5;
 - the CUDA kernel's MMA tile, emulated in torch (bf16 Q K^T with f32 sums,
   the online softmax over 64-key tiles, p split into three bf16 terms each
   times the bf16 V with f32 sums) against the JAX kernel: 2e-5, the same
   bar, which the kernel must meet on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.attention import MultiHeadAttention as JaxMHA
from openviic_tpu.models.attention import _attend as jax_attend
from openviic_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from openviic_tpu_torch.compat.from_jax import state_dict_from_jax
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.attention import MultiHeadAttention, _attend
from openviic_tpu_torch.ops import fused_attention as fa_ops
from openviic_tpu_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_reference,
    pallas_enabled,
)
from tests.helpers import attention_config
from tests.test_torch_port_support import make_features, make_pair, make_vocab

ATOL = 2e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(np.maximum(np.abs(x), 1.0))
    return np.ldexp(1.0, exponent - 8)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("OPENVIIC_PALLAS", "interpret")


@pytest.mark.parametrize("B,nq,nk,h,d", [(2, 7, 9, 2, 16), (1, 128, 128, 4, 64),
                                        (2, 150, 200, 2, 64)])
def test_plain_matches_jax_kernel(pallas, B, nq, nk, h, d):
    """The cases of ``tests/test_pallas_attention.py::test_fused_matches_reference``."""
    q, k, v = _rand((B, nq, h, d), 0), _rand((B, nk, h, d), 1), _rand((B, nk, h, d), 2)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    launches = fused_attention.launches
    got = fused_attention(*_port(q, k, v))
    assert fused_attention.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_plain_matches_jax_kernel_with_bias_and_mask(pallas):
    """``test_fused_with_bias_and_mask``: a bias with -1e30 mask columns; the
    masked columns' values do not matter."""
    B, nq, nk, h, d = 2, 10, 12, 2, 32
    q, k, v = _rand((B, nq, h, d), 0), _rand((B, nk, h, d), 1), _rand((B, nk, h, d), 2)
    bias = np.zeros((B, h, nq, nk), np.float32)
    bias[..., -3:] = -1e30
    bias[..., 0] = 1.5
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          bias=jnp.asarray(bias)))
    got = fused_attention(*_port(q, k, v, bias)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    v2 = v.copy()
    v2[:, -3:] = 999.0
    np.testing.assert_allclose(fused_attention(*_port(q, k, v2, bias)).numpy(), got, atol=ATOL)


@pytest.mark.parametrize("bias_shape", [(2, 1, 1, 6), (2, 2, 1, 6), (1, 1, 4, 6)])
def test_plain_broadcasts_the_bias_like_jax(pallas, bias_shape):
    q, k, v = _rand((2, 4, 2, 8), 3), _rand((2, 6, 2, 8), 4), _rand((2, 6, 2, 4), 5)
    bias = _rand(bias_shape, 6)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          bias=jnp.asarray(bias), sm_scale=0.3))
    got = fused_attention(*_port(q, k, v, bias), sm_scale=0.3)
    assert got.shape == (2, 4, 2, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fully_masked_row_is_uniform_not_nan(pallas):
    """``test_fully_masked_row_is_finite``, and what the row holds: the port
    gives the mean of v over the nk keys.  The JAX kernel pads nk to 128
    with -1e30 columns of zero values, so its row is sum(v) / 128 (a
    finding about the JAX package; such rows are padding queries, which
    the callers zero)."""
    B, nq, nk, h, d = 1, 4, 6, 1, 8
    q, k, v = _rand((B, nq, h, d), 0), _rand((B, nk, h, d), 1), _rand((B, nk, h, d), 2)
    bias = np.full((B, h, nq, nk), -1e30, np.float32)
    got = fused_attention(*_port(q, k, v, bias)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape),
                               atol=1e-6)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          bias=jnp.asarray(bias)))
    np.testing.assert_allclose(want, np.broadcast_to(v.sum(axis=1, keepdims=True) / 128,
                                                     want.shape), atol=1e-6)


def test_attend_under_the_flag_returns_f32_like_jax(pallas):
    """bf16 q/k/v and a padding mask: both ``_attend``s return float32."""
    q, k, v = (_rand((3, 5, 2, 8), s) for s in (0, 1, 2))
    mask = np.zeros((3, 1, 1, 5), bool)
    mask[1, ..., -2:] = True
    bf = jnp.bfloat16
    want = jax_attend(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), 8,
                      jnp.asarray(mask))
    tq, tk, tv, tm = _port(q, k, v, mask)
    got = _attend(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), 8, tm)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # without the flag both round the result to the inputs' dtype
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENVIIC_PALLAS")
        assert _attend(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), 8, tm).dtype == torch.bfloat16


def test_mha_under_the_flag_at_bf16_matches_jax(pallas):
    """The f32 attention output goes through fc_o, the residual and the
    LayerNorm in f32 (Flax promotes the bf16 weights), then rounds to bf16
    once, in both packages."""
    cfg = attention_config()
    rng = np.random.default_rng(0)
    queries = rng.normal(size=(3, 5, cfg["D_MODEL"])).astype(np.float32)
    mask = np.zeros((3, 1, 1, 5), bool)
    mask[2, ..., -1] = True
    jax_mha = JaxMHA(JaxConfigNode(cfg))
    params = jax_mha.init(jax.random.PRNGKey(0), queries, queries, queries,
                          attention_mask=jnp.asarray(mask))
    flat = {k: np.asarray(v) + 0.1 * rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    bf = jnp.bfloat16
    jparams = jax.tree.map(lambda a: jnp.asarray(a, bf), traverse_util.unflatten_dict(flat, "/"))
    x = jnp.asarray(queries, bf)
    want = jax_mha.apply(jparams, x, x, x, attention_mask=jnp.asarray(mask))
    mha = MultiHeadAttention(ConfigNode(cfg)).eval()
    mha.load_state_dict(state_dict_from_jax(flat, mha))
    mha.to(torch.bfloat16)
    xt = torch.from_numpy(queries).bfloat16()
    with torch.no_grad():
        got = mha(xt, xt, xt, attention_mask=torch.from_numpy(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bf16_ulp(want)).all(), err.max()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["cpu_and_other_device", "shape", "dtype", "head_dim",
                                  "last_axis", "bias", "not_cuda"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Every check but the device one is reached with meta tensors, which
    stand for tensors that are not on the CPU."""
    q, k, v = _meta(2, 4, 2, 8), _meta(2, 6, 2, 8), _meta(2, 6, 2, 8)
    bias = _meta(2, 1, 1, 6, dtype=torch.float32)
    error, match = ValueError, "cuda"
    if case == "cpu_and_other_device":
        q = torch.zeros(q.shape, dtype=q.dtype)
    elif case == "shape":
        k, error, match = _meta(2, 6, 3, 8), ValueError, "inconsistent shapes"
    elif case == "dtype":
        v, error, match = _meta(2, 6, 2, 8, dtype=torch.float16), TypeError, "float32 or bfloat16"
    elif case == "head_dim":
        q, k, v = _meta(2, 4, 2, 136), _meta(2, 6, 2, 136), _meta(2, 6, 2, 8)
        error, match = ValueError, "d, dv <= 128"
    elif case == "last_axis":
        k, match = _meta(2, 6, 8, 2).transpose(2, 3), "contiguous last axis"
    elif case == "bias":
        bias, match = _meta(2, 3, 1, 6, dtype=torch.float32), "does not broadcast"
    launches = fused_attention.launches
    with pytest.raises(error, match=match):
        fused_attention(q, k, v, bias)
    assert fused_attention.launches == launches


def test_flag_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("OPENVIIC_PALLAS", raising=False)
    assert not pallas_enabled()
    for value, on in (("1", True), ("true", True), ("interpret", True), ("TRUE", True),
                      ("0", False), ("yes", False)):
        monkeypatch.setenv("OPENVIIC_PALLAS", value)
        assert pallas_enabled() is on


def test_plain_version_is_the_reference_softmax():
    q, k, v = _port(_rand((2, 3, 2, 4), 0), _rand((2, 5, 2, 4), 1), _rand((2, 5, 2, 4), 2))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(fused_attention_reference(q, k, v), want)


# ------------------------------------------------------------------ decodes
@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    return (vocab,) + make_pair(vocab, seed=3, eos_gain=6.0)


@pytest.mark.parametrize("beam_resident", [True, False], ids=["resident", "non_resident"])
def test_flagship_decode_under_the_flag_matches_jax(pair, monkeypatch, beam_resident):
    """On the beam-resident path the flag reaches only the encoder; on the
    non-resident path every decoder self- and cross-attention step too."""
    monkeypatch.setenv("OPENVIIC_PALLAS", "interpret")
    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(4, seed=50 + beam_resident)
    want_o, want_l = jax_beam_search(
        jax_model, jax_params, {"region_features": jnp.asarray(feats)}, beam_size=3,
        out_size=3, beam_resident=beam_resident,
    )
    got_o, got_l = beam_search(port_model, {"region_features": torch.from_numpy(feats)},
                               beam_size=3, out_size=3, beam_resident=beam_resident)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the MMA tile's numerics
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(p: torch.Tensor, terms: int):
    """p as `terms` bf16-valued terms whose f32 sum approximates it: hi,
    then the rounded remainders (three terms carry p's 24 bits)."""
    out, rest = [], p
    for _ in range(terms):
        out.append(_bf16(rest))
        rest = rest - out[-1]
    return out


def _mma_tile_plan(q, k, v, bias, scale, terms=3, tile=64):
    """The MMA tile's arithmetic in torch, f32: S = Q K^T of bf16 operands
    (exact products, f32 sums) * scale + bias; an online softmax over
    64-key tiles with the running max starting at -1e30; P V as the sum of
    the bf16 terms of p, each times the bf16 V."""
    B, nq, h, d = q.shape
    nk = k.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, h, n, d)
    m = torch.full((B, h, nq, 1), -1e30)
    l = torch.zeros((B, h, nq, 1))
    o = torch.zeros((B, h, nq, v.shape[3]))
    for k0 in range(0, nk, tile):
        s = qf @ kf[:, :, k0 : k0 + tile].transpose(2, 3) * scale
        if bias is not None:
            s = s + bias.float().expand(B, h, nq, nk)[..., k0 : k0 + tile]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha
        for term in _split(p, terms):
            o = o + term @ vf[:, :, k0 : k0 + tile]
        m = m_new
    return (o / l).transpose(1, 2)


def _bf16_values(shape, seed, gain=1.0):
    return _bf16(torch.from_numpy(_rand(shape, seed)) * gain)


@pytest.mark.parametrize("B,nq,nk,h,d,v_gain", [
    (2, 7, 9, 2, 16, 1.0), (2, 65, 150, 2, 64, 1.0),
    (1, 56, 56, 8, 64, 1.0), (1, 56, 56, 8, 64, 5.0),  # the flagship encoder, one image
])
def test_mma_tile_plan_matches_jax_kernel(pallas, B, nq, nk, h, d, v_gain):
    """The kernel's P V in three bf16 terms meets the JAX kernel's 2e-5 bar;
    two terms leave up to 2^-18 |p| per weight and are the weaker plan."""
    q, k = _bf16_values((B, nq, h, d), 0), _bf16_values((B, nk, h, d), 1)
    v = _bf16_values((B, nk, h, d), 2, v_gain)
    mask = np.random.default_rng(3).random((B, 1, 1, nk)) < 0.2
    mask[..., 0] = False
    bias = np.where(mask, -1e30, 0.0).astype(np.float32)
    want = np.asarray(jax_fused_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                          bias=jnp.asarray(bias)))
    scale = 1.0 / np.sqrt(d)
    tb = torch.from_numpy(bias)
    err3 = np.abs(_mma_tile_plan(q, k, v, tb, scale, terms=3).numpy() - want).max()
    err2 = np.abs(_mma_tile_plan(q, k, v, tb, scale, terms=2).numpy() - want).max()
    print(f"MMA tile plan at {(B, nq, nk, h, d)}, |v| ~ {v_gain}: three terms {err3:.3g}, "
          f"two terms {err2:.3g}")
    assert err3 <= ATOL
    assert err2 >= err3


def test_tile_choice_and_its_contract():
    """The host side of csrc/fused_attention.cu: DECODE up to the measured
    crossover, then MMA for bf16 and SIMT for f32; a forced tile that does
    not take the dtype raises; 16-byte loads only where every base, stride
    and width allows them."""
    bf, f32 = torch.bfloat16, torch.float32
    cross = fa_ops.DECODE_MAX_NQ
    assert cross >= 1
    for dtype in (bf, f32):
        assert fa_ops.choose_tile(1, dtype) == fa_ops.DECODE
        assert fa_ops.choose_tile(cross, dtype) == fa_ops.DECODE
    assert fa_ops.choose_tile(cross + 1, bf) == fa_ops.MMA
    assert fa_ops.choose_tile(56, f32) == fa_ops.SIMT
    assert fa_ops.resolve_tile(56, bf) == fa_ops.MMA
    assert fa_ops.resolve_tile(1, f32, fa_ops.DECODE) == fa_ops.DECODE
    assert fa_ops.resolve_tile(1, bf, fa_ops.MMA) == fa_ops.MMA
    for nq, dtype, tile in ((56, f32, fa_ops.MMA), (56, bf, fa_ops.SIMT), (1, bf, 7)):
        with pytest.raises(ValueError, match="does not take"):
            fa_ops.resolve_tile(nq, dtype, tile)

    whole = torch.zeros(4, 6, 2, 64, dtype=bf)
    fused = torch.zeros(4, 6, 3 * 128, dtype=bf)[..., :128].view(4, 6, 2, 64)
    shifted = torch.zeros(4, 6, 2 * 64 + 1, dtype=bf)[..., 1:].view(4, 6, 2, 64)
    narrow = torch.zeros(4, 6, 2, 20, dtype=bf)
    assert fa_ops.loads_aligned(whole, fused, whole.float())
    assert not fa_ops.loads_aligned(whole, shifted)  # base 2 bytes off, odd strides
    assert not fa_ops.loads_aligned(narrow)          # d not a multiple of 8
