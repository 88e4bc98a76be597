"""The port's fused head + lse + top-k (``openviic_tpu_torch/ops/head_topk.py``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``.

Tolerances: values within one bf16 ulp and lse within 1e-4, since both
sides sum the same bf16 products in f32 but in different orders; ids are
equal wherever the top k+1 values have no gap of one ulp or less (a
near-tie that the two summation orders may round either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.ops.head_topk import head_topk as jax_head_topk
from openviic_tpu_torch.ops import head_topk as port_ops
from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(v)
    return np.ldexp(np.ones_like(v), exponent - 8)


def _inputs(n, d, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(d, v)) / np.sqrt(d)).astype(np.float32)  # JAX (D, V)
    return x, w


def _compare(x, w, k, exact=False):
    jv, ji, jl = (np.asarray(a) for a in jax_head_topk(jnp.asarray(x), jnp.asarray(w), k=k, tile=256))
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))
    pv, pi, pl = (a.numpy() for a in head_topk(xt, wt, k))
    rv = head_topk_reference(xt, wt, k + 1)[0].numpy()  # one more, for the near-tie rule
    assert pv.dtype == np.float32 and pi.dtype == np.int32 and pl.dtype == np.float32
    assert pv.shape == pi.shape == (x.shape[0], k) and pl.shape == (x.shape[0],)
    assert (np.abs(pv - jv) <= _bf16_ulp(jv)).all()
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    if exact:  # every product and f32 sum exact: no near-tie exclusion
        np.testing.assert_array_equal(pi, ji)
    else:
        gaps = rv[:, :-1] - rv[:, 1:]
        clear = ~(gaps <= _bf16_ulp(rv[:, :-1])).any(axis=1)
        assert clear.sum() > 0
        np.testing.assert_array_equal(pi[clear], ji[clear])
    return pv, pi, jv, ji


@pytest.mark.parametrize(
    "n,d,v,k", [(40, 64, 777, 5), (37, 32, 300, 3), (16, 64, 1000, 1), (8, 16, 50, 16)]
)
def test_reference_matches_jax_head_topk(n, d, v, k):
    _compare(*_inputs(n, d, v, seed=n + v), k)


def test_ties_resolve_to_the_lowest_id():
    """Duplicated head columns give exactly equal logits: the lower id comes
    first, as in the JAX kernel's first-index argmax."""
    rng = np.random.default_rng(7)
    # small-integer inputs make every product and f32 sum exact
    x = (rng.integers(-8, 9, size=(24, 32)) / 8).astype(np.float32)
    w = (rng.integers(-8, 9, size=(32, 400)) / 64).astype(np.float32)
    top = np.asarray(jax_head_topk(jnp.asarray(x), jnp.asarray(w), k=1, tile=256)[1])[:, 0]
    for orig in np.unique(top):
        w[:, (orig + 200) % 400] = w[:, orig]
    pv, pi, jv, ji = _compare(x, w, 5, exact=True)
    tied = pv[:, 0] == pv[:, 1]
    assert tied.any() and (pi[tied, 0] < pi[tied, 1]).all()


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    x, w = _inputs(12, 16, 90, seed=1)
    before = head_topk.launches
    got = head_topk(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), 4)
    want = head_topk_reference(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), 4)
    assert head_topk.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_rejects_cpu_or_mixed_devices():
    bf = torch.bfloat16
    with pytest.raises(ValueError):
        port_ops._check(torch.zeros(4, 16, dtype=bf), torch.zeros(32, 16, dtype=bf), 2)


def test_kernel_checks_reject_bad_shapes_dtypes_and_k():
    """The operand checks that guard the CUDA launch: dtype, shape,
    contiguity, D % 8, alignment and k."""
    bf = torch.bfloat16
    check = port_ops._check_operands
    good_x, good_w = torch.zeros(4, 16, dtype=bf), torch.zeros(32, 16, dtype=bf)
    check(good_x, good_w, 5)  # accepted
    with pytest.raises(TypeError):
        check(good_x.float(), good_w, 5)
    with pytest.raises(ValueError):
        check(good_x, torch.zeros(32, 8, dtype=bf), 5)  # D mismatch
    with pytest.raises(ValueError):
        check(torch.zeros(16, 4, dtype=bf).T, good_w, 5)  # not contiguous
    with pytest.raises(ValueError):
        check(torch.zeros(4, 12, dtype=bf), torch.zeros(32, 12, dtype=bf), 5)  # D % 8
    with pytest.raises(ValueError):
        check(torch.zeros(65, dtype=bf)[1:].view(4, 16), good_w, 5)  # 2-byte offset
    with pytest.raises(ValueError):
        check(good_x, good_w, 17)  # k above the kernel's maximum
    with pytest.raises(ValueError):
        check(good_x, torch.zeros(3, 16, dtype=bf), 5)  # k > V
