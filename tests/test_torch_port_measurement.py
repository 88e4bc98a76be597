"""What the port's measurements count, on the CPU: ``chip_smoke.py``'s bound
of ``fused_attention`` counts only the keys that its masks leave visible,
and the measurement builds of ``csrc/layer_step.cu`` (``-D`` flags through
``ops/cuda_build.py``) are libraries of their own, apart from the port's."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from openviic_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(B=3, nq=4, nk=10, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, h, d), dtype=np.float32))
               .to(torch.bfloat16) for n in (nq, nk, nk))
    return q, k, v


@pytest.mark.parametrize("bias_shape", [(3, 1, 1, 10), (3, 2, 4, 10)])
def test_attention_bound_counts_only_seen_keys(chip_smoke, bias_shape):
    """Keys masked for every query of their (batch, head) are not read;
    a fully masked row reads every key; the bytes and the (query, key)
    pairs follow."""
    q, k, v = _inputs()
    B, nq, h, d = q.shape
    nk = k.shape[1]
    open_bias = torch.zeros(bias_shape)
    *_, flops_open, bytes_open, seen_open = chip_smoke.attention_bound(q, k, v, open_bias)
    assert seen_open == 1.0
    assert flops_open == 2.0 * B * h * nq * nk * d

    masked = torch.zeros(bias_shape)
    masked[..., nk // 2:] = -1e30  # half of the keys hidden from every query
    *_, flops_half, bytes_half, seen_half = chip_smoke.attention_bound(q, k, v, masked)
    assert seen_half == 0.5
    assert flops_half == flops_open / 2
    kv_bytes = B * h * nk * 2 * d * q.element_size()
    assert bytes_open - bytes_half == kv_bytes / 2

    masked[0] = -1e30  # batch 0: every row fully masked, so it reads every key
    *_, flops_dead, bytes_dead, seen_dead = chip_smoke.attention_bound(q, k, v, masked)
    assert bytes_dead - bytes_half == kv_bytes / B / 2
    assert flops_dead == flops_half + flops_open / B / 2
    assert seen_dead == pytest.approx(0.5 + 0.5 / B)


def test_measurement_builds_are_libraries_of_their_own():
    """A ``-D`` flag names another library, so a measurement build never
    replaces the port's; the port's own path is the one without flags."""
    plain = cuda_build.library_path("layer_step")
    phases = cuda_build.library_path("layer_step", ("-DOPENVIIC_PHASES",))
    cluster1 = cuda_build.library_path("layer_step", ("-DOPENVIIC_RESIDENT_CLUSTER=1",))
    assert len({plain, phases, cluster1}) == 3
    assert plain == cuda_build.library_path("layer_step", ())
    assert all(p.parent == cuda_build.BUILD_DIR for p in (plain, phases, cluster1))
    source = (cuda_build.CSRC_DIR / "layer_step.cu").read_text()
    for define in ("OPENVIIC_PHASES", "OPENVIIC_RESIDENT_CLUSTER"):
        assert f"#ifdef {define}" in source
