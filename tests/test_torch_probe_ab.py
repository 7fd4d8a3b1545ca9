"""The port's A/B scan probe against the TPU probe of
``benchmarks/probe_kernel_ab.py``, run in Pallas interpret mode.

Inputs are small integers (bf16 blocks and queries in [-2, 2], f32 norms
in [0, 8]): every product and sum is exact in f32, so the int32
accumulators must be bitwise equal. The TPU probe fixes its block shape
(block 8192, m 2048, q_tile 256) and ``bits = 12``; two blocks make
``nb*w = 8`` ids, which 12 bits hold.
"""

import functools
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vector_database_tpu_torch.benchmarks import probe_kernel_ab as tab

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_probe():
    """The TPU probe module; it reads ``sys.argv[1]`` at import."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_kernel_ab", REPO / "benchmarks" / "probe_kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["probe_kernel_ab.py"]):
        spec.loader.exec_module(mod)
    return mod


def _int_inputs(seed, nb=2, q=256, d_pad=128, block=8192):
    rng = np.random.default_rng(seed)
    vb = rng.integers(-2, 3, (nb, d_pad, block)).astype(np.float32)
    vn = rng.integers(0, 9, (nb, 1, block)).astype(np.float32)
    qb = rng.integers(-2, 3, (q, d_pad)).astype(np.float32)
    qn = rng.integers(0, 9, (q, 1)).astype(np.float32)
    return vb, vn, qb, qn


@pytest.mark.parametrize("mode", tab.MODES)
def test_plain_probe_matches_jax_probe(jax_probe, mode):
    vb, vn, qb, qn = _int_inputs(7)
    interp = functools.partial(pl.pallas_call, interpret=True)
    with mock.patch.object(jax_probe.pl, "pallas_call", interp):
        want = np.asarray(jax_probe.run(
            mode, jnp.asarray(vb, jnp.bfloat16), jnp.asarray(vn),
            jnp.asarray(qb, jnp.bfloat16), jnp.asarray(qn)))
    got = tab.probe_kernel_ab(
        mode, torch.from_numpy(vn), torch.from_numpy(vb).bfloat16(),
        torch.from_numpy(qb).bfloat16(), torch.from_numpy(qn),
        m=jax_probe.m, bits=jax_probe.bits,
    )
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))


def test_id_bits_hold_every_block_slice_id():
    """At 10M rows the TPU probe's 12 bits are too few (1221 * 4 ids)."""
    nb = -(-10_000_000 // tab.BLOCK)
    w = tab.BLOCK // tab.M
    assert nb * w - 1 > 2 ** 12 - 1
    assert tab.id_bits(nb, w) == 13
    assert tab.id_bits(2, 4) == 3 and tab.id_bits(1, 1) == 1


def test_probe_uses_plain_version_only_on_cpu():
    vn, vb, qb, qn = tab.make_inputs(2 * 256, q=16, device="cpu")
    vb, vn = vb[:, :, :256].contiguous(), vn[:, :, :256].contiguous()
    before = tab.probe_kernel_ab.LAUNCHES
    out = tab.probe_kernel_ab("full", vn, vb, qb, qn, m=128, bits=3)
    assert out.shape == (16, 128) and out.dtype == torch.int32
    assert tab.probe_kernel_ab.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel"):
        tab.probe_kernel_ab("full", vn.to("meta"), vb.to("meta"),
                            qb.to("meta"), qn.to("meta"), m=128, bits=3)
    with pytest.raises(ValueError, match="unknown mode"):
        tab.probe_kernel_ab("fast", vn, vb, qb, qn, m=128, bits=3)
