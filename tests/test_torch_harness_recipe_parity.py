"""The scan recalls of ``crossover``, ``probe_fullscan`` and
``probe_kernel`` against the JAX package's on the same rows.

``tests/test_torch_harness_run.py`` holds these three harnesses' packed
scan recalls to 0.97 at a size where every row owns a bucket, and puts
what they lose down to the bf16 rounding of the shortlist's scores in
the recipe's tight clusters. Here the recipe rows are drawn twice: with
the JAX harness's own ``jax.random`` keys (``benchmarks/crossover.py``
seeded per d, ``probe_fullscan.py``, ``probe_kernel.py``) and with the
port harness's seeded ``torch.Generator`` (``_harness.clustered``), at
the harness test's size. The same numpy rows (the leaf-major matrix of
the recipe's own package's build where the harness packs one) go through
both packages' ``pack_database`` and packed scan at the harness test's
configuration, Pallas in interpret mode, the port on its plain kernel.
Recall@10 is counted against one exact answer (the JAX ``exact_knn``),
and the port's must be JAX's within 2/(q*k): one row lost or kept by one
side alone, twice over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu import exact_knn as jax_exact_knn
from vector_database_tpu.ops import pallas_knn as jpk
from vector_database_tpu_torch import build_index_fused, pack_database
from vector_database_tpu_torch import pallas_scan_knn_packed
from vector_database_tpu_torch.benchmarks import _harness as H

torch.set_num_threads(2)

K = 10

# harness test configuration: rows, width, queries drawn, queries scored,
# the recipe's seed, whether the harness packs the build's leaf-major
# matrix, pack_database and scan arguments
CASES = {
    "crossover_d2": (3000, 2, 64, 64, 34, True, {}, {}),
    "crossover_d8": (3000, 8, 64, 64, 136, True, {}, {}),
    "probe_fullscan_8192_4096": (
        3000, 96, 256, 64, 10, True, dict(block=8192, buckets=4096),
        dict(q_tile=512, oversample=4)),
    "probe_fullscan_4096_4096": (
        3000, 96, 256, 64, 10, True, dict(block=4096, buckets=4096),
        dict(q_tile=256, oversample=2)),
    "probe_kernel_int8": (
        3000, 96, 1024, 256, 0, False,
        dict(block=4096, buckets=4096, dtype="int8"), dict(q_tile=256)),
    "probe_kernel_int8f": (
        3000, 96, 1024, 256, 0, False,
        dict(block=4096, buckets=4096, dtype="int8f"), dict(q_tile=512)),
    "probe_kernel_bf16": (
        3000, 96, 1024, 256, 0, False,
        dict(block=8192, buckets=4096, dtype="bfloat16"), dict(q_tile=256)),
}


def _jax_recipe(n, d, q, seed):
    """The JAX harnesses' draw: keys ``seed`` .. ``seed + 4``."""
    key = jax.random.PRNGKey
    c = max(64, n // 1000)
    centers = jax.random.uniform(key(seed), (c, d), jnp.float32) * 2 - 1
    assign = jax.random.randint(key(seed + 1), (n,), 0, c)
    train = centers[assign] + 0.05 * jax.random.normal(
        key(seed + 2), (n, d), jnp.float32)
    test = centers[jax.random.randint(key(seed + 3), (q,), 0, c)] + \
        0.05 * jax.random.normal(key(seed + 4), (q, d), jnp.float32)
    return np.asarray(train), np.asarray(test)


def _port_recipe(n, d, q, seed):
    train, test = H.clustered(n, d, q, seed, torch.device("cpu"))
    return train.numpy(), test.numpy()


def _recall(rows, truth):
    return sum(len(set(r.tolist()) & set(t.tolist()))
               for r, t in zip(np.asarray(rows), truth)) / truth.size


@pytest.mark.parametrize("recipe", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_recall_equals_jax_on_recipe_rows(case, recipe):
    n, d, q, scored, seed, leaf_major, pack_kw, scan_kw = CASES[case]
    train, test = (_jax_recipe if recipe == "jax" else _port_recipe)(
        n, d, q, seed)
    if leaf_major:  # the harness packs its own package's build
        rows = (np.asarray(jax_build(jnp.asarray(train), leaf_size=16)
                           .vectors) if recipe == "jax" else
                build_index_fused(train, leaf_size=16, device="cpu")
                .vectors.numpy())
    else:
        rows = train
    test = test[:scored]
    truth = np.asarray(jax_exact_knn(jnp.asarray(rows), jnp.asarray(test),
                                     k=K)[0])
    jpack = jpk.pack_database(jnp.asarray(rows), **pack_kw)
    jrows = jpk.pallas_scan_knn_packed(jpack, jnp.asarray(test), k=K,
                                       **scan_kw)[0]
    tpack = pack_database(rows, device="cpu", **pack_kw)
    trows = pallas_scan_knn_packed(tpack, test, k=K, **scan_kw)[0]
    assert tpack.block == jpack.block and tpack.m == jpack.m
    jax_recall, port_recall = _recall(jrows, truth), _recall(trows, truth)
    assert abs(port_recall - jax_recall) <= 2 / (scored * K), \
        (case, recipe, port_recall, jax_recall)
