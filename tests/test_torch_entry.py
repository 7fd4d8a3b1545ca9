"""The port's entry points (``vector_database_tpu_torch/entry.py``) against
``__graft_entry__.py``.

``entry()``'s forward is held to JAX's forward step on the same data: the
lockstep walk, the exact rerank and ``lax.top_k`` over the built index,
with a leaf buffer wide enough for every leaf. JAX's own ``entry()`` keeps
a fixed buffer of 256 leaves, which every query of its batch overflows
(the walk keeps the first 256 leaves it reaches), so its answers are the
best of a subset; the port's forward grows its buffer as ``search`` does
and answers exactly (ROADMAP §3 records the deviation). Distances agree
within rtol 1e-5, atol 1e-6, and ids wherever the k-th distance is not
tied. ``dryrun_multichip(4)`` spawns four Gloo ranks and completes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as jax_entry
from vector_database_tpu import build_index_fused as jax_build_fused
from vector_database_tpu.search import _rerank, _traverse
from vector_database_tpu.utils import datasets
from vector_database_tpu_torch import exact_ball, exact_knn
from vector_database_tpu_torch.entry import (
    K,
    MAX_LEAVES,
    RADIUS,
    dryrun_multichip,
    entry,
)

torch.set_num_threads(2)


def _jax_forward_every_leaf(queries):
    """JAX's forward step (``__graft_entry__.entry``) with a leaf buffer of
    every leaf."""
    index = jax_build_fused(datasets.random_uniform(4096, 32, seed=0),
                            leaf_size=8)
    q = jnp.asarray(queries)
    leaves, _, ov = _traverse(index.dim, index.mid, index.low, index.high, q,
                              jnp.float32(RADIUS),
                              max_leaves=index.num_leaves,
                              max_stack=index.depth + 2)
    assert not bool(ov.any())
    rows, d2, _, _, _ = _rerank(index.leaf_start, index.leaf_count,
                                index.vectors, index.orig_row, leaves, q,
                                jnp.float32(RADIUS), leaf_cap=index.leaf_cap)
    neg, pos = jax.lax.top_k(-d2, K)
    return np.asarray(jnp.take_along_axis(rows, pos, axis=1)), \
        np.asarray(-neg)


def test_entry_forward_equals_jax_forward():
    forward, (queries,) = entry(device="cpu")
    assert queries.device.type == "cpu" and tuple(queries.shape) == (256, 32)
    rows, d2 = (x.numpy() for x in forward(queries))
    assert rows.shape == d2.shape == (256, K)
    jrows, jd2 = _jax_forward_every_leaf(queries.numpy())
    np.testing.assert_allclose(d2, jd2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(d2), np.isfinite(jd2))
    np.testing.assert_array_equal(rows[~np.isfinite(d2)], -1)
    for i in range(rows.shape[0]):
        fin = np.isfinite(jd2[i])
        if not fin.any():
            continue
        kth = jd2[i][fin].max()
        inner = jd2[i] < kth - 1e-5 * kth
        assert set(rows[i][inner].tolist()) == set(jrows[i][inner].tolist())


def test_entry_forward_is_exact_where_the_ball_holds_k_rows():
    forward, (queries,) = entry(device="cpu")
    rows, _ = forward(queries)
    v = torch.from_numpy(datasets.random_uniform(4096, 32, seed=0))
    full = exact_ball(v, queries, RADIUS).sum(dim=1) >= K
    erows, _ = exact_knn(v, queries, k=K)
    assert int(full.sum()) > 50
    for i in torch.nonzero(full)[:, 0].tolist():
        assert set(rows[i].tolist()) == set(erows[i].tolist())


def test_jax_entry_overflows_its_fixed_buffer():
    """The recorded deviation: JAX's forward keeps 256 leaves, fewer than
    every query reaches."""
    fn, (queries,) = jax_entry.entry()
    index = jax_build_fused(datasets.random_uniform(4096, 32, seed=0),
                            leaf_size=8)
    _, _, ov = _traverse(index.dim, index.mid, index.low, index.high,
                         queries, jnp.float32(RADIUS), max_leaves=MAX_LEAVES,
                         max_stack=index.depth + 2)
    assert bool(np.asarray(ov).all())


def test_dryrun_multichip_four_ranks():
    dryrun_multichip(4)
