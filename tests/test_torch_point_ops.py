"""The port's standalone point ops (`ops/segment.py`, `ops/knn.py`,
`ops/point_attention.py`) against the JAX package's on the same numpy
inputs: float results within 1e-5 of max(1, max |ref|), indices and masks
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.ops import knn as J_knn
from mask3d_tpu.ops import point_attention as J_pa
from mask3d_tpu.ops import segment as J_seg
from mask3d_tpu_torch import ops as t_ops
from mask3d_tpu_torch.ops import knn as T_knn
from mask3d_tpu_torch.ops import point_attention as T_pa
from mask3d_tpu_torch.ops import segment as T_seg
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

TOL = 1e-5


def close(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("reduce", ["mean", "max", "min"])
def test_segment_reductions_match_jax(reduce):
    """Per segment, ids out of range (negative or past the last) dropped,
    an empty segment 0; the batched form with padding rows."""
    rng = np.random.default_rng(0)
    values = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(-2, 9, 50).astype(np.int32)  # segment 7 may be empty
    fn = {"mean": "segment_mean", "max": "segment_max",
          "min": "segment_min"}[reduce]
    close(getattr(J_seg, fn)(values, ids, 8),
          getattr(T_seg, fn)(t(values), t(ids), 8))
    bvals = rng.normal(size=(3, 40, 4)).astype(np.float32)
    bids = rng.integers(0, 5, (3, 40)).astype(np.int32)
    valid = rng.random((3, 40)) < 0.8
    close(J_seg.batched_segment_reduce(bvals, bids, valid, 6, reduce),
          t_ops.batched_segment_reduce(t(bvals), t(bids), t(valid), 6,
                                       reduce))


def _points(rng, b=2, n=30, q=7):
    points = rng.normal(size=(b, n, 3)).astype(np.float32)
    query = rng.normal(size=(b, q, 3)).astype(np.float32)
    valid = rng.random((b, n)) < 0.7
    valid[1, 3:] = False  # an item with fewer valid points than k
    return points, query, valid


def test_knn_ball_query_and_interpolation_match_jax():
    rng = np.random.default_rng(1)
    points, query, valid = _points(rng)
    close(J_knn.pairwise_sqdist(query, points),
          T_knn.pairwise_sqdist(t(query), t(points)))
    j_idx, j_d = J_knn.knn(query, points, valid, 5)
    t_idx, t_d = T_knn.knn(t(query), t(points), t(valid), 5)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_d, t_d = np.asarray(j_d), t_d.numpy()
    np.testing.assert_array_equal(np.isinf(t_d), np.isinf(j_d))
    fin = np.isfinite(j_d)
    close(j_d[fin], t_d[fin])
    j_idx, j_ok = J_knn.ball_query(query, points, valid, 1.0, 6)
    t_idx, t_ok = T_knn.ball_query(t(query), t(points), t(valid), 1.0, 6)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    feats = rng.normal(size=(2, 30, 4)).astype(np.float32)
    close(J_knn.group_points(feats, j_idx),
          T_knn.group_points(t(feats), t_idx))
    close(J_knn.three_interpolate(query, points, valid, feats),
          T_knn.three_interpolate(t(query), t(points), t(valid), t(feats)))


def test_point_attention_matches_jax():
    """The edge-list attention steps, the RPE lookups and the vector
    aggregation, padding edges masked, one destination out of range."""
    rng = np.random.default_rng(2)
    n, h, c, m, length = 12, 2, 4, 40, 5
    q, k, v = (rng.normal(size=(n, h, c)).astype(np.float32)
               for _ in range(3))
    index0 = rng.integers(0, n, m).astype(np.int32)
    index0[0] = n  # dropped by the aggregation
    index1 = rng.integers(0, n, m).astype(np.int32)
    edge_ok = rng.random(m) < 0.8
    table = rng.normal(size=(length, h, c, 3)).astype(np.float32)
    rel = rng.integers(0, length, (m, 3)).astype(np.int32)
    index0_in = np.minimum(index0, n - 1)  # gathers take in-range rows
    attn_j = J_pa.attention_step1(q, k, index0_in, index1, edge_ok)
    attn_t = T_pa.attention_step1(t(q), t(k), t(index0_in), t(index1),
                                  t(edge_ok))
    close(attn_j, attn_t)
    close(J_pa.attention_step2(np.asarray(attn_j), v, index0, index1, n,
                               edge_ok),
          t_ops.attention_step2(attn_t, t(v), t(index0), t(index1), n,
                                t(edge_ok)))
    close(J_pa.rpe_table_lookup(table, rel),
          T_pa.rpe_table_lookup(t(table), t(rel)))
    close(J_pa.dot_prod_with_idx(q, index0_in, table, rel, edge_ok),
          t_ops.dot_prod_with_idx(t(q), t(index0_in), t(table), t(rel),
                                  t(edge_ok)))
    close(J_pa.attention_step2_with_rel_pos_value(
        np.asarray(attn_j), v, index0, index1, table, rel, n, edge_ok),
        t_ops.attention_step2_with_rel_pos_value(
            attn_t, t(v), t(index0), t(index1), t(table), t(rel), n,
            t(edge_ok)))
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    position = rng.normal(size=(n, 3, 8)).astype(np.float32)
    weight = rng.normal(size=(n, 3, 2)).astype(np.float32)
    idx = rng.integers(0, n, (n, 3)).astype(np.int32)
    close(J_pa.aggregation(jnp.asarray(feats), position, weight, idx),
          t_ops.aggregation(t(feats), t(position), t(weight), t(idx)))
