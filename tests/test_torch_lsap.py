"""The device LSAP against the JAX package's: the port's
`linear_sum_assignment(method="device")` (on the CPU its plain
Jonker-Volgenant, vectorised over the problems) equals JAX's `device`
solver bit for bit, ties included; on a tied cost where scipy (`host`)
picks other columns, the port's default criterion now matches JAX's
default one; and the CUDA kernel equals the plain version on the card.

The JAX package is imported inside the tests: the card's machine runs the
`cuda`-marked test of this file without flax."""

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import cuda_build
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.ops import lsap
from mask3d_tpu_torch.train.criterion import SetCriterion, make_criterion

# A cost on which scipy and JAX's Jonker-Volgenant solver pick different
# real columns for rows 1 and 4 (several optima of total 2), found by a
# seeded search (numpy default_rng(36), integers in [0, 3) of 6 x 4).
TIED_COST = np.array([[1, 0, 1, 1], [1, 2, 2, 1], [2, 2, 1, 1],
                      [2, 1, 1, 2], [0, 0, 0, 0], [2, 0, 0, 1]], np.float32)
TIED_DEVICE = [1, 4, 3, 5, 0, 2]  # JAX's device assignment
TIED_HOST = [1, 0, 4, 5, 3, 2]  # scipy's


def jax_lsap(cost, method="device"):
    import jax.numpy as jnp

    from mask3d_tpu.ops.lsap import linear_sum_assignment

    return np.asarray(linear_sum_assignment(jnp.asarray(cost),
                                            method=method))


def port_lsap(cost, method="device"):
    out = lsap.linear_sum_assignment(torch.from_numpy(cost), method)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (5, 1), (3, 3), (8, 8),
                                   (25, 8), (8, 25), (20, 20), (100, 32)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_device_matches_jax_on_random_costs(shape):
    """Random normal costs in batches of 3 x 2 problems, rectangular both
    ways: every column equal to JAX's, the padding columns included."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    cost = rng.normal(size=(3, 2) + shape).astype(np.float32)
    np.testing.assert_array_equal(port_lsap(cost), jax_lsap(cost))


def _tied(kind, shape, rng):
    r, c = shape
    if kind == "small_integers":
        return rng.integers(0, 3, size=(4, 3, r, c)).astype(np.float32)
    cost = rng.normal(size=(4, 3, r, c)).astype(np.float32)
    if kind == "constant_columns":  # padded instances, as the criterion
        cost[..., c // 2:] = 1e4
    elif kind == "duplicated_rows":  # identical queries
        cost[..., 1::2, :] = cost[..., 0:1, :]
    elif kind == "all_equal":
        cost[:] = 0.5
    return cost


@pytest.mark.parametrize("shape", [(25, 8), (8, 25), (20, 20)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["small_integers", "constant_columns",
                                  "duplicated_rows", "all_equal"])
def test_device_matches_jax_on_ties(kind, shape):
    """Where the optimum is not unique the port breaks the ties as JAX
    does: the same assignment, bit for bit."""
    cost = _tied(kind, shape, np.random.default_rng(len(kind)))
    np.testing.assert_array_equal(port_lsap(cost), jax_lsap(cost))


def test_tied_fixture_host_and_device_differ():
    """The fixture: scipy and JAX's device solver pick different real
    columns; the port's methods reproduce JAX's own, each to the column."""
    want_dev, want_host = jax_lsap(TIED_COST), jax_lsap(TIED_COST, "host")
    np.testing.assert_array_equal(want_dev, TIED_DEVICE)
    np.testing.assert_array_equal(want_host, TIED_HOST)
    np.testing.assert_array_equal(port_lsap(TIED_COST), TIED_DEVICE)
    np.testing.assert_array_equal(port_lsap(TIED_COST, "host"), TIED_HOST)
    real = (np.array(TIED_DEVICE) < 4) | (np.array(TIED_HOST) < 4)
    assert (np.array(TIED_DEVICE) != np.array(TIED_HOST))[real].any()
    with pytest.raises(ValueError, match="method"):
        lsap.linear_sum_assignment(torch.from_numpy(TIED_COST), "auction")


def _tied_criterion_inputs(seed=1, n_levels=3, b=2, n=60, q=6, n_inst=4,
                           n_cls=3):
    """Criterion inputs whose queries come in identical pairs, as an
    untrained model's do, so the matching costs tie."""
    rng = np.random.default_rng(seed)
    counts = np.array([n, n - 17])[:b]
    pv = np.arange(n)[None] < counts[:, None]
    valid = np.zeros((b, n_inst), bool)
    valid[0, :3] = True
    valid[1, :2] = True
    labels = np.where(valid, rng.integers(0, n_cls, (b, n_inst)),
                      0).astype(np.int32)
    masks = (rng.random((b, n_inst, n)) < 0.3) & valid[..., None] \
        & pv[:, None]
    pc = rng.normal(size=(n_levels, b, q, n_cls + 1)).astype(np.float32)
    pm = (3 * rng.normal(size=(n_levels, b, n, q))).astype(np.float32)
    pc[:, :, 1::2] = pc[:, :, 0::2]
    pm[..., 1::2] = pm[..., 0::2]
    tgt = dict(labels=labels, masks=masks, valid=valid,
               point_instance_ids=np.zeros((b, n), np.int32))
    return pc, pm, tgt, pv


def test_default_criterion_matches_jax_default_on_ties():
    """The fault this repairs: the port's criterion matched on the host
    whatever `matcher.lsap_method` said. On the tied fixture the port's
    default criterion now matches as JAX's default criterion does (its
    `linear_sum_assignment(cost, method=lsap_method)` and the same
    `matched` rule), and with `host` as scipy does; on tied criterion
    inputs the default losses equal JAX's default ones. (Which of two
    identical queries takes a gradient still rests on the costs' last
    bits, which the two frameworks' sums round differently.)"""
    import jax.numpy as jnp

    from mask3d_tpu.data.batch import Targets as JTargets
    from mask3d_tpu.models.mask3d import Mask3DOutput as JOutput
    from mask3d_tpu.train.criterion import SetCriterion as JCriterion
    from mask3d_tpu_torch.data.batch import Targets
    from mask3d_tpu_torch.models.mask3d import Mask3DOutput

    j_crit = JCriterion(num_classes=3)
    assert j_crit.lsap_method == "device"
    valid = np.array([[True, True, True, False]])
    want = jax_lsap(TIED_COST[None], j_crit.lsap_method)
    targets = Targets(labels=torch.zeros(1, 4, dtype=torch.int32),
                      masks=torch.zeros(1, 4, 5, dtype=torch.bool),
                      valid=torch.from_numpy(valid),
                      point_instance_ids=torch.zeros(1, 5,
                                                     dtype=torch.int32))
    cost = torch.from_numpy(TIED_COST)[None, None]
    for crit, ref in ((SetCriterion(num_classes=3), want),
                      (SetCriterion(num_classes=3, lsap_method="host"),
                       np.array([TIED_HOST]))):
        cols, matched = crit.match(cost, targets)
        in_range = ref < 4
        np.testing.assert_array_equal(cols[0].numpy(),
                                      np.where(in_range, ref, 0))
        np.testing.assert_array_equal(
            matched[0].numpy(),
            in_range & np.take_along_axis(valid, np.where(in_range, ref, 0),
                                          -1))
    assert not np.array_equal(want, [TIED_HOST])

    pc, pm, tgt, pv = _tied_criterion_inputs()
    ref = j_crit(JOutput(aux_pred_class=jnp.asarray(pc),
                         aux_pred_masks=jnp.asarray(pm),
                         sampled_coords=None, backbone_feats=None),
                 JTargets(**{k: jnp.asarray(v) for k, v in tgt.items()}),
                 jnp.asarray(pv))
    got = SetCriterion(num_classes=3)(
        Mask3DOutput(aux_pred_class=torch.from_numpy(pc),
                     aux_pred_masks=torch.from_numpy(pm)),
        Targets(**{k: torch.from_numpy(v) for k, v in tgt.items()}),
        torch.from_numpy(pv))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_make_criterion_honours_lsap_method():
    assert make_criterion(Config()).lsap_method == "device"
    cfg = apply_overrides(Config(), ["matcher.lsap_method=host"])
    assert make_criterion(cfg).lsap_method == "host"
    from mask3d_tpu_torch.baseline.criterion2d import RoomFormerCriterion

    assert RoomFormerCriterion().lsap_method == "device"


def test_plain_versions_take_the_plain_solver_on_cpu():
    """A CPU tensor takes the plain version and counts no launch."""
    before = lsap.linear_sum_assignment.launches
    cost = _tied("duplicated_rows", (25, 8), np.random.default_rng(0))
    got = lsap.linear_sum_assignment(torch.from_numpy(cost))
    assert lsap.linear_sum_assignment.launches == before
    sq = lsap.pad_square(torch.from_numpy(cost))
    assert sq.shape == (12, 25, 25)
    assert torch.equal(sq[:, :, :8], torch.from_numpy(cost).reshape(-1, 25, 8))
    assert bool((sq[:, :, 8:] == sq[:, :, :8].amax(dim=(1, 2))[:, None, None]
                 + 1.0).all())
    assert torch.equal(got.reshape(-1, 25), lsap.solve_square_plain(sq))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The kernel at the criteria's shapes (13 x 8 problems of 25 x 8 and
    100 x 32, RoomFormer's 6 x 8 of 20 x 20) and on the tied fixtures:
    every assignment equal to the plain version's, a second launch bitwise
    equal, one launch a call; n above 1024 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    rng = np.random.default_rng(0)
    cases = [rng.normal(size=(13, 8, 25, 8)),
             rng.normal(size=(13, 8, 100, 32)),
             rng.normal(size=(6, 8, 20, 20)), TIED_COST[None]]
    cases += [_tied(k, (25, 8), rng) for k in (
        "small_integers", "constant_columns", "duplicated_rows",
        "all_equal")]
    for cost in cases:
        x = torch.from_numpy(np.asarray(cost, np.float32)).cuda()
        before = lsap.linear_sum_assignment.launches
        a = lsap.linear_sum_assignment(x)
        b = lsap.linear_sum_assignment(x)
        with cuda_build.plain_versions():
            p = lsap.linear_sum_assignment(x)
        torch.cuda.synchronize()
        assert lsap.linear_sum_assignment.launches == before + 2
        assert torch.equal(a, b) and torch.equal(a, p), cost.shape
    np.testing.assert_array_equal(
        lsap.linear_sum_assignment(torch.from_numpy(TIED_COST).cuda())
        .cpu().numpy(), TIED_DEVICE)
    with pytest.raises(ValueError, match="1024"):
        lsap.solve_square(torch.zeros(1, 1025, 1025, device="cuda"))
