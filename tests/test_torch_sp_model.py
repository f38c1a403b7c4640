"""`model.sp_axis` on every backbone and knob, and the decoder's rows
sharded over `sp` at inference, on spawned gloo ranks (two sp ranks, one
torch thread each), against the one-process port and the JAX package.

`SpBottleneckSE` (tests/torch_dist_worker.py: Res16UNet50's bottleneck
blocks with the squeeze-excitation gate, planes 96 at the sharded levels 1
and 2 of the parity scenes) runs in fp32, with the int8 convs on dynamic
absmax scales (max-reduced over sp), and with static scales, int8_residual
(a 384-channel QGrid junction on the slabs) and pallas_chain (the unfused
blocks under sp, as JAX's gate has it):
- with the InstanceNorm stubbed to `x * occ`, against the one-process
  port: max |diff| <= IDENTITY_TOL x max(1, std) of pred_class, pred_masks
  and the backbone's stride-1 rows, in bf16 too on a narrower gated
  bottleneck (`SpBottleneckSENarrow`; the gate's mean counts the cells in
  the compute dtype on both sides, as the JAX package's `global_mean`
  does: a bf16 count above 256 rounds, and a sharded mean over the exact
  count leaves the one-process maps by whole bf16 steps);
- with the norm, against JAX's own sharded forward on a (1, 2) mesh of the
  virtual CPU devices and against the one-process port (fp32 and static
  int8), within JAX's bounds for a sharded forward
  (tests/test_parallel_sp.py:112-113). Dynamic int8 scales are held with
  the norm stubbed only: with it, the slabs' reordered norm sums move an
  absmax by an ulp, which moves every quantized input near a rounding
  boundary (0.18% of the mask logits fell outside JAX's bounds against the
  one-process port, measured; JAX's own forwards compiled at two XLA
  optimization levels differ as much, tests/test_torch_int8_bottleneck.py).
On `gather`, `gather_pallas` and `bricked` (B=1) the backbone runs whole on
every rank and only the decoder's rows shard: against the one-process port
within IDENTITY_TOL (only the softmax's combine differs), and against JAX's
unsharded forward (its gather_pallas with the Pallas conv's function in
XLA, tests/test_torch_bottleneck.py:jax_bf16_conv) within JAX's bounds.
The sharded-row decoder (Res16UNet14A, the norm stubbed) against the
one-process port: within IDENTITY_TOL; each rank's squeezed memories hold
only its chunk of each level's rows, and the rows' collectives move less
than the all-reduce of whole rows that a train-mode forward still runs.
`combine_partial_softmax` against the one-shot plain attention within
COMBINE_TOL, chunks fully masked for a query and all-padding chunks
included (the kernel's partial form on the card: tests/test_torch_card.py,
which imports no JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mask3d_tpu.config import Config as JConfig
from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.models import backbone as j_backbone
from mask3d_tpu.parallel import make_mesh_2d as j_mesh, replicate
from mask3d_tpu.sparse import pallas_conv as j_pallas_conv
from mask3d_tpu.train.loop import make_model as j_make_model
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.mask3d import build_model
from mask3d_tpu_torch.ops import masked_attention as ma
from tests import torch_dist_worker as w
from tests.test_parallel_sp import _eval_fn
from tests.test_torch_bottleneck import jax_bf16_conv
from tests.test_torch_train_step import train_scenes
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

JAX_BOUNDS = {"pred_class": dict(rtol=5e-2, atol=5e-2),
              "pred_masks": dict(rtol=5e-2, atol=2e-1)}
IDENTITY_TOL = 1e-5  # x max(1, std)
COMBINE_TOL = 1e-6  # max |diff|, f32
OUTPUTS = ("pred_class", "pred_masks", "backbone")

BN = w.SP_OVERRIDES + ["model.backbone=SpBottleneckSE"]
INT8_DYN = BN + ["model.int8_stride1=true"]
INT8_STATIC = INT8_DYN + ["model.int8_act_sigma=10.0",
                          "model.int8_residual=true",
                          "model.pallas_chain=true"]
# name -> (overrides, identity norm, scenes, items, train mode)
CASES = {
    "bn_identity": (BN, True, "parity", 2, False),
    "bn": (BN, False, "parity", 2, False),
    "bn_bf16_identity": (w.SP_OVERRIDES + [
        "model.backbone=SpBottleneckSENarrow",
        "model.compute_dtype=bfloat16"], True, "parity", 2, False),
    "int8_identity": (INT8_DYN, True, "parity", 2, False),
    "int8_static_identity": (INT8_STATIC, True, "parity", 2, False),
    "int8_static": (INT8_STATIC, False, "parity", 2, False),
    "rows": (w.SP_OVERRIDES, True, "parity", 2, False),
    # train mode: the decoder's rows whole on every rank (their all-reduce)
    "train_rows": (w.SP_OVERRIDES, False, "parity", 2, True),
    "gather": (w.SP_OVERRIDES + ["model.backbone_impl=gather"], False,
               "parity", 2, False),
    "gather_pallas": (w.SP_OVERRIDES + ["model.backbone_impl=gather_pallas"],
                      False, "parity", 2, False),
    "bricked": (w.SP_OVERRIDES + ["model.backbone_impl=bricked",
                                  "model.brick_dims=[8,8,8]",
                                  "model.brick_capacity=64"], False,
                "parity", 1, False),
}
# sharded cases held to JAX's sharded forward; the others to JAX unsharded
JAX_SHARDED = {"bn": BN, "int8_static": INT8_STATIC}
JAX_WHOLE = {"gather": 2, "gather_pallas": 2, "bricked": 1}  # -> items
# case -> (the one-process port's forward it is held to, "identity" for
# IDENTITY_TOL or "jax" for JAX's sharded bounds: a sharded norm sums its
# statistics in another order)
PORT_REF = {"bn_identity": ("bn_identity", "identity"),
            "bn_bf16_identity": ("bn_bf16_identity", "identity"),
            "int8_identity": ("int8_identity", "identity"),
            "int8_static_identity": ("int8_static_identity", "identity"),
            "gather": ("gather", "identity"),
            "gather_pallas": ("gather_pallas", "identity"),
            "bricked": ("bricked", "identity"),
            "int8_static": ("int8_static", "jax"),
            "rows": ("rows", "identity")}


def _jax_cfg(overrides):
    return j_apply(JConfig(), [o for o in overrides
                               if not o.startswith("model.sp_axis")])


def _jax_forwards(weights):
    """JAX's eval forwards on the port's seeded weights: the sharded ones
    on a (1, 2) mesh, the unsharded ones of the non-dense impls."""
    out = {}
    for name, ov in list(JAX_SHARDED.items()) + [
            (k, CASES[k][0]) for k in JAX_WHOLE]:
        n = JAX_WHOLE.get(name, 2)
        sharded = name in JAX_SHARDED
        cfg = _jax_cfg(ov + (["model.sp_axis=sp"] if sharded else []))
        batch = JCollate(point_bucket_multiple=w.SP_BUCKET)(
            train_scenes(j_make)[:n]).device
        fwd = _eval_fn(cfg, j_make_model(cfg), batch)
        params, buffers = weights[name]
        if not sharded:
            out[name] = fwd(params, buffers, batch.coords, batch.counts,
                            batch.dims, batch.feats)
            continue
        mesh = j_mesh(1, 2)
        with jax.sharding.set_mesh(mesh):
            sb = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, NamedSharding(mesh, P("dp"))),
                batch)
            out[name] = fwd(replicate(params, mesh),
                            replicate(buffers, mesh), sb.coords, sb.counts,
                            sb.dims, sb.feats)
    return {k: [np.asarray(o) for o in v] for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs and the one-process port forwards (two spawns,
    started first) and JAX's forwards, computed while they run."""
    w.register_backbones()
    tmp = tmp_path_factory.mktemp("spm")
    ranks = w.Ranks("sp_model_suite", 2, tmp, CASES)
    refs = w.Ranks("port_forwards", 1, tmp,
                   {ref: CASES[ref] for ref, _ in PORT_REF.values()})
    weights = {}
    for name in list(JAX_SHARDED) + list(JAX_WHOLE):
        v = bridge.to_flax(build_model(w.make_cfg(CASES[name][0]),
                                       device="cpu").state_dict())
        weights[name] = (jax.tree_util.tree_map(jnp.asarray, v["params"]),
                         jax.tree_util.tree_map(jnp.asarray, v["buffers"]))
    mp = pytest.MonkeyPatch()
    for name, (base, attrs) in w.TEST_BACKBONES.items():
        # annotated, so that Flax's dataclass takes them as field defaults
        mp.setitem(j_backbone.BACKBONES, name, type(
            name, (j_backbone.BACKBONES[base],),
            dict(attrs, __annotations__={k: type(v) for k, v in
                                         attrs.items()})))
    mp.setattr(j_pallas_conv, "sparse_conv_pallas", jax_bf16_conv)
    try:
        jax_out = _jax_forwards(weights)
    finally:
        mp.undo()
    return {"sp": ranks.results(), "ref": refs.results()[0],
            "jax": jax_out}


def _scaled(ref, got):
    return float(np.abs(got - ref).max()) / max(1.0, float(ref.std()))


@pytest.mark.parametrize("case", sorted(PORT_REF))
def test_sp_forward_matches_one_process_port(runs, case):
    """Identity-norm cases and the impls whose backbone runs whole: every
    output within IDENTITY_TOL; the dense cases with the norm within JAX's
    sharded bounds."""
    name, tol = PORT_REF[case]
    ref = runs["ref"][name]
    for rank, r in enumerate(runs["sp"]):
        got = r[case]
        for i, out in enumerate(OUTPUTS):
            if tol == "jax" and out != "backbone":
                np.testing.assert_allclose(got[i], ref[i], **JAX_BOUNDS[out])
            elif tol == "identity":
                err = _scaled(ref[i], got[i])
                assert err <= IDENTITY_TOL, (case, rank, out, err)


@pytest.mark.parametrize("case", sorted(JAX_SHARDED) + sorted(JAX_WHOLE))
def test_sp_forward_within_jax_bounds(runs, case):
    """Against JAX's sharded forward (the bottleneck with the gate, fp32
    and dynamic int8) or its unsharded one (the non-dense impls)."""
    for r in runs["sp"]:
        for i, out in enumerate(OUTPUTS[:2]):
            np.testing.assert_allclose(r[case][i], runs["jax"][case][i],
                                       **JAX_BOUNDS[out])


def test_sharded_rows_match_whole_rows_and_hold_chunks(runs):
    """The decoder over row chunks on two ranks (Res16UNet14A, the norm
    stubbed) against the one-process port's whole rows: outputs within
    IDENTITY_TOL, and each rank's squeezed memories take only its chunk
    of their level's rows (rank 0 the first ceil(N / 2), rank 1 the
    rest)."""
    whole = runs["ref"]["rows"]
    for rank, r in enumerate(runs["sp"]):
        got = r["rows"]
        for i, out in enumerate(OUTPUTS):
            err = _scaled(whole[i], got[i])
            assert err <= IDENTITY_TOL, (rank, out, err)
        squeezed = {k: n for k, n in whole[3]["rows"].items()
                    if k.startswith("squeeze")}
        assert squeezed
        for key, n in squeezed.items():
            half = -(-n // 2)
            assert got[3]["rows"][key] == (half if rank == 0 else n - half)


DECODER_ROWS = ("rows", "attention_partials", "minmax", "unblock",
                "out_masks", "np_features")


def test_sharded_rows_move_fewer_bytes_than_the_all_reduce(runs):
    """The decoder's row collectives (`comm.BYTES`, this rank's payload:
    the chunks its reduce-scatter sends, its softmax partials, min/max and
    any reductions, its chunk of the output masks) against the
    all-reduce of whole rows, which a train-mode forward of the same model
    still runs; on `gather` the backbone runs whole, so no rows move from
    slabs."""
    for r in runs["sp"]:
        whole = r["train_rows"][3]["bytes"]
        sharded = r["rows"][3]["bytes"]
        assert "attention_partials" not in whole and whole["rows"] > 0
        assert sharded["attention_partials"] > 0
        moved = sum(sharded.get(k, 0) for k in DECODER_ROWS)
        assert moved < whole["rows"], (moved, whole["rows"])
        gather = r["gather"][3]["bytes"]
        assert "rows" not in gather and gather["attention_partials"] > 0


def _attention_case(seed=0, b=2, nq=5, d=32, s=40):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float32)
               for shape in ((b, nq, d), (b, s, d), (b, s, d)))
    mask = torch.tensor(rng.random((b, nq, s)) < 0.5)
    mask[0, 1, :] = True  # a query blocked on every key
    mask[1, 2, :20] = True  # a query blocked on the first chunk
    mask[:, :, 30:] = True  # padding rows
    return q, k, v, mask


@pytest.mark.parametrize("bounds", [(0, 20, 40), (0, 10, 30, 40),
                                    (0, 0, 40), (0, 13, 26, 39, 40),
                                    (0, 30, 40)])
def test_combine_partial_softmax_matches_one_shot(bounds):
    """The ranks' partial triples combined against the one-shot softmax:
    an empty chunk, a chunk all padding, a query blocked on a whole chunk
    and one blocked everywhere (uniform weights in both)."""
    q, k, v, mask = _attention_case()
    ref = ma.masked_cross_attention_plain(q, k, v, mask, 4)
    parts = [ma.masked_cross_attention_partial(q, k[:, a:b], v[:, a:b],
                                               mask[:, :, a:b], 4)
             for a, b in zip(bounds[:-1], bounds[1:])]
    got = ma.combine_partial_softmax(*zip(*parts), 4)
    assert float((got - ref).abs().max()) <= COMBINE_TOL


def test_combine_needs_every_rank_s_max():
    """A combine that reads one rank's max for every rank (the planted
    fault chip_smoke.py runs) misses the one-shot softmax."""
    q, k, v, mask = _attention_case(1)
    ref = ma.masked_cross_attention_plain(q, k, v, mask, 4)
    parts = [ma.masked_cross_attention_partial(q, k[:, a:b], v[:, a:b],
                                               mask[:, :, a:b], 4)
             for a, b in ((0, 20), (20, 40))]
    outs, maxes, sums = zip(*parts)
    bad = ma.combine_partial_softmax(outs, [maxes[0]] * 2, sums, 4)
    assert float((bad - ref).abs().max()) > 1e-2
