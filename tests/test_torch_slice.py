"""The slice end to end: a JAX `init_state(small_config +
model.attention_pallas_tile=16)` bridged into the PyTorch port; the port's
`infer` matches the JAX eval forward (whose Pallas attention runs in
interpret mode at every level), and the evaluator metrics of the
post-processed predictions agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.evalm import Mask3DEvaluator as JEvaluator
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.train.loop import _sb_kwargs, init_state, \
    level_capacities as j_caps
from mask3d_tpu.train.postprocess import postprocess_item as j_post
from mask3d_tpu_torch import bridge, build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.evalm import Mask3DEvaluator
from mask3d_tpu_torch.infer import level_capacities
from mask3d_tpu_torch.postprocess import postprocess_item
from tests.test_e2e import MAP_TOL, small_config
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, assert_scaled_close, \
    flax_to_numpy, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

PALLAS = ["model.attention_pallas_tile=16"]
MAP_KEYS = ("val_mean_ap", "val_mean_ap_50", "val_mean_ap_25")


@pytest.fixture(scope="module")
def ref():
    """JAX state, batch and eval outputs for aux_masks True and False."""
    cfg = j_apply(small_config(), PALLAS)
    host = JCollate(point_bucket_multiple=BUCKET)(scene_items())
    dev = host.device
    state, model, _, _ = init_state(cfg, dev)
    caps = j_caps(cfg, dev.coords.shape[1])
    assert all(c % 16 == 0 and c >= 32 for c in caps)  # Pallas everywhere

    def fwd(params, buffers, coords, counts, dims, feats, aux):
        sb = j_build(coords, counts, dims, caps,
                     **_sb_kwargs(cfg, dev.grid_dims))
        out = model.apply({"params": params, "buffers": buffers}, sb, feats,
                          coords.astype(jnp.float32), True,
                          grid_dims=dev.grid_dims, aux_masks=aux)
        return out.aux_pred_class, out.aux_pred_masks

    run = jax.jit(fwd, static_argnums=6)
    outs = {aux: [np.asarray(o) for o in run(
        state.params, state.buffers, dev.coords, dev.counts, dev.dims,
        dev.feats, aux)] for aux in (True, False)}
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    return dict(host=host, outs=outs, variables=variables)


@pytest.fixture(scope="module")
def port(ref):
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + PALLAS)
    model = bridge.load_flax(build_model(cfg, device="cpu"),
                             ref["variables"])
    host = collate(scene_items(), device="cpu", point_bucket_multiple=BUCKET)
    outs = {}
    for aux in (True, False):
        out, overflow = infer(model, host.device, cfg, aux_masks=aux,
                              device="cpu")
        assert not bool(overflow)
        outs[aux] = [out.aux_pred_class.numpy(), out.aux_pred_masks.numpy()]
    return dict(cfg=cfg, host=host, outs=outs)


def test_level_capacities_match():
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    for n in (512, 1536, 49152):
        assert level_capacities(cfg, n) == j_caps(small_config(), n)


@pytest.mark.parametrize("aux", [True, False])
def test_slice_forward_matches_jax(ref, port, aux):
    """pred_class and pred_masks (and every auxiliary output) within
    1e-4 * max(1, std(ref))."""
    (rc, rm), (gc, gm) = ref["outs"][aux], port["outs"][aux]
    n_out = 2 * 4 + 1  # num_decoders x hlevels + final
    assert gc.shape[0] == rc.shape[0] == n_out
    assert gm.shape[0] == rm.shape[0] == (n_out if aux else 1)
    assert_scaled_close(rc, gc, 1e-4, "aux_pred_class")
    assert_scaled_close(rm, gm, 1e-4, "aux_pred_masks")
    # the final prediction does not depend on aux_masks (up to the
    # run-to-run rounding of threaded CPU reductions)
    assert_scaled_close(port["outs"][True][0][-1],
                        port["outs"][False][0][-1], 1e-5, "pred_class")


def _metrics(post, evaluator, pred_class, pred_masks, host, use_dbscan):
    """Post-process and evaluate. Random weights score mAP 0 on both
    sides, so each query's mask logits are shifted by +-8 towards the
    ground-truth room (query q -> room q mod rooms); what separates the
    predictions is still the model's own logits and class scores."""
    dev = host.device
    counts = np.asarray(dev.counts)
    preds, targets = [], []
    for b in range(len(counts)):
        n = int(counts[b])
        tv = np.asarray(dev.target.valid[b])
        gt = np.asarray(dev.target.masks[b])[tv][:, :n]  # [rooms, n]
        q = pred_masks.shape[-1]
        shift = 8.0 * (2.0 * gt[np.arange(q) % len(gt)].T - 1.0)
        preds.append(post(pred_class[b], pred_masks[b, :n] + shift,
                          np.asarray(dev.coords[b, :n], np.float32),
                          host.scenes[b], use_dbscan=use_dbscan,
                          scores_threshold=0.1))
        targets.append({"labels": np.asarray(dev.target.labels[b])[tv],
                        "masks": gt})
    return evaluator().evaluate(preds, targets, "val")


@pytest.mark.parametrize("use_dbscan", [False, True])
def test_slice_metrics_match_jax(ref, port, use_dbscan):
    """The port's postprocess + evaluator on the port's predictions agree
    with the JAX package's on JAX's within MAP_TOL."""
    rc, rm = (o[-1] for o in ref["outs"][False])
    gc, gm = (o[-1] for o in port["outs"][False])
    want = _metrics(j_post, JEvaluator, rc, rm, ref["host"], use_dbscan)
    got = _metrics(postprocess_item, Mask3DEvaluator, gc, gm, port["host"],
                   use_dbscan)
    print({k: (want[k], got[k]) for k in MAP_KEYS})
    assert want["val_mean_ap_25"] > 0.0
    for key in MAP_KEYS:
        assert abs(want[key] - got[key]) <= MAP_TOL, (key, want[key],
                                                      got[key])
