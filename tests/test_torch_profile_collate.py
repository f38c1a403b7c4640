"""The port's host-collation profiler (`mask3d_tpu_torch/profile_collate.py`)
against the JAX package's (tools/profile_collate.py): the scenes it builds,
each timed phase's output, the collated batch and the lines it prints."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data.collate import build_item_target as j_target, \
    voxelize_item as j_vox
from mask3d_tpu.data.transfer import encode_batch_u8 as j_encode
from mask3d_tpu_torch import profile_collate
from mask3d_tpu_torch.data.transfer import encode_batch_u8
from mask3d_tpu_torch.profile_forward import flagship_items

REPO = pathlib.Path(__file__).resolve().parents[1]
LABELS = ["collate total", "  voxelize_item x8", "  keep-gather x8",
          "  build_item_target x8", "  encode_batch_u8"]
PHASE_LINE = re.compile(r"^(.{28}) +\d+\.\d\d ms/batch$")


def jax_tool():
    """tools/profile_collate.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "_jax_tool_profile_collate", REPO / "tools" / "profile_collate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_items():
    """The scenes the JAX tool's `main` builds, taken from its first call
    of the collator (which then stops the tool)."""
    tool = jax_tool()
    seen = []

    class Recorder:
        def __init__(self, **kwargs):
            seen.append(kwargs)

        def __call__(self, items):
            seen.append(items)
            raise _Stop

    tool.VoxelizeCollate = Recorder
    with pytest.raises(_Stop):
        tool.main(1)
    assert seen[0] == {"point_bucket_multiple": profile_collate.BUCKET}
    return seen[1]


@pytest.fixture(scope="module")
def items():
    return flagship_items(0)


@pytest.fixture(scope="module")
def hosts(items, jax_items):
    """(port, JAX) host batches of the tool's collator."""
    return (profile_collate.VoxelizeCollate(
        point_bucket_multiple=profile_collate.BUCKET)(items),
            JCollate(point_bucket_multiple=profile_collate.BUCKET)(
                jax_items))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_items_are_the_jax_tools(items, jax_items):
    assert len(items) == len(jax_items) == 8
    for got, want in zip(items, jax_items):
        assert got.keys() == want.keys()
        for key in want:
            assert _equal(got[key], want[key]), key


@pytest.fixture(scope="module")
def voxed(items):
    return profile_collate.vox_all(items)


@pytest.fixture(scope="module")
def gathered(items, voxed):
    return profile_collate.gather_all(items, [k for _, k, _ in voxed])


def test_voxelize_item_matches_jax(voxed, jax_items):
    want = [j_vox(it["coordinates"]) for it in jax_items]
    assert len(voxed) == len(want)
    for got, w in zip(voxed, want):
        assert len(got) == len(w) == 3
        assert all(_equal(g, x) for g, x in zip(got, w))


def test_keep_gather_matches_jax(voxed, gathered, jax_items):
    for it, (_, k, _), got in zip(jax_items, voxed, gathered):
        want = (np.asarray(it["labels"])[k].astype(np.int32),
                np.asarray(it["features"])[k].astype(np.float32),
                np.asarray(it["raw_coordinates"])[k],
                np.asarray(it["raw_features"])[k],
                np.asarray(it["raw_labels"])[k])
        assert len(got) == len(want)
        assert all(_equal(g, w) for g, w in zip(got, want))


def test_build_item_target_matches_jax(gathered):
    targets = profile_collate.targets_all([g[0] for g in gathered])
    assert len(targets) == len(gathered)
    for g, (labels, masks, ids) in zip(gathered, targets):
        w_labels, w_masks, w_ids = j_target(g[0], (), (-1, 0))
        assert labels == w_labels and len(masks) == len(w_masks) > 0
        assert all(_equal(m, w) for m, w in zip(masks, w_masks))
        assert _equal(ids, w_ids)


def test_collated_batch_matches_jax(hosts):
    got, want = hosts[0].device, hosts[1].device
    assert got.coords.shape[1] == want.coords.shape[1] == 65536
    assert got.counts.tolist() == np.asarray(want.counts).tolist()
    for f in ("coords", "counts", "dims"):
        assert _equal(getattr(got, f), getattr(want, f)), f


def test_encode_batch_u8_matches_jax(hosts):
    got, want = hosts[0].device, hosts[1].device
    buf = encode_batch_u8(got.coords, got.counts, got.dims)
    assert _equal(buf, j_encode(np.asarray(want.coords), want.counts,
                                want.dims))


def test_main_prints_the_jax_tools_lines(capsys):
    jax_tool().main(1)
    want = capsys.readouterr().out.splitlines()
    times, host = profile_collate.main(1)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    assert got[0] == (f"n_cap={host.device.coords.shape[1]} "
                      f"counts={host.device.counts.tolist()}")
    assert len(got) == len(want) == 1 + len(LABELS)
    for g, w, label in zip(got[1:], want[1:], LABELS):
        assert PHASE_LINE.match(g) and PHASE_LINE.match(w), (g, w)
        assert g[:28] == w[:28] == f"{label:<28s}"
    assert list(times) == LABELS
    assert all(t > 0 for t in times.values())
