"""The port's trained-model tools against the JAX package's (tools/): the
written dataset byte for byte, the grid pin against the shell's own
procedure, the rehearsal's scenes and config, the data-scale launcher's
arguments against the shell scripts', the int8 recertification through
`cli test` (three variants, its 0.01 gate) and the int8 logit calibration's
fixture."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import calib_int8_logits, make_synthetic_dataset, \
    recert_int8, train_datascale, train_rehearsal
from tests.torch_parity import SMALL_OVERRIDES
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"


def jax_tool(name):
    """A module of tools/, imported by path."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def heredoc(script, start):
    """The python program of the shell `script` whose heredoc opens on the
    line `start` (`python - ... <<'EOF'`) and closes at `EOF`."""
    lines = (TOOLS / script).read_text().splitlines()
    assert "<<'EOF'" in lines[start - 1], lines[start - 1]
    body = lines[start:]
    return "\n".join(body[:body.index("EOF")]) + "\n"


def run_heredoc(code, argv):
    """Run a heredoc program in this process, as `python - <argv>` from
    the repository root would; its standard output."""
    out = io.StringIO()
    old_argv, old_cwd = sys.argv, os.getcwd()
    sys.argv = ["-"] + list(argv)
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(code, "<heredoc>", "exec"), {"__name__": "__main__"})
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)
    return out.getvalue()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The JAX tool's and the port's `main(root, 3, 2, 2, seed=0)`."""
    base = tmp_path_factory.mktemp("synthetic")
    jax_root, port_root = str(base / "jax"), str(base / "port")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_tool("make_synthetic_dataset").main(jax_root, 3, 2, 2, seed=0)
        make_synthetic_dataset.main(port_root, 3, 2, 2, seed=0)
    return jax_root, port_root


def test_dataset_is_the_jax_tools_byte_for_byte(written):
    jax_root, port_root = written
    files = {}
    for root in written:
        files[root] = sorted(
            str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*")
            if p.is_file())
    assert files[jax_root] == files[port_root]
    assert files[port_root] == [
        f"scene_{i:05d}/point_cloud_rasterized_150.ply"
        for i in (0, 1, 2, 3000, 3001, 3250, 3251)]
    for rel in files[port_root]:
        assert (pathlib.Path(jax_root) / rel).read_bytes() == \
            (pathlib.Path(port_root) / rel).read_bytes(), rel


@pytest.mark.parametrize("script,line", [("train_datascale.sh", 39),
                                         ("recert_int8.sh", 25)])
def test_pinned_grid_dims_is_the_shells(written, script, line):
    """`pinned_grid_dims` against the shell scripts' own heredoc program
    (the JAX package's `read_ply` and `voxelize_item`), run on the same
    root."""
    root = written[1]
    want = run_heredoc(heredoc(script, line), [root]).strip()
    got = make_synthetic_dataset.pinned_grid_dims(root)
    assert ",".join(map(str, got)) == want
    assert all(d % 8 == 0 for d in got)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rehearsal_scenes_are_the_jax_tools(seed):
    """The first 4 scenes of a seed's stream, bitwise: coordinates, labels,
    scene name and index."""
    ref = jax_tool("train_rehearsal").SyntheticRoomsDataset(4, seed=seed)
    got = train_rehearsal.SyntheticRoomsDataset(4, seed=seed)
    assert len(got) == len(ref) == 4
    assert got.labels_info == ref.labels_info
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        assert a["scene"] == b["scene"] and a["idx"] == b["idx"]
        for k in ("coordinates", "labels", "features"):
            if k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


def jax_rehearsal_overrides(num_epochs):
    """The override list of tools/train_rehearsal.py's `main`, read from
    its source (the `apply_overrides(cfg, [...])` call, its f-strings
    evaluated at `num_epochs`)."""
    tree = ast.parse((TOOLS / "train_rehearsal.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "apply_overrides")
    return eval(compile(ast.Expression(call.args[1]), "<overrides>", "eval"),
                {"num_epochs": num_epochs})


def test_rehearsal_config_is_the_jax_tools():
    """The port's override list is the JAX tool's (its save directory
    aside), and both packages' configs after it agree field by field."""
    from mask3d_tpu.config import Config as JConfig
    from mask3d_tpu.config import apply_overrides as j_apply

    ref = jax_rehearsal_overrides(600)
    got = train_rehearsal.overrides(600, "/tmp/rehearsal_saved")
    assert got == ref
    assert train_rehearsal.overrides(600)[ref.index(
        "general.save_dir=/tmp/rehearsal_saved")] == \
        "general.save_dir=saved/rehearsal_saved"
    jcfg = j_apply(JConfig(), ref)
    pcfg = train_rehearsal.build_config(600, "/tmp/rehearsal_saved")
    for f in dataclasses.fields(pcfg):
        assert vars(getattr(jcfg, f.name)) == vars(getattr(pcfg, f.name)), \
            f.name
    assert pcfg.trainer.grad_accum_steps == 8 and pcfg.data.batch_size == 16


def shell_overrides(path, first, last, env):
    """The quoted override arguments on lines first..last of a shell
    script, `$NAME` substituted from `env`."""
    lines = (REPO / path).read_text().splitlines()[first - 1:last]
    out = []
    for line in lines:
        arg = line.strip().rstrip("\\").strip()
        if not arg or arg.startswith(("bash ", "python ")):
            continue
        arg = re.sub(r"""^['"]|['"]$""", "", arg).replace('="', "=")
        out.append(re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)],
                          arg).replace('"', ""))
    return out


def test_datascale_arguments_are_the_shells():
    """`cli train`'s arguments: the experiment-1 launch script's overrides,
    then tools/train_datascale.sh's, then the caller's (later wins)."""
    env = dict(ROOT="data/synth_stru3d", GRID="168,128,32", EPOCHS="100",
               RUN_ID="r5_datascale", EXPERIMENT_NAME=
               "experiment1_voxel_size_150")
    exp1 = shell_overrides(
        "experiment_launch_scripts/experiment1_voxel_size_150_train.sh",
        12, 18, env)
    own = shell_overrides("tools/train_datascale.sh", 69, 86, env)
    got = train_datascale.argv_for(train_datascale.ROOT, (168, 128, 32),
                                   100, device="cpu", extra=["x.y=1"])
    assert got == ["train", "--device", "cpu"] + exp1 + own + ["x.y=1"]
    assert train_datascale.SIZES == (256, 32, 32, 0)
    from mask3d_tpu_torch.config import Config, apply_overrides
    cfg = apply_overrides(Config(), got[3:-1])
    assert cfg.trainer.grad_accum_steps == 16  # the data-scale script's
    assert cfg.data.grid_dims_cap == (168, 128, 32)


def small_scene(rng):
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(rng, num_rooms_x=2, num_rooms_y=1,
                                room_size=12, height=6, jitter=0.0,
                                dropout=0.5)


@pytest.fixture(scope="module")
def recert_case(tmp_path_factory):
    """Two written test scenes (and a train and a validation scene: the
    trainer builds every split), a small_config checkpoint, and the
    recert's three `cli test` runs on the CPU."""
    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.train.checkpoint import save_checkpoint
    from mask3d_tpu_torch.train.loop import init_state

    base = tmp_path_factory.mktemp("recert")
    root, saved = str(base / "data"), str(base / "saved")
    rng = np.random.default_rng(5)
    for name in ("scene_00000", "scene_03000", "scene_03250", "scene_03251"):
        make_synthetic_dataset.write_scene(root, name, small_scene(rng))
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    ckpt = str(base / "small.ckpt")
    save_checkpoint(ckpt, init_state(cfg, seed=3, device="cpu"), 0)
    extra = SMALL_OVERRIDES + [f"general.save_dir={saved}",
                               "general.experiment_name=recert"]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        # the metric logger writes its CSV only (importing
        # torch.utils.tensorboard pulls in TensorFlow)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        res = recert_int8.main(ckpt, root, device="cpu", extra=extra)
    return res, out.getvalue()


def test_recert_runs_three_variants_through_cli_test(recert_case):
    res, printed = recert_case
    assert list(res["runs"]) == ["fp32", "bf16", "int8"]
    for name, metrics in res["runs"].items():
        maps = recert_int8.map_values(metrics)
        assert sorted(maps) == ["test_mean_ap", "test_mean_ap_25",
                                "test_mean_ap_50"], name
        assert all(np.isfinite(v) for v in maps.values()), (name, maps)
    assert res["lines"][-1] in ("RECERT PASS", "RECERT FAIL")
    assert len(res["lines"]) == 2 * 3 + 1
    for line in res["lines"]:
        assert line in printed
    for name in ("fp32", "bf16", "int8"):
        assert f"=== variant: {name} ===" in printed


@pytest.mark.parametrize("delta,rc", [(0.011, 1), (0.009, 0)])
def test_recert_gate_fails_past_its_tolerance(recert_case, monkeypatch,
                                              capsys, delta, rc):
    """bf16 and int8 planted at fp32's mAPs, one key moved by `delta`:
    0.011 fails (exit 1), 0.009 passes."""
    fp32 = dict(recert_case[0]["runs"]["fp32"])
    planted = {"fp32": fp32, "bf16": dict(fp32), "int8": dict(fp32)}
    planted["int8"]["test_mean_ap_25"] = fp32["test_mean_ap_25"] + delta
    monkeypatch.setattr(recert_int8, "run_variant",
                        lambda name, *a, **k: planted[name])
    monkeypatch.setattr(recert_int8, "pinned_grid_dims", lambda root: (8,) * 3)
    ckpt = recert_case[0]["runs"] and __file__  # any existing file
    assert recert_int8.cli_main([ckpt, "--device", "cpu"]) == rc
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("RECERT FAIL" if rc else "RECERT PASS")
    flag = "FAIL" if rc else "OK"
    assert re.search(rf"int8 test_mean_ap_25: \S+ vs fp32 \S+ "
                     rf"\(\|d\|={delta:.4f}\) {flag}", printed), printed


def test_calib_fixture_is_jax_parity16():
    """The calibration's 16 scenes, capacity, level-0 dims and 8 batches
    equal tests/test_e2e.py::parity16's collation (JAX's collator on JAX's
    scenes)."""
    from mask3d_tpu.data import VoxelizeCollate as JCollate
    from mask3d_tpu.data import make_synthetic_scene as j_make
    from tests.test_e2e import N_PARITY_SCENES, _PARITY_BS, parity_config
    from tests.test_e2e import _MAP_KEYS

    assert calib_int8_logits.N_PARITY_SCENES == N_PARITY_SCENES
    assert calib_int8_logits._PARITY_BS == _PARITY_BS
    assert calib_int8_logits._MAP_KEYS == _MAP_KEYS
    pc, jc = calib_int8_logits.parity_config(), parity_config()
    for f in dataclasses.fields(pc):
        assert vars(getattr(pc, f.name)) == vars(getattr(jc, f.name)), f.name
    rng = np.random.default_rng(11)
    scenes = [j_make(rng, num_rooms_x=2, num_rooms_y=1, room_size=12,
                     height=6, jitter=0.0, dropout=0.5)
              for _ in range(N_PARITY_SCENES)]
    probe = JCollate(point_bucket_multiple=64)
    probed = [probe(scenes[i:i + _PARITY_BS])
              for i in range(0, N_PARITY_SCENES, _PARITY_BS)]
    cap = max(int(b.device.coords.shape[1]) for b in probed)
    dims0 = tuple(max(b.device.grid_dims[0][a] for b in probed)
                  for a in range(3))
    coll = JCollate(point_bucket_multiple=cap, min_grid_dims=dims0)
    ref = [coll(scenes[i:i + _PARITY_BS])
           for i in range(0, N_PARITY_SCENES, _PARITY_BS)]

    _, p_cap, p_dims0, got = calib_int8_logits.parity_batches()
    assert (p_cap, p_dims0) == (cap, dims0)
    assert len(got) == len(ref) == 8
    for r, g in zip(ref, got):
        assert list(r.scenes) == list(g.scenes)
        assert r.device.grid_dims == g.device.grid_dims
        for f in ("coords", "feats", "counts", "dims"):
            np.testing.assert_array_equal(np.asarray(getattr(r.device, f)),
                                          np.asarray(getattr(g.device, f)))
        for f in ("labels", "masks", "valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r.device.target, f)),
                np.asarray(getattr(g.device.target, f)))


def test_calib_prints_a_line_per_variant(capsys, monkeypatch):
    """A steps=1 run on the fixture's first batch (its 16 scenes are
    checked above) prints each variant's line."""
    real = calib_int8_logits.parity_batches

    def first_batch():
        scenes, cap, dims0, batches = real()
        return scenes, cap, dims0, batches[:1]

    monkeypatch.setattr(calib_int8_logits, "parity_batches", first_batch)
    out = calib_int8_logits.main(steps=1, device="cpu")
    printed = capsys.readouterr().out
    names = list(calib_int8_logits.variants())
    assert names == ["bf16", "int8-dyn", "int8-s4", "int8-s6", "int8-s8",
                     "int8-s10", "int8-s14"]
    assert list(out) == names
    for name in names:
        line = next(ln for ln in printed.splitlines()
                    if ln.startswith(f"{name} "))
        assert re.search(r"max=\S+ p999=\S+ p99=\S+ d\w+=\S+", line), line
        mx, p999, p99, dm = out[name]
        assert np.isfinite([mx, p999, p99]).all() and mx >= p999 >= p99
        assert set(dm) == set(calib_int8_logits._MAP_KEYS)
    assert "fp32 logit std" in printed and "final loss" in printed
    assert torch.get_num_threads() == 1
