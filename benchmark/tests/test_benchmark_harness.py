"""The harness on the CPU at a tiny size: each loop runs a tiny cell end to
end and comes out correct; the timed path broken underneath, or the
control in the program's place, comes out not correct; a new cell,
configuration, traffic and per-layer metric are picked up from new files
alone; and no module of a run is JAX's or the JAX package's."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _quiet(line):
    pass


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_runs_correct(cell):
    r = tiny.run(cell)
    res = harness.execute(r, _quiet)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"voxels_per_s", "batch_latency_p95_ms",
                                   "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_tiny_cell_reports_host_metrics():
    r = tiny.run("tiny-pipelined", trace=True)
    res = harness.execute(r, _quiet)
    # on the CPU the device metrics have nothing to read and are left out
    assert set(res["metrics"]) == {"feed_ms.infer", "feed_wait_share.infer",
                                   "dispatch_ms.infer"}
    assert res["correct"]


def _half_batch(fn):
    """Half of the batch left out: its outputs the mean over the rest."""
    def broken(*a, **k):
        out = fn(*a, **k)
        pc, pm = (out[0].pred_class, out[0].pred_masks) \
            if hasattr(out[0], "pred_class") else out[:2]
        h = max(1, pc.shape[0] // 2)
        pc[h:] = pc[:h].mean(dim=0, keepdim=True)
        pm[h:] = pm[:h].mean(dim=0, keepdim=True)
        return out
    return broken


def _altered_answer(fn):
    """One answer altered where it is produced: the first scene's mask
    logits moved one voxel along its rows."""
    def broken(*a, **k):
        out = fn(*a, **k)
        pm = out[0].pred_masks if hasattr(out[0], "pred_masks") else out[1]
        pm[0] = torch.roll(pm[0], 1, dims=0)
        return out
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    entry = importlib.import_module("mask3d_tpu_torch.infer")
    entry_name = tiny.CELLS[cell]["entry"]
    monkeypatch.setattr(entry, entry_name, fault(getattr(entry, entry_name)))
    res = harness.execute(tiny.run(cell), _quiet)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_attention_that_ignores_its_mask_is_not_correct(cell, monkeypatch):
    """The decoder's masked cross-attention attending over its blocked
    rows."""
    from mask3d_tpu_torch.models import mask3d

    attend = mask3d.masked_cross_attention

    def unmasked(q, k, v, mask, *a, **kw):
        return attend(q, k, v, torch.zeros_like(mask), *a, **kw)

    monkeypatch.setattr(mask3d, "masked_cross_attention", unmasked)
    res = harness.execute(tiny.run(cell), _quiet)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("precision", ["fp8", "tf32"])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(cell, precision):
    """The reference in the precision below the cell's in the program's
    place (the cells' controls: fp8 for bf16, TF32 for float32)."""
    r = tiny.run(cell)
    r.control = {"kind": "reference", "precision": precision}
    res = harness.execute(r, _quiet)
    assert not res["correct"], res["checks"]


NEW_FILES = {
    "benchmark/configs/tiny-new.json": tiny.CONFIG,
    "benchmark/traffic/tiny-new.json": tiny.TRAFFIC,
    "benchmark/workloads/tiny-new-cell.json": dict(
        tiny.CELLS["tiny-client"], limits=tiny.LIMITS),
}
NEW_METRIC = '''
def read(r, summ):
    return float(len(r.forwards))
'''
DRIVER = '''
import json, sys
sys.path.insert(0, ".")
import torch
torch.set_num_threads(2)
from benchmark import harness
r = harness.Run("tiny-new-cell", 3, 0.5, {trace}, "cpu")
res = harness.execute(r, lambda line: None)
res["forbidden"] = harness.forbidden_modules()
res["program_in_reference"] = [m for m in sys.modules
                               if m.startswith("benchmark.reference")]
print(json.dumps(res))
'''


def test_new_cell_config_traffic_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "mask3d_tpu_torch").symlink_to(tiny.ROOT / "mask3d_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    for rel, obj in NEW_FILES.items():
        (root / rel).write_text(json.dumps(obj))
    (root / "benchmark/metrics/forwards_seen.py").write_text(NEW_METRIC)
    manifest = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "tiny-new", "source": "test",
        "file": "benchmark/configs/tiny-new.json", "reduced": [],
        "why": "test"})
    manifest["workloads"].append({"name": "tiny-new-cell",
                                  "config": "tiny-new",
                                  "traffic": "tiny-new", "chips": 1,
                                  "why": "test"})
    manifest["per_layer"].append({
        "name": "forwards_seen", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "entry and dispatch",
        "moves": "voxels_per_s", "workloads": ["tiny-new-cell"]})
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny-new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for trace in (0, 1):
        res = subprocess.run([sys.executable, "-c",
                              DRIVER.format(trace=bool(trace))],
                             cwd=root, capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
        assert out["forbidden"] == []
        if trace:
            assert out["metrics"]["forwards_seen"]["value"] >= 1
        else:
            assert "voxels_per_s" in out["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited


def test_reference_imports_nothing_of_the_program():
    code = textwrap.dedent('''
        import sys
        sys.path.insert(0, ".")
        import benchmark.reference.mask3d_plain, benchmark.weights
        import benchmark.check, benchmark.flops
        bad = sorted({m.split(".")[0] for m in sys.modules}
                     & {"mask3d_tpu_torch", "mask3d_tpu", "jax", "jaxlib",
                        "flax"})
        print(bad)
    ''')
    res = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mask3d_tpu_torch_like", sys)
    assert "mask3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def _first_cell():
    manifest = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    return manifest["workloads"][0]["name"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = subprocess.run(
        [sys.executable, str(tiny.ROOT / "benchmark/run.py"), "--workload",
         _first_cell(), "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", _first_cell(),
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
