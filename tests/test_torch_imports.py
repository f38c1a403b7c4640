"""Import hygiene of the PyTorch port: `mask3d_tpu_torch` and
`chip_smoke.py` import no jax, no flax, no msgpack, no OpenCV or PIL (the
card's machine has neither) and nothing of `mask3d_tpu`, every source
citation names the line that defines what it cites, and the entry points
refuse CUDA where there is none."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mask3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "mask3d_tpu",
             "cv2", "PIL")
# `# from <source>:<line>[-<end>] <name>`, the source a file of the JAX
# package, of tools/ (Python or shell), of the experiment launch scripts or
# of the JAX tests, or bench.py
CITE = re.compile(r"#\s*from ((?:(?:mask3d_tpu|tools|experiment_launch_scripts"
                  r"|tests)/[\w/]+\.(?:py|sh))|bench\.py):(\d+)(?:-\d+)?"
                  r"\s+\(?(\w+)")


def _port_sources():
    # tests/torch_dist_worker.py runs in spawned ranks without the JAX
    # package, as the port does
    return sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_dist_worker.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_sources_import_no_jax():
    """AST scan: no import statement anywhere in the port names a
    forbidden package (lazy imports inside functions included)."""
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_port_import_loads_no_jax_modules():
    """In a fresh interpreter, importing every port module and chip_smoke
    adds no jax/flax/mask3d_tpu module to sys.modules."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mask3d_tpu_torch.models.mask3d" in loaded
    assert not [m for m in loaded if _forbidden(m)], loaded


def _citations():
    out = []
    for path in _port_sources():
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = CITE.search(line)
            if m:
                out.append((f"{path.relative_to(REPO)}:{i}", *m.groups()))
    return out


def test_citations_name_the_line_that_defines_them():
    """Every `# from mask3d_tpu/<file>:<line> <name>` comment in the port
    points at the line where `<name>` is defined (`def`/`class <name>`), or
    for a range or a non-function at a first line that holds `<name>`."""
    cites = _citations()
    assert len(cites) > 100, len(cites)
    bad = []
    for where, src, line, name in cites:
        lines = (REPO / src).read_text().splitlines()
        text = lines[int(line) - 1] if int(line) <= len(lines) else ""
        defines = re.match(rf"\s*(async\s+)?(def|class)\s+{name}\b", text)
        if not defines and not re.search(rf"\b{name}\b", text):
            bad.append(f"{where}: {src}:{line} {name} -> {text.strip()!r}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("cite", [
    "mask3d_tpu_torch/postprocess.py: mask3d_tpu/train/postprocess.py:68 "
    "get_mask_and_scores",
    "mask3d_tpu_torch/postprocess.py: mask3d_tpu/train/postprocess.py:96 "
    "sort_by_score",
    "mask3d_tpu_torch/postprocess.py: mask3d_tpu/train/postprocess.py:107 "
    "filter_instances",
    "mask3d_tpu_torch/evalm/pointwise.py: mask3d_tpu/evalm/pointwise.py:48 "
    "renumber_instance_ids",
])
def test_repaired_citations(cite):
    """The four citations that once named the wrong line now name the
    `def` of their function."""
    port, src, name = cite.split(" ", 2)[0][:-1], *cite.split(" ")[1:]
    assert any(where.startswith(port + ":") and f"{s}:{line}" == src
               and n == name for where, s, line, n in _citations())
    file, line = src.split(":")
    text = (REPO / file).read_text().splitlines()[int(line) - 1]
    assert re.match(rf"def {name}\(", text), text


@pytest.mark.parametrize("module,names", [
    ("preprocess/geometry.py", "polygon_area points_in_polygon "
     "points_to_polygon_distance points_match_polygon"),
    ("preprocess/stru3d.py", "SEMANTIC_TYPE_INT_MAP LOWER_PRIORITY_TYPES "
     "POLYGON_BUFFER_MM MIN_DEPTH_MM unproject_panorama label_points "
     "PanoramaSceneConverter _read_depth generate export convert_scene "
     "main"),
    ("preprocess/downsample.py", "downsample_point_cloud downsample_scene "
     "main"),
    ("preprocess/matterport.py", "merge_regions preprocess_scan "
     "load_download_mp process_scan preprocess_scan_regions "
     "download_and_preprocess main"),
    ("preprocess/analyze.py", "analyze_scene aggregate main"),
    ("utils/kfold.py", "kfold_splits"),
    ("utils/visualize.py", "plot_point_cloud plot_prediction_vs_gt "
     "gradient_flow_stats plot_gradient_flow plot_floorplan"),
    ("native.py", "downsample_native"),
])
def test_data_preparation_cites_its_sources(module, names):
    """Each data-preparation function of the JAX package has its
    counterpart in the port's module of the same path, cited there (the
    citation's line is checked above)."""
    cited = {n for where, src, _, n in _citations()
             if where.startswith(f"mask3d_tpu_torch/{module}:")
             and src == f"mask3d_tpu/{module}"}
    missing = set(names.split()) - cited
    assert not missing, missing


@pytest.mark.parametrize("module,source,names", [
    ("make_synthetic_dataset.py", "tools/make_synthetic_dataset.py",
     "CONFIGS make_item write_scene main"),
    ("make_synthetic_dataset.py", "tools/train_datascale.sh", "GRID"),
    ("train_rehearsal.py", "tools/train_rehearsal.py",
     "SyntheticRoomsDataset main apply_overrides voxelize_item loss mAP "
     "bit"),
    ("recert_int8.py", "tools/recert_int8.sh", "COMMON run_variant ref"),
    ("train_datascale.py", "tools/train_datascale.sh",
     "experiment1_voxel_size_150_train scene_00000"),
    ("calib_int8_logits.py", "tools/calib_int8_logits.py",
     "main rng variants"),
    ("profile_collate.py", "tools/profile_collate.py",
     "main bench vox_all gather_all targets_all"),
])
def test_trained_model_tools_cite_their_sources(module, source, names):
    """Each of the JAX package's trained-model tools has its counterpart,
    a top-level module of the port that cites it (the citations' lines
    are checked above)."""
    cited = {n for where, src, _, n in _citations()
             if where.startswith(f"mask3d_tpu_torch/{module}:")
             and src == source}
    missing = set(names.split()) - cited
    assert not missing, missing


def test_small_overrides_match_e2e_small_config():
    """The shared override list reproduces tests/test_e2e.py's
    small_config in both packages."""
    from mask3d_tpu_torch.config import Config, apply_overrides
    from tests.test_e2e import small_config
    from tests.torch_parity import SMALL_OVERRIDES

    ref = small_config()
    got = apply_overrides(Config(), SMALL_OVERRIDES)
    for group in ("general", "data", "model"):
        assert vars(getattr(ref, group)) == vars(getattr(got, group)), group


@pytest.mark.parametrize("entry", ["build_model", "collate", "infer",
                                   "device_batch", "init_state",
                                   "train_rehearsal", "calib_int8_logits"])
def test_entry_points_refuse_cuda_without_cuda(entry, monkeypatch,
                                               tmp_path):
    """A CUDA request where CUDA is absent raises; nothing falls back to
    the CPU."""
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
    from tests.torch_parity import SMALL_OVERRIDES, scene_items

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    items = scene_items(make=make_synthetic_scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "build_model":
            mt.build_model(cfg)
        elif entry == "collate":
            mt.collate(items, point_bucket_multiple=512)
        elif entry == "infer":
            host = mt.collate(items, device="cpu", point_bucket_multiple=512)
            model = mt.build_model(cfg, device="cpu")
            mt.infer(model, host.device, cfg)
        elif entry == "init_state":
            from mask3d_tpu_torch.train.loop import init_state
            init_state(cfg)
        elif entry == "train_rehearsal":
            from mask3d_tpu_torch import train_rehearsal
            train_rehearsal.main(1, save_dir=str(tmp_path))
        elif entry == "calib_int8_logits":
            from mask3d_tpu_torch import calib_int8_logits
            calib_int8_logits.main(1)
        else:
            host = mt.collate(items, device="cpu", point_bucket_multiple=512)
            host.device.to("cuda")


@pytest.mark.parametrize("override", [
    "model.compute_dtype=float16",
    "model.backbone_impl=gather_pallas model.int8_stride1=true",
    "model.backbone_impl=gather_pallas model.pallas_chain=true",
    "train: model.dropout=0.1",
    "model.backbone_impl=bricked model.int8_stride1=true",
    "model.backbone_impl=gather model.pallas_chain=true"])
def test_build_model_refuses_unported_options(override):
    """Options the port has not ported, or the JAX package cannot run,
    raise instead of being ignored: fp16, the int8 stack off the dense path,
    and (in a train forward after `train.loop.init_state`) dropout, which
    the JAX package's train step gives no rng."""
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.config import Config, apply_overrides
    from tests.torch_parity import SMALL_OVERRIDES

    train = override.startswith("train: ")
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + override.replace(
        "train: ", "").split())
    if not train:
        with pytest.raises(NotImplementedError):
            mt.build_model(cfg, device="cpu")
        return
    from mask3d_tpu_torch.data.collate import VoxelizeCollate
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    state = init_state(cfg, device="cpu")  # builds: it runs at inference
    host = VoxelizeCollate(point_bucket_multiple=512)(_small_scenes(1))
    step = make_train_step(cfg, make_criterion(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="in training"):
        step(state, host.device)


def _small_scenes(n):
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(3)
    return [make_synthetic_scene(rng, num_rooms_x=2, num_rooms_y=1,
                                 room_size=10, height=6, jitter=0.0,
                                 dropout=0.4) for _ in range(n)]


@pytest.mark.parametrize("override", [
    "model.backbone=Res16UNet50 model.int8_stride1=true",
    "model.backbone=Res16UNet101 model.pallas_chain=true",
    "model.backbone=Res16UNet50 model.sp_axis=sp"])
def test_build_model_runs_options_it_refused(override):
    """Options `build_model` refused before the int8 conv split its
    outputs into channel groups and the slab context took every block:
    each builds and runs a small CPU eval forward, finite and of the
    batch's shapes (held to the JAX package in
    tests/test_torch_int8_bottleneck.py and tests/test_torch_sp_model.py;
    sp_axis without a mesh is a no-op, as in the JAX package)."""
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.config import Config, apply_overrides
    from tests.torch_parity import SMALL_OVERRIDES

    cfg = apply_overrides(Config(), SMALL_OVERRIDES + override.split())
    model = mt.build_model(cfg, device="cpu")
    host = mt.collate(_small_scenes(1), device="cpu",
                      point_bucket_multiple=512)
    with torch.no_grad():
        out, _ = mt.infer(model, host.device, cfg, device="cpu")
    n = host.device.coords.shape[1]
    assert tuple(out.pred_masks.shape) == (1, n, cfg.model.num_queries)
    assert torch.isfinite(out.pred_masks).all()
    assert torch.isfinite(out.pred_class).all()


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and counts no launch."""
    from mask3d_tpu_torch.ops import masked_attention as ma
    from mask3d_tpu_torch.sparse import int8_conv as ic
    from mask3d_tpu_torch.sparse import row_gather as rg

    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(1, 5, 16)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(1, 40, 16)), dtype=torch.float32)
    mask = torch.tensor(rng.random((1, 5, 40)) < 0.5)
    src = torch.tensor(rng.normal(size=(1, 30, 4)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, 30, (1, 12)), dtype=torch.int32)
    ok = torch.tensor(rng.random((1, 12)) < 0.7)
    n_attn = ma.masked_cross_attention.launches
    n_gather = rg.row_gather.launches
    n_int8 = ic.int8_conv.launches
    torch.testing.assert_close(
        ma.masked_cross_attention(q, k, k, mask, 2),
        ma.masked_cross_attention_plain(q, k, k, mask, 2), rtol=0, atol=0)
    for dt in (torch.float32, torch.bfloat16):
        got = rg.row_gather(src.to(dt), idx, ok)
        assert got.dtype == dt
        assert torch.equal(got, rg.row_gather_plain(src.to(dt), idx, ok))
    occ = torch.tensor(rng.random((1, 3, 4, 5, 1)) < 0.5).float()
    x = (torch.tensor(rng.normal(size=(1, 3, 4, 5, 8))) * occ).bfloat16()
    wq = torch.tensor(rng.integers(-127, 128, (27, 8, 4)), dtype=torch.int8)
    sw = torch.full((4,), 1e-3)
    a = torch.ones(1, 8)
    kw = dict(A=a, Bc=a * 0.1, inv=torch.full((8,), 20.0), stats=True)
    got = ic.int8_conv(x, occ, wq, sw, "affine", **kw)
    ref = ic.int8_conv_plain(x, occ, wq, sw, "affine", **kw)
    assert torch.equal(got.out, ref.out) and torch.equal(got.stats,
                                                         ref.stats)
    assert ma.masked_cross_attention.launches == n_attn
    assert rg.row_gather.launches == n_gather
    assert ic.int8_conv.launches == n_int8


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_shape", "idx_dtype",
                                 "ok_shape"])
def test_kernel_wrappers_reject_bad_inputs(bad):
    from mask3d_tpu_torch.ops.masked_attention import masked_cross_attention
    from mask3d_tpu_torch.sparse.row_gather import row_gather

    q = torch.zeros(1, 4, 8)
    k = torch.zeros(1, 16, 8)
    src = torch.zeros(1, 10, 3)
    idx = torch.zeros(1, 6, dtype=torch.int32)
    ok = torch.ones(1, 6, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        if bad == "mask_dtype":
            masked_cross_attention(q, k, k, torch.zeros(1, 4, 16), 2)
        elif bad == "mask_shape":
            masked_cross_attention(q, k, k, torch.zeros(1, 4, 15,
                                                        dtype=torch.bool), 2)
        elif bad == "idx_dtype":
            row_gather(src, idx.long(), ok)
        else:
            row_gather(src, idx, ok[:, :5])


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """The CUDA kernels against their plain versions (needs a card;
    `chip_smoke.py` runs the same checks at flagship shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from mask3d_tpu_torch.ops import masked_attention as ma
    from mask3d_tpu_torch.sparse import row_gather as rg

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, nq, s, d, h) in ((2, 25, 100, 32, 4), (3, 40, 515, 128, 8)):
        q = torch.randn(b, nq, d, device="cuda", generator=gen)
        k = torch.randn(b, s, d, device="cuda", generator=gen)
        v = torch.randn(b, s, d, device="cuda", generator=gen)
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        mask[0, 0] = True
        got = ma.masked_cross_attention(q, k, v, mask, h)
        ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    for c in (3, 96):
        src = torch.randn(2, 500, c, device="cuda", generator=gen)
        idx = torch.randint(-3, 505, (2, 300), device="cuda",
                            generator=gen).int()
        ok = torch.rand(2, 300, device="cuda", generator=gen) < 0.8
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(rg.row_gather(src.to(dt), idx, ok),
                               rg.row_gather_plain(src.to(dt), idx, ok))
