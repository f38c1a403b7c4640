"""Configuration tree of the port: the same dataclasses, defaults and
override grammar as the JAX package, so one override list configures both.

# from mask3d_tpu/config.py:22-464 GeneralConfig .. from_yaml
The fields the JAX package marks TPU-specific keep their names and defaults;
the port reads `model.*` shape fields and `data.*` bucketing, and ignores the
TPU execution knobs (the port always runs its CUDA kernels on the card).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class GeneralConfig:
    """`conf/config_base_instance_segmentation.yaml:1-53`."""

    train_mode: bool = True
    task: str = "instance_segmentation"
    seed: int = 1
    checkpoint: Optional[str] = None
    backbone_checkpoint: Optional[str] = None
    freeze_backbone: bool = False
    add_instance: bool = True
    experiment_name: str = "TEST-EVAL"
    experiment_id: Optional[str] = None
    version: int = 1
    debug_best_worst_scenes: bool = False
    debug_mean_average_precision: bool = False
    num_targets: int = 1
    use_dbscan: bool = True
    dbscan_eps: float = 1.0
    dbscan_min_points: int = 10
    filter_out_instances: bool = True
    scores_threshold: float = 0.8
    iou_threshold: float = 1.0
    export_las: bool = False
    export_freq: int = 250
    reps_per_epoch: int = 1
    export: bool = False
    generic_export_score_threshold: float = 0.0001
    topk_per_image: int = -1
    ignore_mask_idx: Tuple[int, ...] = ()
    save_dir: str = "saved"
    accelerator: str = "tpu"


@dataclass
class DataConfig:
    """`conf/data/indoor.yaml`."""

    dataset: str = "structured3d"  # structured3d | s3dis | matterport3d
    data_root: str = "/data/stru3d"
    valid_scenes_file_path: Optional[str] = None
    ignore_label: int = -1
    add_colors: bool = False
    add_normals: bool = False
    in_channels: int = 1
    num_labels: int = 1
    batch_size: int = 16
    test_batch_size: int = -1  # -1 -> batch_size
    # Which split `test` evaluates: test | train | validation | trainval
    # (reference `data.test_dataset.mode`, experiment5/6 split-eval scripts)
    test_dataset_mode: str = "test"
    # Which splits train/validation use (the matterport3d dataset group
    # trains on trainval and validates on the test split — reference
    # `conf/data/datasets/matterport3d_room_detection.yaml`).
    train_dataset_mode: str = "train"
    validation_dataset_mode: str = "validation"
    num_workers: int = 8
    rasterization_factor: int = 150
    prediction_label_offset: int = 1
    data_fraction: float = 1.0
    volume_augmentations: str = "stru3d"  # none | stru3d | s3dis | matterport3d
    # Reference `conf/data/datasets/structured3d_room_detection.yaml:21`.
    filter_out_classes: Tuple[int, ...] = (0, 17, 18, 19, 21)
    filter_out_instance_ids: Tuple[int, ...] = (-1, 0)
    # TPU bucketing (no reference equivalent: static-shape padding control)
    point_bucket_multiple: int = 4096
    instance_bucket_multiple: int = 8
    # Static level-0 grid floor (gx, gy, gz): mixed-size datasets pin one
    # grid shape -> one jit executable (see VoxelizeCollate.min_grid_dims)
    min_grid_dims: Optional[tuple] = None
    # Static level-0 grid PIN (floor AND ceiling): oversized items are
    # center-cropped to fit, so augmented runs keep ONE train executable
    # (see VoxelizeCollate.grid_dims_cap)
    grid_dims_cap: Optional[tuple] = None
    level_cap_ratios: Tuple[float, ...] = (0.5, 0.25, 0.125, 0.0625)


@dataclass
class ModelConfig:
    """`conf/model/mask3d.yaml`."""

    name: str = "Mask3D"
    hidden_dim: int = 128
    dim_feedforward: int = 1024
    num_queries: int = 25
    num_heads: int = 8
    num_decoders: int = 3
    dropout: float = 0.0
    pre_norm: bool = False
    use_level_embed: bool = False
    normalize_pos_enc: bool = True
    positional_encoding_type: str = "fourier"
    gauss_scale: float = 1.0
    hlevels: Tuple[int, ...] = (0, 1, 2, 3)
    non_parametric_queries: bool = True
    random_query_both: bool = False
    random_normal: bool = False
    random_queries: bool = False
    use_np_features: bool = False
    sample_sizes: Tuple[int, ...] = (200, 800, 3200, 12800, 51200)
    max_sample_size: bool = False
    shared_decoder: bool = True
    num_classes: int = 1
    scatter_type: str = "mean"
    backbone: str = "Res16UNet34C"
    # "dense": dense-grid conv execution (TPU fast path); "gather": kernel-map
    # gather-matmul (general fallback); "gather_pallas": gather path with the
    # windowed Pallas conv kernel (large scenes whose grid won't fit densely)
    backbone_impl: str = "dense"
    # TPU-specific (backbone_impl=bricked): level-0 grid as occupied
    # dense bricks — the dense executor for scans whose level-0 grid
    # exceeds HBM (sparse/brick_ops.py). Brick shape must divide the
    # bucketed grid dims; capacity pads the occupied-brick count.
    brick_dims: Sequence[int] = (16, 16, 8)
    brick_capacity: int = 8192
    conv1_kernel_size: int = 5
    bn_momentum: float = 0.02
    # TPU-specific: bf16 compute in the backbone matmuls
    compute_dtype: Optional[str] = None
    # TPU-specific: sequence-parallel mesh axis for the point/grid-x axis
    # (scenes too large for one chip; see mask3d_tpu/parallel/mesh.py)
    sp_axis: Optional[str] = None
    # TPU-specific: recompute backbone activations in the backward pass
    # (jax.checkpoint) — large-batch/large-grid training memory knob
    remat_backbone: bool = False
    # TPU-specific: cross-attention key-chunk size for the online-softmax
    # (flash) schedule on full-level eval memories; 0 = one-shot softmax.
    # Engages only when S % chunk == 0 and S >= 2*chunk (the big eval
    # levels); measured +4% end-to-end at 8192 on v5e (bench.py A/B,
    # docs/ARCHITECTURE.md) vs the one-shot [B,h,Q,S] logits
    attention_chunk: int = 8192
    # TPU-specific: fused Pallas masked cross-attention tile (0 = off);
    # K/V stream once through VMEM, no [B,h,Q,S] logits in HBM
    attention_pallas_tile: int = 0
    # TPU-specific: run the level-0 stride-1 backbone convs (41% of the
    # flagship device forward) in dynamically-quantized int8 at EVAL —
    # training always stays in compute_dtype (round() has no gradient).
    # Parity gate: tests/test_e2e.py::test_int8_eval_metrics_match_fp32
    int8_stride1: bool = False
    # TPU-specific: with int8_stride1 + int8_act_sigma>0, intermediate
    # backbone block outputs are materialized ONLY as int8 (QGrid): the
    # next block's conv consumes them directly and its residual path
    # dequantizes in-register. Kills the duplicated bf16 junction
    # epilogue+quantize passes (18.3 ms of the 86.2 ms flagship forward,
    # op dump 2026-08-19). Same parity gates as int8_stride1.
    int8_residual: bool = False
    # TPU-specific: sigma multiplier for STATIC int8 activation scales
    # derived from the InstanceNorm affine params (per-channel bound
    # sigma*|gamma|+|beta| on the standardized post-norm activations —
    # values beyond the bound saturate at +-127). Removes the per-conv
    # absmax reduce pass of dynamic quantization (~5 ms/forward on v5e)
    # and lets the quantize fuse into the norm/residual epilogues.
    # 0 = dynamic per-channel absmax (the round-3 scheme). Parity gate:
    # tests/test_e2e.py::test_int8_eval_metrics_match_fp32.
    int8_act_sigma: float = 0.0
    # TPU-specific: run >=96-channel stride-1 BasicBlock stacks through
    # the fused Pallas int8 block-chain (sparse/pallas_chain.py) — the
    # InstanceNorm affine, relu, static-bound quantize and residual join
    # ride inside the conv kernels instead of standalone HBM passes.
    # Needs int8_stride1 + int8_act_sigma>0; probe-guarded per backend
    # build. Parity gates: tests/test_pallas_chain.py +
    # tests/test_e2e.py int8 variants.
    pallas_chain: bool = False
    # TPU-specific: run narrow (<= 32-ch) identity-residual stages in the
    # z-folded layout (dense_ops.dense_basic_stage_folded) — kills the
    # 32->128 lane-padding waste of the 5D layout on the stage-1 chain.
    fold_small_stages: bool = False
    # TPU-specific: promise that input features are constant ones (true
    # for every room dataset here — datasets.py builds np.ones features);
    # the dense stem then reads the occupancy grid instead of scattering
    # the feature rows (one fewer full-grid scatter per forward).
    unit_features: bool = False
    # TPU-specific: selection mechanism of the windowed Pallas sparse conv
    # (backbone_impl=gather_pallas): "onehot" (MXU one-hot matmul) or
    # "gather" (Mosaic tpu.dynamic_gather — true sparse FLOPs, no MXU
    # selection work; see sparse/pallas_conv.py)
    pallas_conv_select: str = "onehot"
    # Window schedule of the same kernel: "per_offset" (one window per
    # kernel offset) or "grouped_dx" (one window per x-offset group — each
    # DMA'd window amortizes K/3 select+matmul steps; wins when the
    # per-offset y/z windows were already span-limited by geometry).
    # Both are Mosaic schedule knobs that compute the same function: the
    # port accepts every value and runs its one CUDA sparse-conv kernel
    # (sparse/sparse_conv.py), which needs no window and no select.
    pallas_window_mode: str = "per_offset"


@dataclass
class MatcherConfig:
    """`conf/matcher/hungarian_matcher.yaml`."""

    cost_class: float = 2.0
    cost_mask: float = 5.0
    cost_dice: float = 2.0
    num_points: int = -1
    lsap_method: str = "device"


@dataclass
class LossConfig:
    """`conf/loss/set_criterion.yaml`."""

    eos_coef: float = 0.1
    class_weights: Any = -1


@dataclass
class OptimizerConfig:
    """`conf/optimizer/adamw.yaml`."""

    name: str = "adamw"
    lr: float = 1e-4
    weight_decay: float = 0.01


@dataclass
class SchedulerConfig:
    """`conf/scheduler/exponentiallr.yaml`."""

    name: str = "exponentiallr"
    gamma: float = 0.99999
    interval: str = "step"
    max_lr: Optional[float] = None  # onecyclelr
    steps_per_epoch: int = -1
    # steplr / lambdalr groups (both are torch StepLR in the reference:
    # `mask3d/conf/scheduler/lambdalr.yaml` — step_size 99999 at
    # interval=epoch == constant; the tick unit is epochs).
    step_size: int = 99999


@dataclass
class TrainerConfig:
    """`conf/trainer/trainer.yaml`."""

    deterministic: bool = True
    max_epochs: int = 15000
    min_epochs: int = 1
    check_val_every_n_epoch: int = 1
    num_sanity_val_steps: int = 0
    # Write last-epoch.ckpt every N epochs (1 = the reference's
    # RegularCheckpointing, mask3d/trainer/trainer.py:28-31; raise for
    # short-epoch runs where the full-state write dominates epoch wall
    # time). The final epoch always saves, so auto-resume stays exact.
    save_last_every_n_epochs: int = 1
    # TPU-specific
    num_data_parallel: int = 1
    # Gradient accumulation: split each batch into K equal micro-batches
    # scanned inside ONE jitted step (activation memory scales with B/K).
    # Enables the reference's batch-16 training recipe on a single 16 GB
    # chip, where the dense f32 backward at batch >= 8 exceeds HBM.
    grad_accum_steps: int = 1
    log_every_n_steps: int = 10
    # jax.profiler trace of steps [profile_start, profile_start+profile_steps)
    # written to <run_dir>/profile (reference analogue: torch-tb-profiler,
    # mask3d/requirements.txt:22 + the measure_runtime split timer)
    profile_steps: int = 0
    profile_start: int = 5
    # debug: jax_debug_nans (the reference's NaN guards, trainer.py:204)
    debug_nans: bool = False
    # Compute evaluator metrics (mAP/SDR/...) on the TRAIN split every
    # step from the train forward's predictions, as the reference does
    # (`trainer.py:289` — eval_instance_segmentation_step runs in all
    # splits). Costs host post-processing per train step; disable for
    # max-throughput runs.
    train_split_metrics: bool = True
    # Multi-host (multi-process / DCN) data parallelism: wire
    # `jax.distributed.initialize()` at entry (parallel/dist.py — the TPU
    # translation of the reference's latent DDP path, SURVEY §5.8).
    # Single-process runs leave it False and nothing changes. When set,
    # every host must run the same config; `num_data_parallel` then counts
    # GLOBAL devices, `data.batch_size` stays the GLOBAL batch size, and
    # each host collates only its own contiguous slice of every batch.
    distributed: bool = False
    coordinator_address: str = ""  # "" = auto-detect (TPU pod env)
    num_processes: int = -1  # -1 = auto-detect
    process_id: int = -1  # -1 = auto-detect
    # test(): also measure the model_forward_* sub-phase segments of the
    # measure_runtime contract via prefix-difference timing
    # (train/loop.py::measure_model_phases; reference
    # mask3d/utils/measure_runtime.py call sites in models/mask3d.py).
    measure_model_phases: bool = False


@dataclass
class Config:
    general: GeneralConfig = field(default_factory=GeneralConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def _coerce(value: str, current: Any) -> Any:
    if value.lower() in ("null", "none"):
        return None
    if isinstance(current, bool) or value.lower() in ("true", "false"):
        return value.lower() == "true"
    if isinstance(current, tuple) or (
        value.startswith("[") and value.endswith("]")
    ):
        inner = value.strip("[]")
        if not inner:
            return ()
        parts = [p.strip() for p in inner.split(",")]
        out = []
        for p in parts:
            try:
                out.append(int(p))
            except ValueError:
                try:
                    out.append(float(p))
                except ValueError:
                    out.append(p.strip("'\""))
        return tuple(out)
    if isinstance(current, int) and not isinstance(current, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(current, float):
        return float(value)
    return value


# Hydra config-group selections (`group/sub=name`), expanded to plain
# overrides. Mirrors the reference's `conf/data/datasets/*.yaml` so its
# experiment launch scripts run verbatim
# (`mask3d/experiment_launch_scripts/*.sh` pass e.g.
# `data/datasets=structured3d_room_detection`;
# `main_instance_segmentation.py:100-113` dispatches on general.train_mode).
GROUP_SELECTS = {
    "data/datasets": {
        # conf/data/datasets/structured3d_room_detection.yaml
        "structured3d_room_detection": [
            "data.dataset=structured3d",
            "data.data_root=/data/Structured3D_class21",
            "data.volume_augmentations=stru3d",
            "data.filter_out_classes=[0,17,18,19,21]",
            "data.filter_out_instance_ids=[-1,0]",
            "data.valid_scenes_file_path="
            "/data/structured3d_valid_scenes_class21.txt",
            "data.train_dataset_mode=train",
            "data.validation_dataset_mode=validation",
        ],
        # conf/data/datasets/s3dis_room_detection.yaml
        "s3dis_room_detection": [
            "data.dataset=s3dis",
            "data.data_root=/data/S3DIS_processed",
            "data.volume_augmentations=s3dis",
            "data.filter_out_classes=[]",
            "data.filter_out_instance_ids=[]",
            "data.valid_scenes_file_path=null",
            "data.train_dataset_mode=train",
            "data.validation_dataset_mode=validation",
        ],
        # conf/data/datasets/matterport3d_room_detection.yaml (train on
        # trainval, validate on the test split — its yaml hardcodes
        # mode: trainval / test)
        "matterport3d_room_detection": [
            "data.dataset=matterport3d",
            "data.data_root=/data/Matterport3D/preprocessed/v1/scans",
            "data.volume_augmentations=matterport3d",
            "data.filter_out_classes=[]",
            "data.filter_out_instance_ids=[]",
            "data.valid_scenes_file_path=null",
            "data.train_dataset_mode=trainval",
            "data.validation_dataset_mode=test",
        ],
    },
}


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply Hydra-style override strings in place: `a.b.c=value` field
    overrides and `group/sub=name` config-group selections."""
    for ov in overrides:
        ov = ov.strip()
        if not ov or ov.startswith("#"):
            continue
        key, _, value = ov.partition("=")
        key = key.strip()
        if "/" in key:
            group = GROUP_SELECTS.get(key)
            if group is None:
                raise KeyError(f"unknown config group: {key}")
            sel = group.get(value.strip())
            if sel is None:
                raise KeyError(f"unknown option {value!r} for group {key}")
            apply_overrides(cfg, sel)
            continue
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key: {key}")
        setattr(obj, leaf, _coerce(value.strip(), getattr(obj, leaf)))
    return cfg


# from mask3d_tpu/config.py:422 to_dict
def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


# from mask3d_tpu/config.py:426 flatten_dict
def flatten_dict(d: dict, parent: str = "", sep: str = "_") -> dict:
    """Reference `mask3d/utils/utils.py:16-27` (logger hyperparams)."""
    items = {}
    for k, v in d.items():
        nk = parent + sep + k if parent else k
        if isinstance(v, dict):
            items.update(flatten_dict(v, nk, sep))
        else:
            items[nk] = v
    return items


# from mask3d_tpu/config.py:438 to_yaml
def to_yaml(cfg: Config, path: str):
    import yaml

    def listify(v):
        if isinstance(v, dict):
            return {k: listify(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return [listify(x) for x in v]
        return v

    with open(path, "w") as f:
        yaml.safe_dump(listify(to_dict(cfg)), f, sort_keys=False)


# from mask3d_tpu/config.py:452 from_yaml
def from_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    cfg = Config()
    for group, values in (d or {}).items():
        obj = getattr(cfg, group)
        for k, v in values.items():
            if isinstance(v, list):
                v = tuple(v)
            setattr(obj, k, v)
    return cfg
