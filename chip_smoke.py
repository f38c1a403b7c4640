#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`mask3d_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one, or when the package is not
beside this script. Phases:

1. Card and build: prints the card's name and power limit, builds the four
   CUDA kernels from `mask3d_tpu_torch/csrc/` (one nvcc per source, in
   parallel).
2. Kernels against their plain PyTorch versions on the card, at the
   flagship's shapes: masked cross-attention at B=8, Q=25, D=128, H=8 and
   S in {3072, 6144, 12288, 24576} (max |err| <= 1e-4, a second launch
   bitwise equal, its launch plan printed; the forward's sum over the
   launches the main path counted at each S beside the bound's); the row
   gather
   with indices from a real collated batch at C in {3, 96, 128, 256} in
   f32 and at the bf16 taps C in {96, 128, 256} (bitwise equal). Each is
   timed beside its plain version, a PyTorch library call that computes
   the same function where there is one, and its bound (the row gather
   the sparse conv, the attention and the int8 conv by CUDA-graph replay:
   device time without the host's per-call cost, the eager per-call time
   beside it). The row gather
   fails its phase at a tap where it is slower than `index_select` by more
   than the spread of two timings.
3. The main path: 8 synthetic scenes collated at bucket 49152, the flagship
   Mask3D + Res16UNet34C (fp32, seeded random weights) through `infer`,
   with the kernels' launch counts read around that one forward
   (12 attention, 3 at each of the four key lengths; 13 gather), then
   post-processing and the evaluator. The
   same weights at a small width run on the CPU (plain versions) and on the
   card (kernels), and must agree.
4. The gather paths: the same scenes and weights through `infer` with
   `model.backbone_impl=gather` (fp32, no kernel: 12 attention launches)
   and `gather_pallas` (12 attention, 47 sparse conv, 0 gather launches),
   each compared with the dense forward on its outputs and backbone maps:
   `gather` within 1e-3 * max(1, std) (the same function in fp32; max
   |diff| of the maps, 99.9% quantile of the outputs), `gather_pallas`
   within a mean |diff| of 0.05 * max(1, std)
   (bf16 conv inputs at every level; the JAX package's bounds for one bf16
   level are printed beside). The sparse-conv wrapper counts its launches
   per (N, K, Cin, Cout) in that counted `gather_pallas` forward; the
   kernel is then held against its plain version at each of those shapes,
   on the batch's kernel map of that N and K (max |err| / max(1, std) <=
   1e-4, a second launch bitwise equal to the first), with its share of
   ok pairs, ms, bound, ms / bound and the forward's sums. Two faults
   planted at run time (one kernel offset dropped in every same-stride
   conv; the pooled pyramid summing instead of averaging) must each fail
   both paths' gates. Then `gather_pallas` at a
   small width and bucket 1024, card against CPU: backbone maps within the
   JAX package's bf16 bounds (outputs printed).
5. The JAX bench's inference stack on `dense` (`profile_forward.CONFIGS`),
   on the same weights: `bf16`, `int8` and `int8_chain`, each counted
   (attention 12, gather 13 of which 9 bf16, int8 conv 0 / 40 / 30 plain
   + 8 chain steps) and gated against the configuration it departs from:
   `bf16` vs fp32 and `int8` vs `bf16` on the mean |diff| of maps and
   outputs (BF16_STACK_MEAN, INT8_PATH_MEAN times max(1, std)), stage 8
   of `int8_chain` fused vs unfused on one input within the JAX package's
   tolerance (tests/test_pallas_chain.py:185-196), read STAGE8_READS times
   (each must pass; whether they are equal is printed). The int8 conv
   kernel is held against its plain version at every (grid, Cin, Cout, k,
   step) those forwards launched (bitwise, a second launch's conv, second
   output, yq and sums bitwise equal; sums within 1e-5 of sum |term|),
   with its launch
   plan and the share of its 4x4x1 fragments that hold an occupied cell,
   and timed beside cuDNN's bf16 conv3d (not the same function). Three
   faults
   planted at run time must fail their gates: the junction's residual
   dropped, the int8 activation scale doubled, the norms without their
   mean. Then `int8_chain` at a small width (MIN_ROWS 0), card against
   CPU: each fused stage on one input, median |diff| 0 and within the
   same tolerance (whole-forward maps printed).
6. Times: each forward's median over 10 runs.
7. `large_scene`: the hall scan of `bench_large_scene.py` (seed 0, bucket
   65536; its points, grid, occupied bricks and brick capacity must be the
   JAX tool's: 888,766, 1920x168x72, 5,920, 6,912) through `infer` at the
   flagship's width in bf16 on `bricked` (32x8x8 bricks), `gather_pallas`
   and `gather`, the same seeded weights: each counted (attention 3 at each
   of S = 57,344 / 114,688 / 229,376 / 458,752; row gathers 5 / 0 / 0;
   sparse convs 0 / 47 / 0), timed (median of HALL_REPS after the counted
   forward), its points/s and peak memory. Gates on outputs and maps:
   `gather` fp32 against `bricked` fp32 (the `gather` form, FP32_PATH_TOL),
   each bf16 path against `bricked` fp32 (mean |diff| within
   HALL_BF16_MEAN * max(1, std)); the bf16 gather paths against bf16
   `bricked` in the flagship `gather_pallas` form are read and printed. A
   planted fault in the hall's `bricked` (every brick's +x halo read from
   the sentinel) must fail the bf16 gate and, in fp32, the fp32 one. The
   kernels at the hall's shapes against their plain versions: the
   attention at those S (B=1), the sparse conv at every shape the counted
   `gather_pallas` forward launched (bf16 feats), the row gather at the
   brick tap (96 channels over (NB + 1) * 2048 brick cells). Then one
   flagship scene (B=1, grid rounded up to 16x16x8 bricks, the JAX tool's
   capacity rule): `bricked` against `dense` in fp32 (the `gather` form)
   and in bf16 (the `gather_pallas` form); the same planted fault must
   fail both, and a brick capacity below the occupied bricks must raise.
8. `test_entry`: `python -m mask3d_tpu_torch.cli test` in process at the
   flagship's width (`Config()` defaults, fp32 dense, seeded random
   weights) on 16 written test scenes of 3x2 rooms (two batches of 8):
   the metric keys of the JAX package's `test()`, finite losses and mAP,
   no overflow, 2 x (12, 13) attention and row-gather launches around the
   whole call, batch 1's forward against `infer(aux_masks=True)` (bitwise,
   else within ENTRY_TOL), the native voxelizer against numpy on every
   scene, seconds per batch of collation, forward + criterion,
   post-process and evaluator, and the peak device memory.

9. `train` (deterministic algorithms on from here, `loop.configure_torch`):
   (a) the attention kernel against its plain version at the sampled key
   lengths S in {200, 800, 3200, 12800}, and each autograd Function's
   backward after its kernel forward against autograd of the plain path:
   the attention at those lengths and S=3072 (ATTN_TOL), the row gather at
   the flagship taps in f32 and bf16 (bitwise), the sparse conv at every
   shape the counted `gather_pallas` forward launched (against the fp32
   gather-conv, TRAIN_FN_TOL); each backward timed beside its bound;
   (b) one dense fp32 train step at batch 8 on the main path's scenes, the
   kernels against the plain path (`cuda_build.plain_versions`): the same
   loss, every gradient leaf within TRAIN_GRAD_TOL, 12 attention launches
   (3 at each sampled length) and 13 row gathers; (d) two steps twice from
   one seed, losses and parameters bitwise equal; (e) two `gather_pallas`
   steps, finite, 47 sparse-conv launches a forward; (c) `python -m
   mask3d_tpu_torch.cli train` in process on written PLYs (batch 8 as 2 x 4,
   TRAIN_STEPS steps, one validation), the counts around the whole call,
   seconds a call of collation, forward, criterion, backward, optimizer and
   the train-split post-process and evaluator, the peak device memory, and
   `cli test` on the `last-epoch.ckpt` it wrote; (f) the peak device
   memory of one step at batch 16, whole and as 2 x 8.

10. `train_large` (deterministic algorithms on): (a) the main path's 8
   scenes as 8 micro-batches of one scene on `bricked` (16x16x8 bricks,
   every slot of the grid) in fp32: one step with the kernels (96
   attention launches, 24 at each sampled length; 40 row gathers: four
   dense taps and the brick tap a micro-batch) against one on the plain
   path (loss TRAIN_LOSS_TOL, every leaf TRAIN_GRAD_TOL), two steps twice
   from one seed bitwise equal; (b) one bf16 step each on `bricked` (8 x
   1), `gather` (2 x 4) and `gather_pallas` (batch 8; 47 sparse-conv
   launches)
   against the fp32 step of the same impl, per leaf and kernel offset
   within TRAIN_BF16_REL (`bf16_train_gate`), and two planted faults that
   must fail it (bricked: the brick tap's backward negated;
   gather_pallas: the centre offset's dW sign-flipped); (c) the hall
   scan (phase 7's scene) on `bricked` and `gather_pallas` in bf16, one
   step each (retried with `model.remat_backbone=true` where it does not
   fit), its seconds and peak memory, and the backwards at the hall's
   level-0 shapes timed beside their bounds: the sparse conv's (bf16
   feats) and the brick tap's scatter-add; (d) `cli train` on `bricked`
   (8^3 bricks) at batch 2 as two micro-batches of one scene, one
   validation at test_batch_size 1, then a second epoch resumed from its
   `last-epoch.ckpt`; (e) `cli test` with
   `trainer.measure_model_phases=true`: every `model_forward_*` segment,
   their sum within PHASE_SUM_TOL of a fenced forward of the same batch;
   and the attention at the micro-batches' key lengths (B=1).

Every line also goes to `mask3d_tpu_torch/_build/chip_smoke.log` (the
first line names it; a traceback that escapes `main()` is written there).

TF32 is switched off for convolutions and matmuls: the fp32 paths are fp32
(the `gather_pallas` convs and the bf16/int8 stack round by design).
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
ATTN_S = (3072, 6144, 12288, 24576)
ATTN_TOL = 1e-4
STAGE8_READS = 5  # readings of the stage-8 fused-vs-unfused gate
GATHER_C = {3: 1, 96: 0, 128: 2, 256: 3}  # channels -> level of that tap
# identical bf16-rounded inputs on both sides: f32 summation order only
SPCONV_TOL = 1e-4
# |diff| bounds of the JAX package for a bf16 gather-conv backbone against
# an fp32 one (tests/test_pallas_conv.py:169-173)
BF16_BOUNDS = dict(mean=5e-3, q999=5e-2, max=0.3)
# full-width path checks against the fp32 dense forward: `gather` computes
# the same function in fp32 (summation order only; max |diff| of the
# backbone maps / max(1, std)); `gather_pallas` rounds every conv input to
# bf16 (mean |diff| / max(1, std) of the maps and outputs)
FP32_PATH_TOL = 1e-3
BF16_PATH_MEAN = 0.05
BUCKET = 49152
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
BF16_GATHER_C = {96: 0, 128: 2, 256: 3}  # the bf16 grids' taps
# the JAX bench's inference stack on the dense path, and what each counted
# forward launches: int8 conv launches by chain step (30 plain int8 convs
# and 8 chain steps with the chain), row gathers by dtype (5 taps and the
# pooled backbone grid at 4 levels in bf16; the 4 coordinate taps in f32)
INT8_PATHS = ("bf16", "int8", "int8_chain")
INT8_STEPS = {"bf16": {}, "int8": {"conv": 40},
              "int8_chain": {"conv": 30, "entry": 2, "mid": 4,
                             "junction": 2}}
GATHER_BY_DTYPE = {"bfloat16": 9, "float32": 4}
# bf16 against fp32 and int8 against bf16: mean |diff| / max(1, std) of
# the backbone maps and outputs, set from the first card run between the
# sound reading and the planted faults' (PERF.md)
BF16_STACK_MEAN = 0.1
INT8_PATH_MEAN = 0.25
STAGE_OF_MAP = (4, 5, 6, 7, 8)  # the stage whose output each map taps
# the test entry: 16 test scenes (two batches of 8) and one scene of each
# other split; the keys the JAX package's `test()` returns
# (mask3d_tpu/train/trainer.py:430-437): 3 x 13 losses + "loss",
# batch_overflow and the evaluator's keys but `classes`
ENTRY_TEST_SCENES = 16
ENTRY_BATCH = 8
ENTRY_EVAL_KEYS = ("mean_ap", "mean_ap_50", "mean_ap_25",
                   "mean_precision_50", "mean_recall_50", "mean_f1_50",
                   "mean_match_IoU", "successfully_detected_rooms")
ENTRY_TOL = 1e-5  # entry vs `infer` where cuDNN picked another algorithm
# the train phase: the sampled memories' key lengths (`Config()`'s
# sample_sizes at hlevels 0-3), the steps of `cli train` (8 train scenes,
# reps_per_epoch of them), the backwards against autograd of the plain path
# (f32 sums in another order), and the whole step's gradients, kernels
# against the plain path, per leaf ||diff|| / ||plain|| (a leaf whose true
# gradient is 0 against 1e-4 of the largest leaf norm): the CPU parity
# runs read 2.2e-5 on small_config and 2.1e-3 on parity_config, whose
# stride-1 InstanceNorms amplify float32 rounding at init (PERF.md)
TRAIN_ATTN_S = (200, 800, 3200, 12800)
TRAIN_STEPS = 10
# `cli train` takes its batches of 8 as 2 micro-batches of 4: the stru3d
# augmentations rotate the scenes, and the batch's dense grid grows to
# ~2.9x the unrotated one's cells, past the card's 80 GB at batch 8 whole
# (PERF.md, the train step)
TRAIN_ACCUM = 2
TRAIN_FN_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
TRAIN_GRAD_FLOOR = 1e-4
# the large-scene phase: the hall scene of `bench_large_scene.py` (seed 0,
# bucket 65536) with the JAX tool's numbers for it; its bf16 paths, the
# forwards timed after the counted one, the attention's key lengths there
# (levels 4..1) and what each counted forward launches (bricked: the four
# dense taps and the brick tap, in bf16)
HALL = dict(points=888766, grid=(1920, 168, 72), bricks=5920, slots=11340,
            capacity=6912)
HALL_IMPLS = ("bricked", "gather_pallas", "gather")
HALL_REPS = 3
HALL_ATTN_S = (57344, 114688, 229376, 458752)
HALL_LAUNCHES = {"bricked": {"row_gather": 5, "sparse_conv": 0},
                 "gather_pallas": {"row_gather": 0, "sparse_conv": 47},
                 "gather": {"row_gather": 0, "sparse_conv": 0}}
# bricked against dense on one flagship scene (B=1): bricks of 16x16x8
BRICK_SCENE = (16, 16, 8)
# the hall's bf16 paths against its fp32 bricked forward: mean |diff| /
# max(1, std) of outputs and maps, set from the first card run between the
# sound readings (worst 0.144, gather_pallas's class logits) and the
# planted halo fault's (0.300). Two bf16 paths differ from each other by
# about as much as each differs from fp32 (0.17-0.22 of std on the class
# logits of this random-weight model), so the bf16 gather paths are held
# to the fp32 function, not to bf16 bricked (read and printed)
HALL_BF16_MEAN = 0.2
# the planted brick fault: every brick's +x halo from the sentinel
# (offset (1, 0, 0) of brick_ops._OFFS)
BRICK_FAULT_OFFSET = 22
# the train_large phase: a bf16 step's gradients against the fp32 step
# of the same impl, per leaf and kernel offset ||bf16 - fp32|| / ||fp32||
# (`bf16_train_gate`): the CPU tests' JAX bf16 step reads 1.553 at most
# on small_config (a level-0 norm of bricked; tests/torch_train_parity.py),
# a sign-flipped piece reads about 2. The cli run: 4 train scenes, 8^3
# bricks (the collator's grids are multiples of 8), a capacity that covers
# the augmented scenes' grids; the phase timer's sum against a fenced
# forward
TRAIN_BF16_REL = 1.6
TRAIN_LARGE_SCENES = 4
TRAIN_LARGE_BRICK_CAPACITY = 2048
PHASE_SUM_TOL = 0.1


LOG_FILE = None  # set by open_log


def open_log():
    """Truncate `mask3d_tpu_torch/_build/chip_smoke.log` beside this script
    and name it on the first line; every `log` line goes there too."""
    global LOG_FILE
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mask3d_tpu_torch")
    if not os.path.isdir(pkg):
        print("chip_smoke log file: none (mask3d_tpu_torch is not beside "
              "this script)", flush=True)
        return
    build = os.path.join(pkg, "_build")
    os.makedirs(build, exist_ok=True)
    LOG_FILE = os.path.join(build, "chip_smoke.log")
    open(LOG_FILE, "w").close()
    log(f"chip_smoke log file: {LOG_FILE}")


def log(*a, file=None):
    print(*a, flush=True, file=file)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            print(*a, file=f)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(torch, fn):
    """Mean device ms per call, from 20 calls captured in a CUDA graph and
    replayed (`profile_forward.graph_ms`): the host's per-call cost left
    out."""
    from mask3d_tpu_torch.profile_forward import graph_ms

    return graph_ms(fn)


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(torch, F, ma, lengths=ATTN_S, b=8):
    """Kernel vs plain at each key length (the flagship levels by default)
    at batch b; returns per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    nq, d, h = 25, 128, 8
    rows = []
    for s in lengths:
        q = torch.randn(b, nq, d, device="cuda", generator=gen)
        k = torch.randn(b, s, d, device="cuda", generator=gen)
        v = torch.randn(b, s, d, device="cuda", generator=gen)
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        count = (torch.arange(b, device="cuda") + 2) * s // 10
        mask |= torch.arange(s, device="cuda")[None, None] >= count[:, None,
                                                                   None]
        mask[0, 0] = True  # an all-blocked row: uniform weights
        mask[min(1, b - 1), 1] = False  # a fully open row
        got = ma.masked_cross_attention(q, k, v, mask, h)
        ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= ATTN_TOL
        hd = d // h
        qh = q.view(b, nq, h, hd).transpose(1, 2)
        kh = k.view(b, s, h, hd).transpose(1, 2)
        vh = v.view(b, s, h, hd).transpose(1, 2)
        add = torch.zeros(b, 1, nq, s, device="cuda").masked_fill(
            mask[:, None], -1e9)
        again = ma.masked_cross_attention(q, k, v, mask, h)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got, again))
        p = ma.plan(b, nq, s, h, hd)
        row = dict(
            S=s, B=b, max_abs_err=err, ok=ok and repeat, repeat_equal=repeat,
            plan=dict(ksl=p.ksl, hg=p.hg, threads=p.threads, chunk=p.chunk,
                      nch=p.nch, queries=p.queries),
            ms=time_graph_ms(torch, lambda: ma.masked_cross_attention(
                q, k, v, mask, h)),
            eager_ms=time_ms(torch, lambda: ma.masked_cross_attention(
                q, k, v, mask, h)),
            plain_ms=time_ms(torch, lambda: ma.masked_cross_attention_plain(
                q, k, v, mask, h), iters=5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=add)),
        )
        nbytes = 4 * (2 * b * nq * d + 2 * b * s * d) + b * nq * s
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * b * nq * s * d)
        log(f"attention B={b} S={s}: max|err| {err:.3g} (tol {ATTN_TOL}), "
            f"second "
            f"launch bitwise equal {repeat}; kernel {row['ms']:.4f} ms "
            f"(eager per call {row['eager_ms']:.4f}) plain "
            f"{row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plan "
            f"{row['plan']}")
        rows.append(row)
        del q, k, v, mask, add
    return rows


def check_gather(torch, rg, dense_ops, batch, caps, dtype=None,
                 taps=GATHER_C):
    """Kernel vs plain with idx/ok from a real batch's static keys, in f32
    or bf16 rows. The kernel and `index_select` on the same rows are each
    timed twice (device time), in turns; `fast` holds where the kernel's
    mean time over index_select's is at most 1 + the spread of two timings:
    the larger relative gap between one call's two readings, measured here
    and printed beside the ratio (PERF.md keeps its readings)."""
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(1)
    sb = build_sparse_batch(
        batch.coords, batch.counts, batch.dims,
        caps, batch.grid_dims)
    rows = []
    for c, li in taps.items():
        gd = batch.grid_dims[li]
        cells = gd[0] * gd[1] * gd[2]
        lvl = sb.levels[li]
        idx = dense_ops.static_keys(lvl, gd).clamp(0, cells - 1).to(
            torch.int32).contiguous()
        ok = lvl.valid.contiguous()
        b, m = idx.shape
        src = torch.randn(b, cells, c, device="cuda", generator=gen).to(
            dtype)
        row = dict(C=c, level=li, rows=b * m, dtype=str(dtype)[6:],
                   **time_gather(torch, rg, src, idx, ok))
        equal, spread = row["equal"], row["timing_spread"]
        log(f"row_gather {row['dtype']} C={c} level {li} rows {b * m}: "
            f"bitwise equal "
            f"{equal} kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
            f"ms index_select {row['library_ms']:.4f} ms (kernel / "
            f"index_select {row['ratio_to_library']:.3f}, timing spread "
            f"{spread:.3f}, fast {row['fast']}) bound "
            f"{row['bound_ms']:.4f} ms; eager per call: kernel "
            f"{row['eager_ms']:.4f} ms index_select "
            f"{row['library_eager_ms']:.4f} ms")
        rows.append(row)
    return rows


def time_gather(torch, rg, src, idx, ok):
    """The row gather against its plain version (bitwise) on src [B, N, C],
    idx/ok [B, M], and timed beside it, `index_select` on the same rows and
    the bytes bound (see `check_gather`)."""
    b, n, c = src.shape
    m = idx.shape[1]
    esize = src.element_size()
    got = rg.row_gather(src, idx, ok)
    ref = rg.row_gather_plain(src, idx, ok)
    torch.cuda.synchronize()
    flat = src.view(b * n, c)
    fidx = (idx.long() + torch.arange(b, device="cuda")[:, None]
            * n).view(-1)

    def kernel():
        return time_graph_ms(torch, lambda: rg.row_gather(src, idx, ok))

    def library():
        return time_graph_ms(torch, lambda: flat.index_select(0, fidx))

    k1, l1, l2, k2 = kernel(), library(), library(), kernel()
    spread = max(abs(k1 - k2) / min(k1, k2), abs(l1 - l2) / min(l1, l2))
    row = dict(
        equal=bool(torch.equal(got, ref)),
        max_abs_err=(got.float() - ref.float()).abs().max().item(),
        ms=(k1 + k2) / 2,
        eager_ms=time_ms(torch, lambda: rg.row_gather(src, idx, ok)),
        plain_ms=time_ms(torch, lambda: rg.row_gather_plain(src, idx, ok)),
        library_ms=(l1 + l2) / 2,
        library_eager_ms=time_ms(torch, lambda: flat.index_select(0, fidx)),
        timing_spread=spread,
    )
    row["ratio_to_library"] = row["ms"] / row["library_ms"]
    row["fast"] = row["ratio_to_library"] <= 1.0 + spread
    n_ok = int(ok.sum())
    nbytes = b * m * 5 + n_ok * c * esize + b * m * c * esize
    row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
    return row


def kernel_map(sb, n, k):
    """(level, idx, ok): the batch's kernel map of N rows and K offsets."""
    maps = list(zip(range(sb.num_levels), sb.nbr_idx, sb.nbr_ok))
    maps.append((0, sb.nbr0_idx, sb.nbr0_ok))
    for level, idx, ok in maps:
        if idx is not None and tuple(idx.shape[1:]) == (n, k):
            return level, idx, ok
    raise LookupError(f"no kernel map with N={n}, K={k}")


def check_sparse_conv(torch, sc, sb, shape_launches, dtype=None):
    """Kernel vs plain at each (N, K, Cin, Cout) the counted forward
    launched, on the real batch's kernel map of that N and K, with feats
    in `dtype` (f32 by default; the bf16 backbone's rows are bf16), and a
    second launch on the same input, which must be bitwise equal to the
    first;
    returns per-shape rows with the share of (row, offset) pairs ok and of
    (16-row m-fragment, offset) pairs with an ok row (the kernel's unit of
    work), ms, bound and ms / bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (n, k, cin, cout), n_launch in sorted(
            shape_launches.items(), key=lambda kv: (-kv[0][0],) + kv[0][1:]):
        level, idx, ok = kernel_map(sb, n, k)
        b = idx.shape[0]
        feats = torch.randn(b, n, cin, device="cuda", generator=gen)
        feats *= sb.levels[level].valid[..., None]
        feats = feats.to(dtype or torch.float32)
        w = torch.randn(k, cin, cout, device="cuda", generator=gen) / (
            k * cin) ** 0.5
        got = sc.sparse_conv(feats, w, idx, ok)
        again = sc.sparse_conv(feats, w, idx, ok)
        ref = sc.sparse_conv_plain(feats, w, idx, ok)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got, again))
        err = (got - ref).abs().max().item()
        scaled = err / max(1.0, ref.std().item())
        esize = feats.element_size()
        n_ok = int(ok.sum())
        frag_live = ok.reshape(-1, 16, k).any(dim=1).float().mean().item()
        row = dict(
            level=level, N=n, K=k, Cin=cin, Cout=cout, launches=n_launch,
            rows=b * n, ok_pairs=n_ok, ok_share=n_ok / (b * n * k),
            fragment_share=frag_live, max_abs_err=err, scaled_err=scaled,
            repeat_equal=repeat,
            ok=bool(torch.isfinite(got).all()) and scaled <= SPCONV_TOL
            and repeat,
            ms=time_graph_ms(torch, lambda: sc.sparse_conv(
                feats, w, idx, ok)),
            eager_ms=time_ms(torch, lambda: sc.sparse_conv(
                feats, w, idx, ok)),
            plain_ms=time_ms(torch, lambda: sc.sparse_conv_plain(
                feats, w, idx, ok), iters=3, warmup=1),
            library_ms=None,  # no single PyTorch call is a gather-conv
        )
        nbytes = b * n * k * 5 + b * n * cin * esize + \
            k * cin * cout * 2 + b * n * cout * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * n_ok * cin * cout, BF16_FLOPS_PER_S)
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        log(f"sparse_conv L{level} N={n} K={k} {cin}->{cout} "
            f"{str(feats.dtype)[6:]} x{n_launch}: "
            f"max|err| {err:.3g} scaled {scaled:.3g} (tol {SPCONV_TOL}), "
            f"second launch bitwise equal {repeat}; kernel {row['ms']:.4f} "
            f"ms (eager per call {row['eager_ms']:.4f}) plain "
            f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}), {row['ms_over_bound']:.1f}x; ok pairs "
            f"{row['ok_share']:.3f}, fragments with an ok row "
            f"{frag_live:.3f}")
        rows.append(row)
        del feats, w, got, again, ref
    log(f"sparse_conv forward sums (launches x ms): "
        f"{sum(r['launches'] * r['ms'] for r in rows):.4f} ms, bound "
        f"{sum(r['launches'] * r['bound_ms'] for r in rows):.4f} ms")
    return rows


def diff_stats(np, ref, got):
    """|got - ref| summary: mean, 99.9% quantile, max, and std(ref)."""
    ref = np.asarray(ref, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - ref)
    return dict(mean=float(diff.mean()), q999=float(np.quantile(diff, 0.999)),
                max=float(diff.max()), ref_std=float(ref.std()))


def within_bf16_bounds(stats):
    return all(stats[k] < v for k, v in BF16_BOUNDS.items())


def worst_ratio(stats, key, tol):
    """max over the compared tensors of stats[key] / (tol * max(1,
    std(ref))): the gate passes at <= 1."""
    return max(st[key] / (tol * max(1.0, st["ref_std"]))
               for st in stats.values())


def gate_ratio(path, stats):
    """A path's gate against the dense forward; passes at <= 1. `gather`:
    max |diff| of the backbone maps and the 99.9% quantile of the outputs
    (summation order can flip a threshold of the decoder's attention masks
    and move a few output values) within FP32_PATH_TOL * max(1, std);
    `gather_pallas`: mean |diff| of both within BF16_PATH_MEAN * max(1,
    std)."""
    if path == "gather":
        return max(
            st["q999" if what.startswith("pred") else "max"]
            / (FP32_PATH_TOL * max(1.0, st["ref_std"]))
            for what, st in stats.items())
    return worst_ratio(stats, "mean", BF16_PATH_MEAN)


def backbone_maps(torch, mdl, cfg, dev, sparse):
    """The five backbone feature maps [strides 16..1] as numpy arrays of
    their valid rows, through the context `infer` would build."""
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    with torch.inference_mode():
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg, dev.capacity), dev.grid_dims,
            **sb_kwargs(cfg))
        _, maps, _ = mdl.backbone(dev.feats, sb, dev.grid_dims)
        n = sb.num_levels
        return [m[sb.levels[n - 1 - i].valid].float().cpu().numpy()
                for i, m in enumerate(maps)]


def small_models(mt, cfg_mod, synth, np, impl, bucket,
                 backbone="Res16UNet14A", extra=()):
    """The small-width config, batch and one set of weights on the CPU and
    on the card."""
    ov = ["model.hidden_dim=32", "model.dim_feedforward=64",
          "model.num_queries=8", "model.num_heads=4",
          "model.num_decoders=2", f"model.backbone={backbone}",
          "model.conv1_kernel_size=3",
          f"data.point_bucket_multiple={bucket}",
          f"model.backbone_impl={impl}", *extra]
    cfg = cfg_mod.apply_overrides(cfg_mod.Config(), ov)
    rng = np.random.default_rng(3)
    items = [synth(rng, num_rooms_x=3, num_rooms_y=2, room_size=12,
                   height=6, jitter=0.0, dropout=0.5) for _ in range(2)]
    host = mt.collate(items, device="cpu", point_bucket_multiple=bucket)
    cpu_model = mt.build_model(cfg, device="cpu", seed=5)
    gpu_model = mt.build_model(cfg, device="cuda", seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cfg, host, cpu_model, gpu_model


def small_reference(torch, mt, cfg_mod, synth, np):
    """Same weights at a small width: the card (kernels) against the CPU
    (plain versions). Returns the max |diff| / max(1, std) over both
    outputs."""
    cfg, host, cpu_model, gpu_model = small_models(mt, cfg_mod, synth, np,
                                                   "dense", 512)
    ref, _ = mt.infer(cpu_model, host.device, cfg, aux_masks=True,
                      device="cpu")
    got, _ = mt.infer(gpu_model, host.device, cfg, aux_masks=True,
                      device="cuda")
    worst = 0.0
    for r, g in ((ref.aux_pred_class, got.aux_pred_class),
                 (ref.aux_pred_masks, got.aux_pred_masks)):
        scale = max(1.0, float(r.std()))
        worst = max(worst, float((g.cpu() - r).abs().max()) / scale)
    return worst


def small_reference_gather(torch, mt, cfg_mod, synth, np, sparse):
    """`gather_pallas` at a small width and bucket 1024 (levels 0 and 1
    take the kernel), card against CPU: diff_stats of the backbone's
    feature maps and of the final outputs."""
    cfg, host, cpu_model, gpu_model = small_models(
        mt, cfg_mod, synth, np, "gather_pallas", 1024)
    ref = backbone_maps(torch, cpu_model, cfg, host.device, sparse)
    got = backbone_maps(torch, gpu_model, cfg, host.device.to("cuda"),
                        sparse)
    maps = [diff_stats(np, r, g) for r, g in zip(ref, got)]
    out_ref, _ = mt.infer(cpu_model, host.device, cfg, device="cpu")
    out_got, _ = mt.infer(gpu_model, host.device, cfg, device="cuda")
    final = {w: diff_stats(np, getattr(out_ref, w).numpy(),
                           getattr(out_got, w).cpu().numpy())
             for w in ("pred_class", "pred_masks")}
    return maps, final


def int8_inputs(torch, gen, occ, cin, cout, k, step, res_dtype=None):
    """Inputs of one int8 conv call on the batch's occupancy grid `occ`:
    an int8 grid (steps conv and entry, with the 1x1 second output where
    the widths differ, as a chain's entry has) or a bf16 raw grid with
    norm-like affines, a quantize multiplier and, at a junction, a
    residual of `res_dtype`."""
    b, dims = occ.shape[0], tuple(occ.shape[1:4])

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def int8_grid(c):
        q = torch.randint(-127, 128, (b,) + dims + (c,), generator=gen,
                          device="cuda", dtype=torch.int32)
        return (q * occ.int()).to(torch.int8)

    wq = torch.randint(-127, 128, (k ** 3, cin, cout), generator=gen,
                       device="cuda", dtype=torch.int32).to(torch.int8)
    sw = rnd(cout).abs() * 1e-3 + 1e-4
    kw = dict(stats=step != "conv")
    if step in ("conv", "entry"):
        if step == "entry" and cin != cout:
            kw["wdq"] = torch.randint(
                -127, 128, (1, cin, cout), generator=gen, device="cuda",
                dtype=torch.int32).to(torch.int8)
            kw["swd"] = rnd(cout).abs() * 1e-3 + 1e-4
        return (int8_grid(cin), occ, wq, sw, "none"), kw
    x = (rnd(*((b,) + dims + (cin,))) * occ).bfloat16()
    kw.update(A=rnd(b, cin) * 0.2 + 1.0, Bc=rnd(b, cin) * 0.2,
              inv=127.0 / (rnd(cin).abs() * 2 + 3))
    if step == "mid":
        return (x, occ, wq, sw, "affine"), kw
    if res_dtype == torch.int8:
        kw.update(res=int8_grid(cin), Ar=rnd(b, cin).abs() * 0.01 + 0.01,
                  Br=torch.zeros(b, cin, device="cuda"))
    else:
        kw.update(res=(rnd(*((b,) + dims + (cin,))) * occ).bfloat16(),
                  Ar=rnd(b, cin) * 0.2 + 1.0, Br=rnd(b, cin) * 0.2)
    return (x, occ, wq, sw, "join"), kw


def stats_within(torch, got, outs, ref):
    """Each per-(item, channel) sum within 1e-5 of sum |term|."""
    terms = []
    for o in outs:
        r = o.float()
        terms += [r.abs().sum(dim=(1, 2, 3)), (r * r).sum(dim=(1, 2, 3))]
    scale = torch.stack(terms, dim=1)
    return bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


def check_int8_conv(torch, F, ic, sb, shape_launches):
    """Kernel vs plain at each (grid dims, Cin, Cout, k, step) the counted
    int8 forwards launched, on the batch's occupancy at that grid (a
    junction with an int8 and a bf16 residual); conv outputs and yq
    bitwise, sums within 1e-5 of sum |term|. Times beside the plain
    version, cuDNN's bf16 conv3d at the same shape (not the same function:
    no int8 conv3d exists in PyTorch) and the bound, with the operations of
    the whole grid and of the occupied outputs only."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    level_of = {tuple(o.shape[1:4]): li for li, o in enumerate(sb.occ)}
    rows = []
    for (dims, cin, cout, k, step), n_launch in sorted(
            shape_launches.items(), key=lambda kv: (kv[0][4], kv[0][:4])):
        occ = sb.occ[level_of[dims]]
        variants = ((torch.int8, torch.bfloat16) if step == "junction"
                    else (None,))
        for res_dtype in variants:
            args, kw = int8_inputs(torch, gen, occ, cin, cout, k, step,
                                   res_dtype)
            got = ic.int8_conv(*args, **kw)
            again = ic.int8_conv(*args, **kw)
            ref = ic.int8_conv_plain(*args, **kw)
            torch.cuda.synchronize()
            equal = torch.equal(got.out, ref.out) and all(
                (a is None and r is None) or torch.equal(a, r)
                for a, r in ((got.out2, ref.out2), (got.yq, ref.yq)))
            # the f32 stats too: the kernel adds them in a fixed order
            repeat = torch.equal(got.out, again.out) and all(
                a is None or torch.equal(a, a2)
                for a, a2 in ((got.out2, again.out2), (got.yq, again.yq),
                              (got.stats, again.stats)))
            p = ic.plan(occ.shape[0], dims, cin, cout, k, args[4])
            outs = [ref.out] + ([ref.out2] if ref.out2 is not None else [])
            stats_ok = not kw["stats"] or stats_within(
                torch, got.stats, outs, ref.stats)
            err = (got.out.float() - ref.out.float()).abs().max().item()
            x = args[0]
            xb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
            wb = args[2].to(torch.bfloat16).reshape(
                k, k, k, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
            cells = occ[..., 0].numel()
            occupied = int(occ.sum().item())
            nbytes = cells * (cin * x.element_size() + 4 + 2 * cout) + \
                k ** 3 * cin * cout
            ops = 2 * k ** 3 * cin * cout
            if kw.get("res") is not None:
                nbytes += cells * cin * kw["res"].element_size()
            if step == "junction":
                nbytes += cells * cin  # yq
            if kw.get("wdq") is not None:
                nbytes += cells * 2 * cout + cin * cout
                ops += 2 * cin * cout
            row = dict(
                step=step, grid=list(dims), Cin=cin, Cout=cout, k=k,
                res=None if res_dtype is None else str(res_dtype)[6:],
                launches=n_launch, cells=cells, occupied=occupied,
                equal=equal, repeat_equal=repeat, stats_ok=stats_ok,
                max_abs_err=err,
                plan=dict(tile=p.tile, splits=p.splits, kcs=p.kcs,
                          mf=p.mf, smem=p.smem),
                live_fragment_share=ic.live_fragment_share(occ),
                ms=time_graph_ms(torch, lambda: ic.int8_conv(*args, **kw)),
                eager_ms=time_ms(torch, lambda: ic.int8_conv(*args, **kw)),
                plain_ms=time_ms(torch, lambda: ic.int8_conv_plain(
                    *args, **kw), iters=1, warmup=0),
                library_ms=None,  # no PyTorch call is an int8 conv3d
                cudnn_bf16_ms=time_ms(torch, lambda: F.conv3d(
                    xb, wb, padding=k // 2)),
            )
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, ops * occupied, INT8_OPS_PER_S)
            row["bound_ms_whole_grid"], row["bound_by_whole_grid"] = bound(
                nbytes, ops * cells, INT8_OPS_PER_S)
            log(f"int8_conv {step} {list(dims)} {cin}->{cout} k{k} "
                f"res {row['res']} x{n_launch}: bitwise {equal}, second "
                f"launch bitwise equal {repeat}, stats within 1e-5 "
                f"{stats_ok}; plan "
                f"{row['plan']}, live 4x4x1 fragments "
                f"{row['live_fragment_share']:.3f}; "
                f"kernel {row['ms']:.4f} ms (eager per call "
                f"{row['eager_ms']:.4f}) plain "
                f"{row['plain_ms']:.4f} ms cuDNN bf16 conv3d (not the same "
                f"function) {row['cudnn_bf16_ms']:.4f} ms; bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, occupied "
                f"outputs {occupied / cells:.3f}) / whole grid "
                f"{row['bound_ms_whole_grid']:.4f} ms")
            rows.append(row)
            del args, kw, got, again, ref, xb, wb
    return rows


def backbone_run(torch, bb_mod, mdl, cfg, dev, sparse, stages_in=()):
    """The backbone through the context `infer` builds: its five maps as
    numpy valid rows, its final level-0 grid and the static bound each
    stage returned; for each stage number in `stages_in`, also that
    stage's (ctx, input, input bound)."""
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    real = bb_mod.Res16UNetBase._blocks
    bounds, inputs = {}, {}

    def recording(self, ctx, stage, x, level_idx, bin_=None):
        if stage in stages_in:
            inputs[stage] = dict(ctx=ctx, x=x, bound=bin_)
        out = real(self, ctx, stage, x, level_idx, bin_)
        bounds[stage] = out[1]
        return out

    bb_mod.Res16UNetBase._blocks = recording
    try:
        with torch.inference_mode():
            sb = build_sparse_batch(
                dev.coords, dev.counts, dev.dims,
                level_capacities(cfg, dev.capacity), dev.grid_dims,
                **sb_kwargs(cfg))
            _, maps, grid = mdl.backbone(dev.feats, sb, dev.grid_dims)
            n = sb.num_levels
            rows = [m[sb.levels[n - 1 - i].valid].float().cpu().numpy()
                    for i, m in enumerate(maps)]
    finally:
        bb_mod.Res16UNetBase._blocks = real
    return dict(maps=rows, grid=grid, bounds=bounds, occ=sb.occ[0],
                inputs=inputs)


def chain_tol_ratio(torch, want, got, bound, occ):
    """The JAX package's fused-vs-unfused tolerance
    (tests/test_pallas_chain.py:185-196) on two grids or row sets of one
    stage's output: |diff| <= 3 step + 0.02 |want| + 0.02 everywhere,
    step = bound / 127; returns (max |diff| / tol, median |diff| over
    occupied cells, median step): it passes at ratio <= 1 and median
    |diff| < median step."""
    want = torch.as_tensor(want).float()
    got = torch.as_tensor(got).float().to(want.device)
    step = (bound.float() / 127.0).to(want.device)
    diff = (got - want).abs()
    tol = 3.0 * step + 0.02 * want.abs() + 0.02
    if occ is not None:
        diff_occ = diff[occ[..., 0].to(want.device) > 0]
    else:
        diff_occ = diff
    return (float((diff / tol).max()), float(diff_occ.median()),
            float(step.median()))



def write_entry_dataset(np, root, n_train=1, n_test=ENTRY_TEST_SCENES):
    """Structured3D layout (`scene_NNNNN/point_cloud_rasterized_150.ply`,
    binary PLY with float32 x, y, z, so the coordinates round-trip exactly)
    of the flagship's scenes (`profile_forward.flagship_items`): the train
    scenes 0..., one validation scene and the test scenes 3250..."""
    from mask3d_tpu_torch.data.ply import write_ply
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(0)
    scenes = [f"scene_{i:05d}" for i in range(n_train)] + [
        "scene_03000"] + [f"scene_{3250 + i:05d}" for i in range(n_test)]
    for scene in scenes:
        item = make_synthetic_scene(rng, num_rooms_x=3, num_rooms_y=2,
                                    room_size=36, height=18, jitter=0.3,
                                    dropout=0.2, multi_floor=True)
        c, lab = item["coordinates"], item["labels"]
        os.makedirs(os.path.join(root, scene))
        write_ply(os.path.join(root, scene,
                               "point_cloud_rasterized_150.ply"),
                  {"x": c[:, 0], "y": c[:, 1], "z": c[:, 2],
                   "type": lab[:, 0], "room_id": lab[:, 1]}, text=False)
    return scenes


def count_forward(torch, mt, counters, by_key, mdl, dev, cfg):
    """One `infer` with every count set to 0 just before it and read just
    after: (output, launches, counts by key, peak GiB). Raises where a
    pyramid level or the level-0 bricks overflowed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for counts, _ in by_key.values():
        counts.clear()
    out, overflow = mt.infer(mdl, dev, cfg, device="cuda")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    keyed = {k: dict(counts) for k, (counts, _) in by_key.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if bool(overflow):
        raise RuntimeError("a pyramid level or the level-0 bricks "
                           "overflowed their capacity")
    return out, launches, keyed, peak


def check_brick_tap(torch, rg, bo, sb, spec, c):
    """The row gather at the bricked path's level-0 tap: rows of the whole
    flattened brick tensor [(NB + 1) * cells, C] (bf16, random) at the
    scene's `row_flat` (not monotone), against its plain version, timed."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tables = bo.build_tables(sb.levels[0], spec)
    n_src = (spec.capacity + 1) * spec.cells
    src = torch.randn(1, n_src, c, device="cuda", generator=gen).to(
        torch.bfloat16)
    idx = tables.row_flat.clamp(0, n_src - 1).to(torch.int32)[None]
    ok = sb.levels[0].valid.contiguous()
    row = dict(C=c, level=0, rows=idx.shape[1], source_rows=n_src,
               dtype="bfloat16", **time_gather(torch, rg, src, idx.contiguous(),
                                                ok))
    log(f"row_gather bf16 brick tap C={c}: {row['rows']} rows from "
        f"{n_src} brick cells, bitwise equal {row['equal']}; kernel "
        f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms index_select "
        f"{row['library_ms']:.4f} ms (kernel / index_select "
        f"{row['ratio_to_library']:.3f}, timing spread "
        f"{row['timing_spread']:.3f}) bound {row['bound_ms']:.4f} ms")
    return row


class sentinel_halo:
    """A planted fault, patched in for a `with` block: every level-0
    brick reads its +x halo from the zero sentinel."""

    def __init__(self, bo):
        self.bo, self.real = bo, bo.build_tables

    def __enter__(self):
        real = self.real

        def faulty(level, spec):
            tables = real(level, spec)
            tables.nbr[:, BRICK_FAULT_OFFSET] = spec.capacity
            return tables

        self.bo.build_tables = faulty

    def __exit__(self, *exc):
        self.bo.build_tables = self.real


def run_large_scene(torch, F, np, mt, counters, by_key, sparse, kernels):
    """The `large_scene` phase (see the docstring's phase 7). Every gate
    is read before the first failing one raises, at the end."""
    from mask3d_tpu_torch import bench_large_scene as bls
    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.profile_forward import flagship_items
    from mask3d_tpu_torch.sparse import brick_ops as bo

    ma, rg, sc = kernels
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    t = time.perf_counter()
    host = bls.hall_batch("cpu")
    lines, brick, cap = bls.geometry_lines(host.device)
    _, nb, slots, _ = bls.brick_geometry(host.device)
    got = dict(points=int(host.device.counts.sum()),
               grid=tuple(host.device.grid_dims[0]), bricks=nb, slots=slots,
               capacity=cap)
    log(f"hall scene collated in {time.perf_counter() - t:.2f} s: {got}")
    for line in lines:
        log(f"  {line}")
    assert got == HALL, (got, HALL)
    dev = host.device.to("cuda")
    n_pts = got["points"]
    valid = np.arange(dev.capacity)[None] < \
        host.device.counts.numpy()[:, None]
    res = {"scene": got, "brick": brick, "impls": {}, "gates": {}}
    failed = []
    runs = {}
    def outputs_and_maps(mdl, cfg, out=None):
        """pred_class, the valid rows of pred_masks and the backbone maps
        of one hall forward (`out`: that of a forward already run)."""
        with torch.inference_mode():
            if out is None:
                out, _ = mt.infer(mdl, dev, cfg, device="cuda")
            return dict(preds=(out.pred_class.cpu().numpy(),
                               out.pred_masks.cpu().numpy()[valid]),
                        maps=backbone_maps(torch, mdl, cfg, dev, sparse))

    for impl in HALL_IMPLS:
        cfg = bls.variant_cfg(impl, "per_offset", brick, cap)
        mdl = mt.build_model(cfg, device="cuda", seed=0)
        out, launches, keyed, peak = count_forward(
            torch, mt, counters, by_key, mdl, dev, cfg)
        want = dict(HALL_LAUNCHES[impl], masked_attention=12, int8_conv=0)
        assert launches == want, (impl, launches, want)
        assert keyed["attention"] == {s: 3 for s in HALL_ATTN_S}, keyed
        pc, pm = out.pred_class, out.pred_masks
        assert tuple(pc.shape) == (1, 25, 2) and tuple(pm.shape) == (
            1, dev.capacity, 25), (pc.shape, pm.shape)
        assert bool(torch.isfinite(pc).all()) and bool(
            torch.isfinite(pm).all()), "non-finite outputs"
        runs[impl] = outputs_and_maps(mdl, cfg, out)
        del out, pc, pm
        ms = []
        for _ in range(HALL_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(mdl, dev, cfg, device="cuda")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(ms)
        res["impls"][impl] = dict(
            launches=launches, attention_by_S=keyed["attention"],
            sparse_conv_by_shape=keyed["sparse_conv"],
            gather_by_dtype=keyed["gather_dtypes"], ms=med, ms_all=ms,
            points_per_s=n_pts / med * 1e3, peak_gib=peak)
        log(f"hall {impl} bf16: launches {launches}, row gathers by dtype "
            f"{keyed['gather_dtypes']}; {med:.1f} ms a forward (median of "
            f"{HALL_REPS} after the counted one: "
            f"{', '.join(f'{m:.1f}' for m in ms)}) = "
            f"{n_pts / med * 1e3:.0f} pts/s; peak {peak:.2f} GiB")
        del mdl
        torch.cuda.empty_cache()
    # the fp32 references (bricked, gather) and the planted fault (every
    # brick's +x halo from the sentinel) in bf16 and fp32
    for name, impl, dtype, fault in (
            ("bricked fp32", "bricked", None, False),
            ("gather fp32", "gather", None, False),
            ("bricked with a planted fault", "bricked", "bfloat16", True),
            ("bricked fp32 with a planted fault", "bricked", None, True)):
        cfg = bls.variant_cfg(impl, "per_offset", brick, cap, dtype)
        mdl = mt.build_model(cfg, device="cuda", seed=0)
        if fault:
            with sentinel_halo(bo):
                runs[name] = outputs_and_maps(mdl, cfg)
        else:
            runs[name] = outputs_and_maps(mdl, cfg)
        del mdl
        torch.cuda.empty_cache()

    def stats_of(ref, run):
        stats = {"pred_class": diff_stats(np, ref["preds"][0],
                                          run["preds"][0]),
                 "pred_masks": diff_stats(np, ref["preds"][1],
                                          run["preds"][1])}
        for i, (r, g) in enumerate(zip(ref["maps"], run["maps"])):
            stats[f"map{i} (stride {16 >> i})"] = diff_stats(np, r, g)
        return stats

    def hall_gate(ref, name, fp32):
        """`name` against `ref`: fp32, the `gather` form (FP32_PATH_TOL);
        bf16, the mean form (HALL_BF16_MEAN)."""
        stats = stats_of(runs[ref], runs[name])
        for what, st in stats.items():
            log(f"hall {name} vs {ref} {what}: {json.dumps(st)}")
        return (gate_ratio("gather", stats) if fp32
                else worst_ratio(stats, "mean", HALL_BF16_MEAN))

    res["gates"]["gather fp32"] = hall_gate("bricked fp32", "gather fp32",
                                            True)
    for impl in HALL_IMPLS:
        res["gates"][f"{impl} bf16"] = hall_gate("bricked fp32", impl, False)
    log(f"hall gates against bricked fp32 (pass at <= 1): {res['gates']}")
    if not all(r <= 1.0 for r in res["gates"].values()):
        failed.append(("hall gates", res["gates"]))
    # read, not gated: the bf16 gather paths against bf16 bricked, in the
    # form of the flagship's gather_pallas gate (BF16_PATH_MEAN)
    res["bf16_vs_bricked_bf16"] = {
        impl: worst_ratio(stats_of(runs["bricked"], runs[impl]), "mean",
                          BF16_PATH_MEAN) for impl in HALL_IMPLS[1:]}
    log(f"hall bf16 gather paths against bf16 bricked, mean |diff| / "
        f"({BF16_PATH_MEAN} * max(1, std)), read: "
        f"{res['bf16_vs_bricked_bf16']}")
    res["hall_fault"] = {
        "bf16": hall_gate("bricked fp32", "bricked with a planted fault",
                          False),
        "fp32": hall_gate("gather fp32", "bricked fp32 with a planted fault",
                          True)}
    log(f"planted fault 'the +x halo from the sentinel' on the hall's "
        f"bricked: gate ratios {res['hall_fault']} (must be > 1)")
    if not all(not r <= 1.0 for r in res["hall_fault"].values()):
        failed.append(("planted hall fault passed", res["hall_fault"]))
    del runs

    # the kernels at the hall scene's shapes
    res["attention"] = check_attention(torch, F, ma, HALL_ATTN_S, b=1)
    for r in res["attention"]:
        r["launches"] = res["impls"]["bricked"]["attention_by_S"][r["S"]]
    if not all(r["ok"] for r in res["attention"]):
        failed.append("attention at the hall's key lengths")
    cfg_gp = bls.variant_cfg("gather_pallas", "per_offset", brick, cap)
    with torch.inference_mode():
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg_gp, dev.capacity), dev.grid_dims,
            **sb_kwargs(cfg_gp))
    shapes = res["impls"]["gather_pallas"]["sparse_conv_by_shape"]
    log(f"hall sparse_conv launches by (N, K, Cin, Cout): {shapes}")
    res["sparse_conv"] = check_sparse_conv(torch, sc, sb, shapes,
                                           torch.bfloat16)
    if not all(r["ok"] for r in res["sparse_conv"]):
        failed.append("sparse conv at the hall's shapes")
    del sb
    cfg_b = bls.variant_cfg("bricked", "per_offset", brick, cap)
    with torch.inference_mode():
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg_b, dev.capacity), dev.grid_dims,
            **sb_kwargs(cfg_b))
    tap = check_brick_tap(torch, rg, bo, sb,
                          bo.make_brick_spec(dev.grid_dims[0], brick, cap),
                          96)
    tap["launches"] = 1  # a bricked forward's level-0 tap
    res["brick_tap"] = tap
    if not tap["equal"]:
        failed.append("row gather at the brick tap")
    del sb, dev
    torch.cuda.empty_cache()

    # bricked against dense on one flagship scene (B=1), fp32 and bf16,
    # the planted faults after
    items = flagship_items()[:1]
    one = mt.collate(items, device="cpu", point_bucket_multiple=BUCKET)
    # the grid dims rounded up to whole bricks (the collator's floor)
    floor = [-(-int(g) // b) * b
             for g, b in zip(one.device.grid_dims[0], BRICK_SCENE)]
    one = mt.collate(items, device="cuda", point_bucket_multiple=BUCKET,
                     min_grid_dims=floor).device
    _, nb1, _, cap1 = bls.brick_geometry(one, BRICK_SCENE)
    log(f"flagship scene 0: grid {one.grid_dims[0]}, {nb1} occupied "
        f"{BRICK_SCENE} bricks, capacity {cap1}")

    def cfg_of(impl, dtype, capacity=cap1):
        ov = [f"data.point_bucket_multiple={BUCKET}",
              f"model.backbone_impl={impl}",
              "model.brick_dims=[{},{},{}]".format(*BRICK_SCENE),
              f"model.brick_capacity={capacity}"]
        return apply_overrides(Config(), ov + (
            [f"model.compute_dtype={dtype}"] if dtype else []))

    def run_of(impl, dtype):
        c = cfg_of(impl, dtype)
        mdl = mt.build_model(c, device="cuda", seed=0)
        out, _, _, _ = count_forward(torch, mt, counters, by_key, mdl, one,
                                     c)
        v = one.counts.cpu().numpy()
        v = np.arange(one.capacity)[None] < v[:, None]
        return dict(preds=(out.pred_class.cpu().numpy(),
                           out.pred_masks.cpu().numpy()[v]),
                    maps=backbone_maps(torch, mdl, c, one, sparse))

    def gate(dtype, ref, run):
        stats = stats_of(ref, run)
        return (gate_ratio("gather", stats) if dtype is None
                else worst_ratio(stats, "mean", BF16_PATH_MEAN)), stats

    dense = {}
    res["brick_gates"], res["brick_faults"] = {}, {}
    for dtype in (None, "bfloat16"):
        name = dtype or "fp32"
        dense[name] = run_of("dense", dtype)
        ratio, stats = gate(dtype, dense[name], run_of("bricked", dtype))
        for what, st in stats.items():
            log(f"flagship scene bricked vs dense {name} {what}: "
                f"{json.dumps(st)}")
        res["brick_gates"][name] = ratio
        log(f"bricked vs dense {name} gate ratio {ratio:.4g} (pass at <= "
            f"1; fp32: max |diff| of the maps, 99.9% quantile of the "
            f"outputs, {FP32_PATH_TOL} * max(1, std); bf16: mean |diff|, "
            f"{BF16_PATH_MEAN} * max(1, std))")
    if not all(r <= 1.0 for r in res["brick_gates"].values()):
        failed.append(("bricked vs dense", res["brick_gates"]))

    with sentinel_halo(bo):
        for dtype in (None, "bfloat16"):
            name = dtype or "fp32"
            ratio, _ = gate(dtype, dense[name], run_of("bricked", dtype))
            res["brick_faults"][name] = ratio
            log(f"planted fault 'the +x halo from the sentinel' on bricked "
                f"{name}: gate ratio {ratio:.4g} (must be > 1)")
    if not all(not r <= 1.0 for r in res["brick_faults"].values()):
        failed.append(("planted brick fault passed", res["brick_faults"]))
    c = cfg_of("bricked", None, capacity=nb1 - 1)
    try:
        count_forward(torch, mt, counters, by_key,
                      mt.build_model(c, device="cuda", seed=0), one, c)
    except RuntimeError as e:
        log(f"brick_capacity {nb1 - 1} < {nb1} occupied bricks raised: {e}")
    else:
        failed.append("a brick capacity below the occupied bricks did not "
                      "raise")
    assert not failed, failed
    return res


def run_test_entry(torch, np, mt, counters, card):
    """`python -m mask3d_tpu_torch.cli test` in process, at the flagship's
    full width (`Config()` defaults, fp32 dense, random weights from the
    seed) on a written dataset; returns the kernels' launches in it."""
    import tempfile

    from mask3d_tpu_torch import cli
    from mask3d_tpu_torch.data import collate as collate_mod
    from mask3d_tpu_torch.train import trainer as trainer_mod
    from mask3d_tpu_torch.utils import meter

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    seen = {}
    collate_s = []
    cls = trainer_mod.InstanceSegmentationTrainer
    real = dict(make=trainer_mod.make_eval_step, test=cls.test,
                collate=collate_mod.VoxelizeCollate.__call__)

    def recording_make(cfg, model, criterion, device):
        step = real["make"](cfg, model, criterion, device)

        def eval_step(batch):
            out = step(batch)
            if "batch" not in seen:
                seen.update(batch=batch, model=model, cfg=cfg,
                            pred_class=out[0].clone(),
                            pred_masks=out[1].clone())
            return out
        return eval_step

    def recording_test(self):
        seen["trainer"] = self
        seen["metrics"] = real["test"](self)
        return seen["metrics"]

    def timed_collate(self, batch):
        t = time.perf_counter()
        out = real["collate"](self, batch)
        collate_s.append(time.perf_counter() - t)
        return out

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        t = time.perf_counter()
        scenes = write_entry_dataset(np, root)
        log(f"test entry: wrote {len(scenes)} scenes in "
            f"{time.perf_counter() - t:.2f} s")
        trainer_mod.make_eval_step = recording_make
        cls.test = recording_test
        collate_mod.VoxelizeCollate.__call__ = timed_collate
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            rc = cli.main(["test", "--device", "cuda",
                           f"data.data_root={root}",
                           f"data.test_batch_size={ENTRY_BATCH}",
                           f"general.save_dir={tmp}/saved"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches = {k: fn.launches for k, fn in counters.items()}
        finally:
            trainer_mod.make_eval_step = real["make"]
            cls.test = real["test"]
            collate_mod.VoxelizeCollate.__call__ = real["collate"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert rc == 0, rc
        metrics = seen["metrics"]
        trainer = seen["trainer"]

        # the native voxelizer against its numpy path on every scene
        for split, ds in trainer.datasets.items():
            for i in range(len(ds)):
                coords = ds[i]["coordinates"]
                nat = collate_mod.voxelize_item(coords)
                ref = collate_mod.voxelize_item(coords, use_native=False)
                assert all(np.array_equal(a, b) for a, b in zip(nat, ref)), (
                    split, ds[i]["scene"])

    n_batches = -(-ENTRY_TEST_SCENES // ENTRY_BATCH)
    log(f"test entry: cli test over {ENTRY_TEST_SCENES} scenes in "
        f"{secs:.2f} s; kernel launches {launches}; peak device memory "
        f"{peak:.2f} GiB on {card}")
    n_levels = 3 * 4 + 1  # num_decoders x hlevels + the final output
    losses = ["loss_ce", "loss_mask", "loss_dice"] + [
        f"loss_{w}_mask_module_{i}" for i in range(n_levels - 1)
        for w in ("ce", "mask", "dice")] + ["loss"]
    want = {f"test_{k}" for k in losses + ["batch_overflow"]} | {
        f"test_{k}" for k in ENTRY_EVAL_KEYS}
    log(f"test entry metrics: {json.dumps(metrics, sort_keys=True)}")
    assert set(metrics) == want, sorted(set(metrics) ^ want)
    finite = [k for k in metrics if "loss" in k or "mean_ap" in k]
    assert all(np.isfinite(metrics[k]) for k in finite), metrics
    assert metrics["test_batch_overflow"] == 0.0, metrics
    assert launches["masked_attention"] == n_batches * 12 and \
        launches["row_gather"] == n_batches * 13, launches

    # the entry's forward on its first batch against `infer` on that batch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, _ = mt.infer(seen["model"], seen["batch"], seen["cfg"],
                      aux_masks=True, device="cuda")
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t
    same = torch.equal(out.pred_class, seen["pred_class"]) and \
        torch.equal(out.pred_masks, seen["pred_masks"])
    if same:
        log("test entry forward on batch 1 vs infer(aux_masks=True): "
            "bitwise equal")
    else:
        errs = [float((a - b).abs().max()) / max(1.0, float(b.std()))
                for a, b in ((seen["pred_class"], out.pred_class),
                             (seen["pred_masks"], out.pred_masks))]
        log(f"test entry forward on batch 1 vs infer(aux_masks=True): not "
            f"bitwise; max|diff|/max(1,std) {errs} (tol {ENTRY_TOL})")
        assert max(errs) <= ENTRY_TOL, errs

    # the criterion alone on batch 1's outputs (its LSAP round trip
    # included), beside the forward alone
    batch, cfg = seen["batch"], seen["cfg"]
    targets = batch.target.with_label_offset(cfg.data.prediction_label_offset)
    point_valid = torch.arange(batch.capacity, device="cuda")[None] \
        < batch.counts[:, None]
    criterion_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            trainer.criterion(out, targets, point_valid)
        torch.cuda.synchronize()
        criterion_s.append(time.perf_counter() - t)

    stats = meter.get_statistics()
    per_batch = {
        "collation (native, 16 threads)": statistics.mean(collate_s),
        "forward + criterion": stats["model_forward_complete"]["mean"],
        "forward alone (batch 1, once)": forward_s,
        "criterion alone (batch 1, median of 3)":
            statistics.median(criterion_s),
        "post-process": stats["eval_postprocess"]["mean"],
        "evaluator": stats["eval_metrics_calc"]["mean"]}
    log("test entry seconds per batch (mean over "
        f"{n_batches} test batches; collation over all "
        f"{len(collate_s)} calls): "
        f"{json.dumps(per_batch)}; meter {json.dumps(stats)} on {card}")
    return launches


def leaf_errors(ref, got):
    """Per parameter: ||got - ref|| / max(||ref||, 1e-4 of the largest
    leaf norm) (leaves whose true gradient is 0, the attention's K biases,
    against the floor)."""
    floor = TRAIN_GRAD_FLOOR * max(float(v.norm()) for v in ref.values())
    return {k: float((got[k].double() - r.double()).norm())
            / max(float(r.double().norm()), floor) for k, r in ref.items()}


def time_backward_ms(torch, fn, graph=True):
    """(device ms, eager ms) of one backward: CUDA-graph replay of 4 calls,
    twice (`profile_forward.graph_ms`), beside the eager per-call time; or,
    for a backward of tens of ms (the sparse conv's), where the host's
    per-call cost does not count, one eager call (CUDA events) for both."""
    from mask3d_tpu_torch.profile_forward import graph_ms

    if not graph:
        ms = time_ms(torch, fn, iters=1, warmup=0)
        return ms, ms
    return graph_ms(fn, iters=4, replays=2), time_ms(torch, fn, iters=3,
                                                      warmup=1)


def check_backwards(torch, F, ma, rg, sc, ops, dense_ops, host, caps, sb_gp,
                    spconv_shapes):
    """(a) Each Function's backward after its kernel forward against
    autograd of the plain path at the train shapes: the attention at the
    four sampled key lengths and one eval length, the row gather at the
    flagship taps in f32 and bf16, the sparse conv at every shape the
    counted `gather_pallas` forward launched; each backward timed beside
    its bytes-or-operations bound. Returns rows by kernel."""
    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    def grads(fn, inputs, g):
        leaves = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    def rel(ref, got):
        return max(float((a.double() - b.double()).abs().max())
                   / max(1.0, float(b.double().abs().max()))
                   for a, b in zip(got, ref))

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"masked_attention": [], "row_gather": [], "sparse_conv": []}
    b, nq, d, h = 8, 25, 128, 8
    for s in TRAIN_ATTN_S + (ATTN_S[0],):
        q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen)
                   for n in (nq, s, s))
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        mask[0, 0] = True
        g = torch.randn(b, nq, d, device="cuda", generator=gen)
        got = grads(lambda *t: ma.masked_cross_attention(*t, mask, h),
                    (q, k, v), g)
        ref = grads(lambda *t: ma.masked_cross_attention_plain(*t, mask, h),
                    (q, k, v), g)
        err = rel(ref, got)
        ms, eager = time_backward_ms(
            torch, lambda: ma.masked_cross_attention_backward(
                q, k, v, mask, h, g))
        bound_ms, by = bound(4 * 2 * (2 * b * nq * d + 2 * b * s * d)
                             + b * nq * s, 12 * b * nq * s * d)
        rows["masked_attention"].append(dict(
            S=s, max_rel_err=err, ok=err <= ATTN_TOL, ms=ms, eager_ms=eager,
            bound_ms=bound_ms, bound_by=by))
        log(f"attention backward S={s}: max|err|/max(1,|ref|) {err:.3g} "
            f"(tol {ATTN_TOL}); {ms:.4f} ms (eager {eager:.4f}) bound "
            f"{bound_ms:.4f} ms ({by})")

    dev = host.device
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims, caps,
                            dev.grid_dims)
    for dtype, taps in ((torch.float32, GATHER_C),
                        (torch.bfloat16, BF16_GATHER_C)):
        esize = torch.empty((), dtype=dtype).element_size()
        for c, li in taps.items():
            gd = dev.grid_dims[li]
            cells = gd[0] * gd[1] * gd[2]
            lvl = sb.levels[li]
            idx = dense_ops.static_keys(lvl, gd).clamp(0, cells - 1).to(
                torch.int32).contiguous()
            ok = lvl.valid.contiguous()
            m = idx.shape[1]
            src = torch.randn(b, cells, c, device="cuda",
                              generator=gen).to(dtype)
            g = torch.randn(b, m, c, device="cuda", generator=gen).to(dtype)
            (got,) = grads(lambda t: rg.row_gather(t, idx, ok), (src,), g)
            with cuda_build.plain_versions():
                (ref,) = grads(lambda t: rg.row_gather(t, idx, ok), (src,), g)
            equal = bool(torch.equal(got, ref))
            ms, eager = time_backward_ms(
                torch, lambda: rg.scatter_add_rows(g, idx, ok, cells).to(
                    dtype))
            bound_ms, by = bound(b * m * (c * esize + 5)
                                 + b * cells * c * esize, 0)
            rows["row_gather"].append(dict(
                C=c, level=li, dtype=str(dtype)[6:], equal=equal, ms=ms,
                eager_ms=eager, bound_ms=bound_ms, bound_by=by))
            log(f"row_gather backward {str(dtype)[6:]} C={c} level {li}: "
                f"bitwise equal to the plain path's {equal}; {ms:.4f} ms "
                f"(eager {eager:.4f}) bound {bound_ms:.4f} ms ({by})")

    for (n, k, cin, cout), n_launch in sorted(
            spconv_shapes.items(), key=lambda kv: (-kv[0][0],) + kv[0][1:]):
        level, idx, ok = kernel_map(sb_gp, n, k)
        feats = torch.randn(b, n, cin, device="cuda", generator=gen)
        feats *= sb_gp.levels[level].valid[..., None]
        w = torch.randn(k, cin, cout, device="cuda", generator=gen) / (
            k * cin) ** 0.5
        g = torch.randn(b, n, cout, device="cuda", generator=gen)
        got = grads(lambda f, ww: sc.sparse_conv(f, ww, idx, ok), (feats, w),
                    g)
        ref = grads(lambda f, ww: ops.sparse_conv(f, ww, idx, ok), (feats, w),
                    g)
        err = rel(ref, got)
        ms, eager = time_backward_ms(
            torch, lambda: sc.sparse_conv_backward(feats, w, idx, ok, g),
            graph=False)
        n_ok = int(ok.sum())
        bound_ms, by = bound(
            b * n * (cout + 2 * cin) * 4 + 2 * k * cin * cout * 4
            + b * n * k * 5, 4 * n_ok * cin * cout)
        rows["sparse_conv"].append(dict(
            level=level, N=n, K=k, Cin=cin, Cout=cout, launches=n_launch,
            max_rel_err=err, ok=err <= TRAIN_FN_TOL, ms=ms, eager_ms=eager,
            bound_ms=bound_ms, bound_by=by))
        log(f"sparse_conv backward L{level} N={n} K={k} {cin}->{cout} "
            f"x{n_launch}: max|err|/max(1,|ref|) {err:.3g} (tol "
            f"{TRAIN_FN_TOL}); {ms:.4f} ms (eager {eager:.4f}) bound "
            f"{bound_ms:.4f} ms ({by}), {ms / bound_ms:.1f}x")
        del feats, w, g, got, ref
    sums = {name: sum(r.get("launches", 1) * r["ms"] for r in rs)
            for name, rs in rows.items()}
    log(f"backward sums (ms): {json.dumps(sums)}")
    assert all(r["ok"] for r in rows["masked_attention"]), rows
    assert all(r["equal"] for r in rows["row_gather"]), rows
    assert all(r["ok"] for r in rows["sparse_conv"]), rows
    return rows


def train_steps(torch, mt, counters, by_key, cfg, batch, n_steps=1,
                plain=False, seed=0):
    """`n_steps` train steps of a fresh flagship state (weights and
    generator from `seed`) on `batch`, with the counts set to 0 just before
    and read just after; returns (losses, launches, attention launches by
    S, state, peak GiB above what was allocated before the state was made,
    seconds a step)."""
    import contextlib

    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, seed=seed, device="cuda")
    step = make_train_step(cfg, make_criterion(cfg), "cuda")
    for fn in counters.values():
        fn.launches = 0
    for counts, _ in by_key.values():
        counts.clear()
    losses, secs = [], []
    with cuda_build.plain_versions() if plain else contextlib.nullcontext():
        for _ in range(n_steps):
            t = time.perf_counter()
            out, _ = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append({k: float(v) for k, v in out.items()})
    launches = {k: fn.launches for k, fn in counters.items()}
    by_s = dict(by_key["attention"][0])
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return losses, launches, by_s, state, peak, secs


def check_train_step_paths(torch, mt, counters, by_key, cfg, cfg_gp, host,
                           card):
    """(b) one dense fp32 step, the kernels against the plain path, leaf by
    leaf; (d) two steps twice from one seed, bitwise; (e) two
    `gather_pallas` steps. Returns the counted launches by run."""
    import numpy as np

    n_dec = cfg.model.num_decoders * len(cfg.model.hlevels)
    cfg = cfg_mod_replace(cfg, ["trainer.train_split_metrics=false"])
    cfg_gp = cfg_mod_replace(cfg_gp, ["trainer.train_split_metrics=false"])
    batch = host.device
    out = {}
    res = {}
    for plain in (False, True):
        losses, launches, by_s, state, peak, secs = train_steps(
            torch, mt, counters, by_key, cfg, batch, plain=plain)
        res[plain] = (losses[0]["loss"],
                      {k: p.grad.detach().clone()
                       for k, p in state.model.named_parameters()})
        tag = "plain" if plain else "kernels"
        out[f"dense step ({tag})"] = launches
        log(f"train step dense fp32, batch 8 ({tag}): loss "
            f"{losses[0]['loss']:.6f}, overflow "
            f"{losses[0]['batch_overflow']:.0f}, launches {launches}, "
            f"attention by S {by_s}, {secs[0]:.3f} s, peak {peak:.2f} GiB "
            f"on {card}")
        if plain:
            assert sum(launches.values()) == 0, launches
        else:
            assert launches["masked_attention"] == n_dec and \
                launches["row_gather"] == 13, launches
            assert by_s == {s: 3 for s in TRAIN_ATTN_S}, by_s
        del state
    (lk, gk), (lp, gp) = res[False], res[True]
    assert np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp), (
        lk, lp)
    errs = leaf_errors(gp, gk)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"train step gradients, kernels vs plain path, per leaf "
        f"||diff||/||plain|| (tol {TRAIN_GRAD_TOL}), worst: {worst}; loss "
        f"{lk:.6f} vs {lp:.6f}")
    assert worst[0][1] <= TRAIN_GRAD_TOL, worst
    del res, gk, gp

    runs = []
    for _ in range(2):
        losses, launches, _, state, _, _ = train_steps(
            torch, mt, counters, by_key, cfg, batch, n_steps=2, seed=1)
        runs.append(([l["loss"] for l in losses],
                     {k: p.detach().clone()
                      for k, p in state.model.named_parameters()}))
        del state
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    log(f"determinism: two steps twice from one seed, losses {runs[0][0]} "
        f"and {runs[1][0]}, losses and parameters bitwise equal {same}")
    assert same
    out["determinism (2 x 2 steps)"] = launches
    del runs

    losses, launches, by_s, state, peak, secs = train_steps(
        torch, mt, counters, by_key, cfg_gp, batch, n_steps=2)
    out["gather_pallas (2 steps)"] = launches
    log(f"gather_pallas: two steps, losses "
        f"{[l['loss'] for l in losses]}, launches {launches}, "
        f"{[round(x, 3) for x in secs]} s a step, peak {peak:.2f} GiB on "
        f"{card}")
    assert all(np.isfinite(l["loss"]) for l in losses), losses
    assert launches["sparse_conv"] == 2 * 47 and \
        launches["masked_attention"] == 2 * n_dec, launches
    del state
    return out


def cfg_mod_replace(cfg, overrides):
    """A copy of `cfg` with `overrides` applied (apply_overrides edits in
    place)."""
    import copy

    from mask3d_tpu_torch.config import apply_overrides

    return apply_overrides(copy.deepcopy(cfg), overrides)


def check_batch16_memory(torch, mt, counters, by_key, cfg, card):
    """(f) the peak device memory of one step at batch 16 (the reference's
    recipe), whole and as two accumulated micro-batches of 8; a step that
    does not fit is reported as such."""
    from mask3d_tpu_torch.profile_forward import flagship_items

    host16 = mt.collate(flagship_items(0) + flagship_items(1), device="cuda",
                        point_bucket_multiple=BUCKET)
    out = {}
    for accum in (1, 2):
        c = cfg_mod_replace(cfg, [f"trainer.grad_accum_steps={accum}",
                                  "trainer.train_split_metrics=false"])
        try:
            losses, _, _, state, peak, secs = train_steps(
                torch, mt, counters, by_key, c, host16.device)
            out[accum] = dict(peak_gib=peak, s=secs[0],
                              loss=losses[0]["loss"])
            del state
        except torch.cuda.OutOfMemoryError as e:
            out[accum] = dict(
                fits=False, peak_gib_with_earlier_phases=torch.cuda.
                max_memory_allocated() / 2**30, error=str(e).splitlines()[0])
        torch.cuda.empty_cache()
        log(f"batch 16, grad_accum_steps={accum}: {json.dumps(out[accum])} "
            f"on {card}")
    return out


def run_train_entry(torch, np, mt, counters, by_key, card):
    """(c) `python -m mask3d_tpu_torch.cli train` in process at the
    flagship's full width (`Config()` defaults, batch 8 as TRAIN_ACCUM
    micro-batches) on written PLYs:
    8 train scenes x `general.reps_per_epoch` TRAIN_STEPS is TRAIN_STEPS
    steps, then one validation, `last-epoch.ckpt` and `best_*.ckpt`; then
    `cli test` on that checkpoint. Prints seconds a step by phase and the
    peak device memory; returns the kernels' launches in the train run."""
    import tempfile

    from mask3d_tpu_torch import cli
    from mask3d_tpu_torch.data import collate as collate_mod
    from mask3d_tpu_torch.evalm import evaluator as evaluator_mod
    from mask3d_tpu_torch.models import mask3d as model_mod
    from mask3d_tpu_torch.train import criterion as criterion_mod
    from mask3d_tpu_torch.train import trainer as trainer_mod

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    secs = {}  # phase -> seconds of each call
    seen = {}

    def timed(name, fn, when=lambda *a, **k: True, sync=True):
        """`fn` with its seconds recorded under `name` where `when` holds;
        device work is fenced on both sides unless `sync` is false (the
        collator, which runs on the prefetch thread and does no device
        work)."""
        def wrapper(*a, **k):
            if not when(*a, **k):
                return fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            secs.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return wrapper

    cls = trainer_mod.InstanceSegmentationTrainer
    real_make = trainer_mod.make_train_step

    def recording_make(cfg, criterion, device):
        step = real_make(cfg, criterion, device)

        def train_step(state, batch):
            out = step(state, batch)
            seen.setdefault("losses", []).append(
                {k: float(v) for k, v in out[0].items()})
            seen.setdefault("grids", []).append(
                (batch.capacity, tuple(batch.grid_dims[0])))
            return out
        return timed("whole train step", train_step)

    real_fit = cls.fit

    def recording_fit(self):
        seen["trainer"] = self
        return real_fit(self)

    patches = [
        (trainer_mod, "make_train_step", recording_make),
        (cls, "fit", recording_fit),
        (collate_mod.VoxelizeCollate, "__call__", timed(
            "collation (prefetch thread)",
            collate_mod.VoxelizeCollate.__call__, sync=False)),
        (model_mod.Mask3D, "forward", timed(
            "forward", model_mod.Mask3D.forward,
            lambda self, *a, **k: self.training)),
        (criterion_mod.SetCriterion, "__call__", timed(
            "criterion", criterion_mod.SetCriterion.__call__,
            lambda *a, **k: torch.is_grad_enabled())),
        (torch.Tensor, "backward", timed("backward", torch.Tensor.backward)),
        (torch.optim.AdamW, "step", timed("optimizer",
                                         torch.optim.AdamW.step)),
        (cls, "_postprocess_batch", timed(
            "train-split post-process", cls._postprocess_batch,
            lambda *a, measure=False, **k: not measure)),
        (evaluator_mod.Mask3DEvaluator, "evaluate", timed(
            "train-split evaluator", evaluator_mod.Mask3DEvaluator.evaluate,
            lambda self, p, t, prefix, *a, **k: prefix == "train")),
    ]
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        t = time.perf_counter()
        write_entry_dataset(np, root, n_train=ENTRY_BATCH, n_test=1)
        log(f"train entry: wrote {ENTRY_BATCH + 2} scenes in "
            f"{time.perf_counter() - t:.2f} s")
        saved = [(owner, name, getattr(owner, name))
                 for owner, name, _ in patches]
        for owner, name, fake in patches:
            setattr(owner, name, fake)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for fn in counters.values():
                fn.launches = 0
            for counts, _ in by_key.values():
                counts.clear()
            t = time.perf_counter()
            rc = cli.main(["train", "--device", "cuda",
                           f"data.data_root={root}",
                           f"data.batch_size={ENTRY_BATCH}",
                           f"trainer.grad_accum_steps={TRAIN_ACCUM}",
                           f"general.reps_per_epoch={TRAIN_STEPS}",
                           "trainer.max_epochs=1",
                           "general.experiment_id=train",
                           f"general.save_dir={tmp}/saved"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {k: fn.launches for k, fn in counters.items()}
            by_s = dict(by_key["attention"][0])
        finally:
            for owner, name, real in saved:
                setattr(owner, name, real)
        # the run's own peak, above what earlier phases still hold
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        assert rc == 0, rc
        trainer = seen["trainer"]
        run_dir = trainer.run_dir
        files = sorted(os.listdir(run_dir))
        log(f"train entry: cli train {TRAIN_STEPS} steps + 1 validation in "
            f"{wall:.2f} s; run dir {files}; kernel launches {launches}, "
            f"attention by S {by_s}; peak device memory {peak:.2f} GiB on "
            f"{card}")
        n_dec = trainer.cfg.model.num_decoders * len(
            trainer.cfg.model.hlevels)
        steps = len(seen["losses"])
        assert steps == TRAIN_STEPS == trainer.state.step, steps
        assert all(np.isfinite(x["loss"]) for x in seen["losses"]), seen
        log(f"train entry losses: "
            f"{[round(x['loss'], 4) for x in seen['losses']]}; (capacity, "
            f"level-0 grid) a step: {seen['grids']}")
        # a forward per micro-batch, one validation batch
        forwards = steps * TRAIN_ACCUM + 1
        assert launches["masked_attention"] == n_dec * forwards, launches
        assert launches["row_gather"] == 13 * forwards, launches
        for s in TRAIN_ATTN_S:
            assert by_s.get(s) == 3 * steps * TRAIN_ACCUM, (s, by_s)
        assert "last-epoch.ckpt" in files, files

        metrics = {}
        real_test = cls.test

        def test(self):
            metrics.update(real_test(self))
            return metrics

        cls.test = test
        try:
            rc = cli.main(["test", "--device", "cuda",
                           f"data.data_root={root}",
                           "data.test_dataset_mode=validation",
                           f"general.checkpoint={run_dir}/last-epoch.ckpt",
                           f"general.save_dir={tmp}/test"])
        finally:
            cls.test = real_test
        assert rc == 0, rc
        log(f"cli test on the trained last-epoch.ckpt: "
            f"{json.dumps(metrics, sort_keys=True)}")
        assert np.isfinite(metrics["test_loss"]), metrics
    per_step = {k: dict(median=statistics.median(v), calls=len(v),
                        first=v[0]) for k, v in secs.items()}
    log(f"train entry seconds a call (batch {ENTRY_BATCH}): "
        f"{json.dumps(per_step)} on {card}")
    return dict(launches=launches, attention_by_s=by_s, seconds=per_step,
                peak_gib=peak)


def grad_pieces(torch, grads):
    """Each gradient leaf, and each kernel offset of each conv weight
    ([Cout, Cin, k, k, k] or a transposed [Cin, Cout, 2, 2, 2]) as a piece
    of its own: {(leaf, offset or None): f64 tensor}."""
    out = {}
    for name, g in grads.items():
        g = g.double()
        out[(name, None)] = g
        if ".convs." in name and g.dim() == 5:
            for off in torch.cartesian_prod(*(torch.arange(d)
                                              for d in g.shape[2:])):
                i, j, k = (int(x) for x in off)
                out[(name, (i, j, k))] = g[:, :, i, j, k]
    return out


def bf16_train_gate(torch, g16, g32):
    """The bf16 step held to the fp32 step of the same impl: per leaf and
    kernel offset (`grad_pieces`), ||g16 - g32|| / ||g32|| over the pieces
    whose fp32 norm is above TRAIN_GRAD_FLOOR of the largest leaf norm;
    returns (worst ratio to TRAIN_BF16_REL, its piece, the pieces' median
    relative error); the gate passes at ratio <= 1."""
    p16, p32 = grad_pieces(torch, g16), grad_pieces(torch, g32)
    floor = TRAIN_GRAD_FLOOR * max(float(v.norm()) for k, v in p32.items()
                                   if k[1] is None)
    rel = {k: float((p16[k] - v).norm()) / float(v.norm())
           for k, v in p32.items() if float(v.norm()) > floor}
    worst = max(rel, key=rel.get)
    return rel[worst] / TRAIN_BF16_REL, worst, statistics.median(
        rel.values())


def grads_of(state):
    return {k: p.grad.detach().clone()
            for k, p in state.model.named_parameters() if p.grad is not None}


class flipped_centre_dw:
    """A planted fault, patched in for a `with` block: the sparse conv's
    backward returns the centre offset's dW with its sign flipped."""

    def __init__(self, sc):
        self.sc, self.real = sc, sc.sparse_conv_backward

    def __enter__(self):
        real = self.real

        def faulty(feats, weight, nbr_idx, nbr_ok, g, needs=(True, True)):
            df, dw = real(feats, weight, nbr_idx, nbr_ok, g, needs)
            if dw is not None:
                dw = dw.clone()
                dw[dw.shape[0] // 2] *= -1
            return df, dw

        self.sc.sparse_conv_backward = faulty

    def __exit__(self, *exc):
        self.sc.sparse_conv_backward = self.real


class negated_brick_tap:
    """A planted fault, patched in for a `with` block: the bricked
    level-0 tap's backward returns the negated gradient."""

    def __init__(self, torch, bo):
        self.torch, self.bo, self.real = torch, bo, bo.gather_rows

    def __enter__(self):
        torch, real = self.torch, self.real

        class Negate(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return -g

        def faulty(bricks, tables, spec, valid):
            return real(Negate.apply(bricks), tables, spec, valid)

        self.bo.gather_rows = faulty

    def __exit__(self, *exc):
        self.bo.gather_rows = self.real


def one_step(torch, mt, counters, by_key, cfg, batch, card, what,
             oom_retry=False):
    """One train step of a fresh state (`train_steps`), logged; with
    `oom_retry` a step that runs out of device memory is retried with
    `model.remat_backbone=true`. Returns (loss, grads, launches, by S,
    seconds, peak GiB, remat)."""
    remat = False
    while True:
        try:
            losses, launches, by_s, state, peak, secs = train_steps(
                torch, mt, counters, by_key, cfg, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            if not oom_retry or remat:
                raise
            log(f"{what}: out of device memory without remat_backbone "
                f"({str(e).splitlines()[0]}); again with it")
            cfg = cfg_mod_replace(cfg, ["model.remat_backbone=true"])
            remat = True
    grads = grads_of(state)
    del state
    torch.cuda.empty_cache()
    loss = losses[0]["loss"]
    log(f"{what}: loss {loss:.6f}, overflow "
        f"{losses[0]['batch_overflow']:.0f}, launches {launches}, attention "
        f"by S {by_s}, {secs[0]:.3f} s, peak {peak:.2f} GiB"
        f"{' (remat_backbone)' if remat else ''} on {card}")
    return dict(loss=loss, grads=grads, launches=launches, by_s=by_s,
                s=secs[0], peak_gib=peak, remat=remat,
                overflow=losses[0]["batch_overflow"])


def run_train_large(torch, F, np, mt, counters, by_key, card, host,
                    kernels):
    """The `train_large` phase (see the docstring's phase 10). Every gate is
    read before the first failing one raises, at the end."""
    from mask3d_tpu_torch import bench_large_scene as bls
    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.sparse import brick_ops as bo

    ma, rg, sc = kernels
    res, failed = {"steps": {}}, []
    n_dec = 3 * 4
    base = [f"data.point_bucket_multiple={BUCKET}",
            "trainer.train_split_metrics=false"]
    gd0 = host.device.grid_dims[0]
    slots = int(np.prod([g // b for g, b in zip(gd0, BRICK_SCENE)]))
    bricked = ["model.backbone_impl=bricked",
               "model.brick_dims=[{},{},{}]".format(*BRICK_SCENE),
               f"model.brick_capacity={slots}", "data.batch_size=8",
               "trainer.grad_accum_steps=8"]

    def cfg_of(*ov):
        return apply_overrides(Config(), base + [x for o in ov for x in o])

    batch = host.device
    # (a) bricked fp32, 8 micro-batches of one scene: kernels vs plain path
    cfg_b = cfg_of(bricked)
    runs = {}
    for plain in (False, True):
        losses, launches, by_s, state, peak, secs = train_steps(
            torch, mt, counters, by_key, cfg_b, batch, plain=plain)
        tag = "plain" if plain else "kernels"
        runs[tag] = dict(loss=losses[0]["loss"], grads=grads_of(state),
                         launches=launches, by_s=by_s, s=secs[0],
                         peak_gib=peak)
        del state
        torch.cuda.empty_cache()
        log(f"train_large bricked fp32, 8 x 1 ({tag}): loss "
            f"{losses[0]['loss']:.6f}, overflow "
            f"{losses[0]['batch_overflow']:.0f}, launches {launches}, "
            f"attention by S {by_s}, {secs[0]:.3f} s, peak {peak:.2f} GiB "
            f"on {card}")
    k, p = runs["kernels"], runs["plain"]
    res["launches"] = {"bricked fp32 (kernels)": k["launches"]}
    want = {"masked_attention": 8 * n_dec, "row_gather": 8 * 5,
            "sparse_conv": 0, "int8_conv": 0}
    if k["launches"] != want or k["by_s"] != {s: 8 * 3
                                              for s in TRAIN_ATTN_S}:
        failed.append(("bricked step launches", k["launches"], k["by_s"]))
    if sum(p["launches"].values()) != 0:
        failed.append(("plain path launched a kernel", p["launches"]))
    errs = leaf_errors(p["grads"], k["grads"])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"train_large bricked fp32 gradients, kernels vs plain path, per "
        f"leaf ||diff||/||plain|| (tol {TRAIN_GRAD_TOL}), worst: {worst}; "
        f"loss {k['loss']:.6f} vs {p['loss']:.6f}")
    res["bricked_fp32"] = dict(
        loss=k["loss"], loss_plain=p["loss"], worst_leaf=worst[0],
        s=k["s"], s_plain=p["s"], peak_gib=k["peak_gib"])
    if not (np.isfinite(k["loss"])
            and abs(k["loss"] - p["loss"]) <= TRAIN_LOSS_TOL * abs(p["loss"])
            and worst[0][1] <= TRAIN_GRAD_TOL):
        failed.append(("bricked kernels vs plain", worst[0], k["loss"],
                       p["loss"]))
    fp32 = {"bricked": k}
    del runs, p
    same_runs = []
    for _ in range(2):
        losses, _, _, state, _, _ = train_steps(
            torch, mt, counters, by_key, cfg_b, batch, n_steps=2, seed=1)
        same_runs.append(([x["loss"] for x in losses],
                          {n: q.detach().clone()
                           for n, q in state.model.named_parameters()}))
        del state
    same = same_runs[0][0] == same_runs[1][0] and all(
        torch.equal(v, same_runs[1][1][n]) for n, v in same_runs[0][1].items())
    log(f"train_large bricked determinism: two steps twice from one seed, "
        f"losses {same_runs[0][0]} and {same_runs[1][0]}, bitwise equal "
        f"{same}")
    res["bricked_fp32"]["bitwise_repeat"] = same
    if not same:
        failed.append("bricked steps do not repeat bitwise")
    del same_runs
    torch.cuda.empty_cache()

    # (b) one bf16 step on each impl against its fp32 step
    # `gather` keeps every offset's gathered rows for its backward: 75.5
    # GiB at batch 8 whole on the H100 80GB, so it takes the batch as 2 x 4
    impls = {"bricked": bricked,
             "gather": ["model.backbone_impl=gather",
                        "trainer.grad_accum_steps=2"],
             "gather_pallas": ["model.backbone_impl=gather_pallas"]}
    bf16 = ["model.compute_dtype=bfloat16"]
    for impl in ("gather", "gather_pallas"):
        fp32[impl] = one_step(torch, mt, counters, by_key,
                              cfg_of(impls[impl]), batch, card,
                              f"train_large {impl} fp32, batch 8")
    res["bf16_gates"], res["bf16_faults"] = {}, {}
    for impl in ("bricked", "gather", "gather_pallas"):
        run = one_step(torch, mt, counters, by_key,
                       cfg_of(impls[impl], bf16), batch, card,
                       f"train_large {impl} bf16, batch 8")
        ratio, piece, med = bf16_train_gate(torch, run["grads"],
                                            fp32[impl]["grads"])
        log(f"train_large {impl} bf16 vs fp32 gradients: worst "
            f"||diff||/||fp32|| {ratio * TRAIN_BF16_REL:.4g} at {piece} "
            f"(gate {TRAIN_BF16_REL}, ratio {ratio:.4g}), median over "
            f"leaves and offsets {med:.4g}")
        res["bf16_gates"][impl] = ratio
        res["steps"][f"{impl} bf16"] = {
            k_: run[k_] for k_ in ("loss", "s", "peak_gib", "launches")}
        res["steps"][f"{impl} fp32"] = {
            k_: fp32[impl][k_] for k_ in ("loss", "s", "peak_gib",
                                          "launches")}
        if not (np.isfinite(run["loss"]) and ratio <= 1.0):
            failed.append((f"{impl} bf16 gate", ratio, piece, run["loss"]))
        if impl == "gather_pallas":
            res["launches"]["gather_pallas bf16"] = run["launches"]
            if run["launches"]["sparse_conv"] != 47:
                failed.append(("gather_pallas bf16 launches",
                               run["launches"]))
        if impl in ("bricked", "gather_pallas"):
            fault = (negated_brick_tap(torch, bo) if impl == "bricked"
                     else flipped_centre_dw(sc))
            with fault:
                bad = one_step(torch, mt, counters, by_key,
                               cfg_of(impls[impl], bf16), batch, card,
                               f"train_large {impl} bf16 with a planted "
                               f"fault")
            fratio, fpiece, _ = bf16_train_gate(torch, bad["grads"],
                                                fp32[impl]["grads"])
            name = ("the brick tap's backward negated" if impl == "bricked"
                    else "the centre offset's dW sign-flipped")
            log(f"planted fault '{name}' on {impl} bf16: gate ratio "
                f"{fratio:.4g} at {fpiece} (must be > 1)")
            res["bf16_faults"][impl] = fratio
            if fratio <= 1.0:
                failed.append((f"planted fault on {impl} passed", fratio))
            del bad
        del run
    del fp32
    torch.cuda.empty_cache()

    # (c) the hall scene: one bf16 step each on bricked and gather_pallas
    hall = bls.hall_batch("cpu").device
    brick, _, _, cap = bls.brick_geometry(hall)
    hall = hall.to("cuda")
    res["hall"] = {}
    for impl in ("bricked", "gather_pallas"):
        cfg = cfg_mod_replace(bls.variant_cfg(impl, "per_offset", brick,
                                              cap), base[1:])
        run = one_step(torch, mt, counters, by_key, cfg, hall, card,
                       f"train_large hall {impl} bf16", oom_retry=True)
        res["hall"][impl] = {k_: run[k_] for k_ in (
            "loss", "s", "peak_gib", "remat", "launches", "overflow")}
        if not np.isfinite(run["loss"]) or run["overflow"]:
            failed.append((f"hall {impl} step", run["loss"],
                           run["overflow"]))
        del run
        torch.cuda.empty_cache()
    # the backwards at the hall's level-0 shapes: the sparse conv's
    # (bf16 feats, 96 -> 96) and the brick tap's scatter-add
    gen = torch.Generator(device="cuda").manual_seed(5)
    from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    cfg_gp = bls.variant_cfg("gather_pallas", "per_offset", brick, cap)
    with torch.inference_mode():
        sb = build_sparse_batch(hall.coords, hall.counts, hall.dims,
                                level_capacities(cfg_gp, hall.capacity),
                                hall.grid_dims, **_sb_kwargs(cfg_gp))
    n, kk, c = hall.capacity, 27, 96
    idx, ok = sb.nbr_idx[0], sb.nbr_ok[0]
    feats = (torch.randn(1, n, c, device="cuda", generator=gen)
             * sb.levels[0].valid[..., None]).to(torch.bfloat16)
    w = torch.randn(kk, c, c, device="cuda", generator=gen) / (kk * c) ** 0.5
    g = torch.randn(1, n, c, device="cuda", generator=gen)
    ms, _ = time_backward_ms(torch, lambda: sc.sparse_conv_backward(
        feats, w, idx, ok, g), graph=False)
    n_ok = int(ok.sum())
    bound_ms, by = bound(n * (c * 4 + 2 * c * 2) + 2 * kk * c * c * 4
                         + n * kk * 5, 4 * n_ok * c * c)
    res["hall_sparse_conv_backward"] = dict(
        N=n, K=kk, Cin=c, Cout=c, dtype="bfloat16", ms=ms,
        bound_ms=bound_ms, bound_by=by, ok_pairs=n_ok)
    log(f"hall sparse_conv backward L0 N={n} K={kk} {c}->{c} bf16 feats: "
        f"{ms:.2f} ms, bound {bound_ms:.4f} ms ({by}), "
        f"{ms / bound_ms:.0f}x")
    del sb, feats, w, g, idx, ok
    cfg_bk = bls.variant_cfg("bricked", "per_offset", brick, cap)
    with torch.inference_mode():
        sb = build_sparse_batch(hall.coords, hall.counts, hall.dims,
                                level_capacities(cfg_bk, hall.capacity),
                                hall.grid_dims, **_sb_kwargs(cfg_bk))
    spec = bo.make_brick_spec(hall.grid_dims[0], brick, cap)
    tables = bo.build_tables(sb.levels[0], spec)
    n_src = (spec.capacity + 1) * spec.cells
    tidx = tables.row_flat.clamp(0, n_src - 1).to(torch.int32)[None]
    tok = sb.levels[0].valid.contiguous()
    g = torch.randn(1, tidx.shape[1], c, device="cuda",
                    generator=gen).to(torch.bfloat16)
    ms, eager = time_backward_ms(torch, lambda: rg.scatter_add_rows(
        g, tidx, tok, n_src).to(torch.bfloat16), graph=False)
    m_ok = int(tok.sum())
    bound_ms, by = bound(tidx.shape[1] * 5 + m_ok * c * 2 + n_src * c * 2, 0)
    res["hall_brick_tap_backward"] = dict(
        rows=tidx.shape[1], source_rows=n_src, C=c, dtype="bfloat16", ms=ms,
        eager_ms=eager, bound_ms=bound_ms, bound_by=by)
    log(f"hall brick tap backward: {tidx.shape[1]} rows into {n_src} brick "
        f"cells, C={c} bf16: {ms:.4f} ms (eager {eager:.4f}), bound "
        f"{bound_ms:.4f} ms ({by})")
    del sb, tables, g, hall
    torch.cuda.empty_cache()

    # (d) cli train on bricked in micro-batches of one scene, a resume;
    # (e) cli test with measure_model_phases
    res["entry"] = run_train_large_entry(torch, np, mt, counters, card,
                                         failed)
    # the attention at the micro-batches' sampled key lengths (B=1)
    res["attention"] = check_attention(torch, F, ma, TRAIN_ATTN_S, b=1)
    for r in res["attention"]:
        r["launches"] = res["launches"]["bricked fp32 (kernels)"][
            "masked_attention"] // len(TRAIN_ATTN_S)
    if not all(r["ok"] for r in res["attention"]):
        failed.append("attention at the micro-batches' key lengths")
    assert not failed, failed
    return res


def run_train_large_entry(torch, np, mt, counters, card, failed):
    """(d) `cli train` with `model.backbone_impl=bricked` (8^3 bricks, which
    divide the collator's multiple-of-8 grids), batch 2 as two micro-batches
    of one scene, TRAIN_LARGE_SCENES train scenes, one validation at
    `test_batch_size=1`, then a second epoch resumed from its
    `last-epoch.ckpt`; (e) `cli test` (fp32 dense) with
    `trainer.measure_model_phases=true`: every `model_forward_*` segment,
    their sum against a fenced forward of the same batch."""
    import tempfile

    from mask3d_tpu_torch import cli
    from mask3d_tpu_torch.train import trainer as trainer_mod
    from mask3d_tpu_torch.utils import meter

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    cls = trainer_mod.InstanceSegmentationTrainer
    seen = []
    real_fit = cls.fit

    def recording_fit(self):
        seen.append(self)
        return real_fit(self)

    real_measure = trainer_mod.measure_model_phases
    fenced_s = []

    def fenced_after(cfg, model, batch, reps=3, device="cuda"):
        """The phase timer, then one warm-up and three fenced forwards of
        the same batch (the eval step's, `aux_masks`)."""
        from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
        from mask3d_tpu_torch.sparse.context import build_sparse_batch

        segs = real_measure(cfg, model, batch, reps, device)
        dev = batch.to(device)
        with torch.inference_mode():
            sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                                    level_capacities(cfg, dev.capacity),
                                    dev.grid_dims, **_sb_kwargs(cfg))
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.eval()(sb, dev.feats, dev.coords.float(),
                             dev.grid_dims, aux_masks=True)
                torch.cuda.synchronize()
                fenced_s.append(time.perf_counter() - t)
        return segs

    out = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        write_entry_dataset(np, root, n_train=TRAIN_LARGE_SCENES, n_test=2)
        args = ["train", "--device", "cuda", f"data.data_root={root}",
                "model.backbone_impl=bricked", "model.brick_dims=[8,8,8]",
                f"model.brick_capacity={TRAIN_LARGE_BRICK_CAPACITY}",
                "data.batch_size=2", "trainer.grad_accum_steps=2",
                "data.test_batch_size=1", "trainer.log_every_n_steps=1",
                "general.experiment_id=bricked",
                f"general.save_dir={tmp}/saved"]
        cls.fit = recording_fit
        try:
            for epochs in (1, 2):
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                rc = cli.main(args + [f"trainer.max_epochs={epochs}"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                tr = seen[-1]
                launches = {k: fn.launches for k, fn in counters.items()}
                files = sorted(os.listdir(tr.run_dir))
                out[f"epoch {epochs}"] = dict(
                    rc=rc, s=wall, step=tr.state.step, epoch=tr.epoch,
                    launches=launches, files=files,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                log(f"train_large cli train bricked (max_epochs={epochs}): "
                    f"{json.dumps(out[f'epoch {epochs}'])} on {card}")
            steps = TRAIN_LARGE_SCENES // 2
            first, second = out["epoch 1"], out["epoch 2"]
            # the resumed run trains one more epoch from the first one's
            # last-epoch.ckpt: its steps start at the first run's count
            ok = (first["rc"] == second["rc"] == 0
                  and first["step"] == steps and second["step"] == 2 * steps
                  and "last-epoch.ckpt" in second["files"]
                  and first["launches"]["masked_attention"] == 12 * (
                      2 * steps + 1))
            if not ok:
                failed.append(("cli train bricked / resume", out))

            # (e) measure_model_phases through cli test (fp32 dense); the
            # fenced forwards of the same batch run right after it, so
            # that both read the card in one state (on the H100, readings
            # minutes apart differed by 20%)
            trainer_mod.measure_model_phases = fenced_after
            meter.reset()
            rc = cli.main(["test", "--device", "cuda",
                           f"data.data_root={root}", "data.test_batch_size=2",
                           "trainer.measure_model_phases=true",
                           "general.experiment_id=phases",
                           f"general.save_dir={tmp}/saved"])
        finally:
            cls.fit = real_fit
            trainer_mod.measure_model_phases = real_measure
        stats = meter.get_statistics()
        phases = {k: v["mean"] for k, v in stats.items()
                  if k.startswith("model_forward_")
                  and k != "model_forward_complete"}
        fenced = statistics.mean(fenced_s[1:])
        total = sum(phases.values())
        out["phases"] = dict(segments=phases, sum_s=total, fenced_s=fenced,
                             sparse_context_build_s=stats.get(
                                 "sparse_context_build", {}).get("mean"))
        for name, sec in phases.items():
            log(f"  {name}: {sec * 1e3:.3f} ms")
        log(f"measure_model_phases (cli test, fp32 dense, batch 2): "
            f"model_forward_* sum {total * 1e3:.3f} ms vs a fenced forward "
            f"{fenced * 1e3:.3f} ms (tol {PHASE_SUM_TOL:.0%}); "
            f"sparse_context_build "
            f"{out['phases']['sparse_context_build_s'] * 1e3:.3f} ms")
        if not (rc == 0 and len(phases) == 4 + 3 + 1
                and all(v >= 0 for v in phases.values())
                and abs(total - fenced) <= PHASE_SUM_TOL * fenced):
            failed.append(("measure_model_phases", rc, out["phases"]))
    return out


def main():
    # deterministic cuBLAS for the train phase (`loop.configure_torch`),
    # set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    open_log()
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        log(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mask3d_tpu_torch as mt
        from mask3d_tpu_torch import config as cfg_mod
        from mask3d_tpu_torch import cuda_build
        from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
        from mask3d_tpu_torch.evalm import Mask3DEvaluator
        from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
        from mask3d_tpu_torch.models import backbone as bb_mod
        from mask3d_tpu_torch.models import mask3d as mask3d_mod
        from mask3d_tpu_torch.models.backbone import _GatherCtx
        from mask3d_tpu_torch.ops import masked_attention as ma
        from mask3d_tpu_torch.postprocess import postprocess_item
        from mask3d_tpu_torch.profile_forward import CONFIGS, flagship_items
        from mask3d_tpu_torch.sparse import chain as chain_mod
        from mask3d_tpu_torch.sparse import dense_ops, row_gather as rg
        from mask3d_tpu_torch.sparse import int8_conv as ic
        from mask3d_tpu_torch.sparse import int8_ops
        from mask3d_tpu_torch.sparse import ops as sparse_ops
        from mask3d_tpu_torch.sparse import sparse_conv as sc
        from mask3d_tpu_torch.sparse.context import build_sparse_batch
    except ImportError as e:
        log(f"chip_smoke: the port is not beside this script: {e}",
            file=sys.stderr)
        return 1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    t_start = time.perf_counter()

    def phase(name, fn):
        t = time.perf_counter()
        try:
            return fn()
        except Exception:
            failures.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None
        finally:
            log(f"[phase '{name}': {time.perf_counter() - t:.1f} s]")

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    def build():
        secs = cuda_build.build()
        log(f"built {', '.join(cuda_build.KERNELS)} in {secs:.2f} s")
        for name, text in cuda_build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        return secs

    if phase("build", build) is None:
        log("build failed; nothing else can run")
        return 1

    cfg = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}"])

    def collate():
        t = time.perf_counter()
        host = mt.collate(flagship_items(),
                          device="cuda",
                          point_bucket_multiple=BUCKET)
        log(f"collated 8 scenes in {time.perf_counter() - t:.2f} s: "
            f"capacity {host.device.capacity}, counts "
            f"{host.device.counts.tolist()}, grid {host.device.grid_dims}")
        return host

    host = phase("collate", collate)
    if host is None:
        return 1

    attn_rows = phase("attention kernel vs plain",
                      lambda: check_attention(torch, F, ma)) or []
    if not attn_rows or any(not r["ok"] for r in attn_rows):
        failures.append("attention kernel not checked, disagrees with its "
                        "plain version or does not repeat bitwise")
    gather_rows = phase("row gather kernel vs plain", lambda: check_gather(
        torch, rg, dense_ops, host.device,
        level_capacities(cfg, host.device.capacity))) or []
    if any(not r["equal"] for r in gather_rows):
        failures.append("row gather kernel disagrees with its plain version")
    if any(not r["fast"] for r in gather_rows):
        failures.append("row gather kernel slower than index_select")
    gather16_rows = phase("bf16 row gather kernel vs plain",
                          lambda: check_gather(
                              torch, rg, dense_ops, host.device,
                              level_capacities(cfg, host.device.capacity),
                              torch.bfloat16, BF16_GATHER_C)) or []
    if not gather16_rows or any(not r["equal"] for r in gather16_rows):
        failures.append("bf16 row gather not checked or disagrees with its "
                        "plain version")
    if any(not r["fast"] for r in gather16_rows):
        failures.append("bf16 row gather kernel slower than index_select")

    cfg_gp = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}",
                           "model.backbone_impl=gather_pallas"])
    cfg_g = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}",
                           "model.backbone_impl=gather"])
    sparse = (build_sparse_batch, level_capacities, _sb_kwargs)

    model = phase("build model",
                  lambda: mt.build_model(cfg, device="cuda", seed=0))
    launches = {}
    shape_launches = {}  # path -> sparse conv launches by (N, K, Cin, Cout)
    attn_launches = {}  # path -> attention launches by key length
    step_launches = {}  # path -> int8 conv launches by chain step
    int8_shapes = {}  # path -> int8 conv launches by (dims, Cin, Cout, k,
    # step)
    gather_dtypes = {}  # path -> row gather launches by dtype
    peak_gib = {}
    fwd_ms = {}
    counters = {"masked_attention": ma.masked_cross_attention,
                "row_gather": rg.row_gather, "sparse_conv": sc.sparse_conv,
                "int8_conv": ic.int8_conv}
    by_key = {"sparse_conv": (sc.sparse_conv.launches_by_shape,
                              shape_launches),
              "attention": (ma.masked_cross_attention.launches_by_shape,
                            attn_launches),
              "int8_steps": (ic.int8_conv.launches_by_step, step_launches),
              "int8_shapes": (ic.int8_conv.launches_by_shape, int8_shapes),
              "gather_dtypes": (rg.row_gather.launches_by_dtype,
                                gather_dtypes)}

    def counted_forward(path, mdl, c):
        """One forward with every count set to 0 just before it and read
        just after (`count_forward`: raises on an overflow); checks shapes
        and finiteness."""
        mt.infer(mdl, host.device, c, device="cuda")  # warm-up
        out, launches[path], keyed, peak_gib[path] = count_forward(
            torch, mt, counters, by_key, mdl, host.device, c)
        for name, (_, record) in by_key.items():
            record[path] = keyed[name]
        log(f"{path} path launches: {launches[path]}, int8 conv by step "
            f"{step_launches[path]}, row gather by dtype "
            f"{gather_dtypes[path]}; peak device memory "
            f"{peak_gib[path]:.2f} GiB")
        pc, pm = out.pred_class, out.pred_masks
        b, n = host.device.coords.shape[:2]
        q = c.model.num_queries
        assert tuple(pc.shape) == (b, q, c.model.num_classes + 1), pc.shape
        assert tuple(pm.shape) == (b, n, q), pm.shape
        assert bool(torch.isfinite(pc).all()) and bool(
            torch.isfinite(pm).all()), "non-finite outputs"
        return pc.cpu().numpy(), pm.cpu().numpy()

    n_dec = cfg.model.num_decoders * len(cfg.model.hlevels)

    def main_path():
        preds = counted_forward("dense", model, cfg)
        assert launches["dense"] == {"masked_attention": n_dec,
                                     "row_gather": 13,  # 5 taps + 4 x 2
                                     "sparse_conv": 0, "int8_conv": 0
                                     }, launches
        by_s = attn_launches["dense"]
        log(f"attention launches by key length: {by_s}")
        assert sorted(by_s) == sorted(r["S"] for r in attn_rows) == \
            list(ATTN_S), (by_s, ATTN_S)
        for r in attn_rows:
            r["launches"] = by_s[r["S"]]
        log(f"attention forward sums (launches x ms at each key length): "
            f"{sum(r['launches'] * r['ms'] for r in attn_rows):.4f} ms, "
            f"bound {sum(r['launches'] * r['bound_ms'] for r in attn_rows):.4f}"
            f" ms")
        return preds

    preds = phase("main path", main_path) if model is not None else None
    if preds is None:
        failures.append("main path did not run")

    def evaluate():
        pc, pm = preds
        dev = host.device
        counts = dev.counts.cpu().numpy()
        t = time.perf_counter()
        g = cfg.general
        items, targets = [], []
        for i in range(len(counts)):
            n = int(counts[i])
            items.append(postprocess_item(
                pc[i], pm[i, :n], host.raw_coords[i, :n], host.scenes[i],
                use_dbscan=g.use_dbscan, dbscan_eps=g.dbscan_eps,
                dbscan_min_points=g.dbscan_min_points,
                filter_out_instances=g.filter_out_instances,
                scores_threshold=g.scores_threshold,
                iou_threshold=g.iou_threshold))
            tv = dev.target.valid[i].cpu().numpy()
            targets.append({
                "labels": dev.target.labels[i].cpu().numpy()[tv],
                "masks": dev.target.masks[i].cpu().numpy()[tv][:, :n]})
        metrics = Mask3DEvaluator().evaluate(items, targets, "test")
        flat = {k: v for k, v in metrics.items() if not isinstance(v, dict)}
        log(f"metrics (random weights) after {time.perf_counter() - t:.1f} "
            f"s of postprocess+eval: {json.dumps(flat)}")
        assert all(np.isfinite(v) or np.isnan(v) for v in flat.values())

    if preds is not None:
        phase("postprocess and evaluator", evaluate)

    def reference():
        worst = small_reference(torch, mt, cfg_mod, make_synthetic_scene,
                                np)
        log(f"small forward, card vs CPU: max|diff|/max(1,std) {worst:.3g} "
            f"(tol 1e-4)")
        assert worst <= 1e-4, worst

    phase("card vs CPU at a small width", reference)

    gather_models = {}
    dense_ref = {}

    def path_stats(mdl, c, pc, pm):
        """diff_stats of a path's outputs and backbone maps against the
        dense forward on the same weights."""
        if not dense_ref:
            counts = host.device.counts.cpu().numpy()
            dense_ref["valid"] = (np.arange(preds[1].shape[1])[None]
                                  < counts[:, None])
            dense_ref["maps"] = backbone_maps(torch, model, cfg, host.device,
                                              sparse)
        valid = dense_ref["valid"]
        stats = {"pred_class": diff_stats(np, preds[0], pc),
                 "pred_masks": diff_stats(np, preds[1][valid], pm[valid])}
        maps = backbone_maps(torch, mdl, c, host.device, sparse)
        for i, (r, g) in enumerate(zip(dense_ref["maps"], maps)):
            stats[f"map{i} (stride {16 >> i})"] = diff_stats(np, r, g)
        return stats

    def gather_paths():
        """`gather` and `gather_pallas` at full width on the dense model's
        weights: launch counts, then outputs and backbone maps against the
        dense forward."""
        results = {}
        for path, c in (("gather", cfg_g), ("gather_pallas", cfg_gp)):
            mdl = mt.build_model(c, device="cuda", seed=0)
            mdl.load_state_dict(model.state_dict())
            pc, pm = counted_forward(path, mdl, c)
            # gather_pallas: the k=5 stem + 23 BasicBlocks x 2 convs, every
            # level eligible; gather runs them all in fp32 PyTorch
            assert launches[path] == {
                "masked_attention": n_dec, "row_gather": 0,
                "sparse_conv": 47 if path == "gather_pallas" else 0,
                "int8_conv": 0}, launches
            assert sum(shape_launches[path].values()) == \
                launches[path]["sparse_conv"], shape_launches
            stats = path_stats(mdl, c, pc, pm)
            for what, st in stats.items():
                log(f"{path} vs dense {what}: {json.dumps(st)}; within the "
                    f"JAX bf16 bounds {within_bf16_bounds(st)}")
            results[path] = stats
            gather_models[path] = (mdl, c)
        ratios = {path: gate_ratio(path, st) for path, st in results.items()}
        log(f"gate ratios against dense (pass at <= 1): {ratios}")
        for path, ratio in ratios.items():
            assert ratio <= 1.0, (path, results[path])

    if model is not None and preds is not None:
        phase("gather paths at full width", gather_paths)

    def sparse_conv_check():
        dev = host.device
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg_gp, dev.capacity), dev.grid_dims,
            **_sb_kwargs(cfg_gp))
        shapes = shape_launches["gather_pallas"]
        log(f"sparse_conv launches by (N, K, Cin, Cout) in the counted "
            f"gather_pallas forward: {shapes}")
        return check_sparse_conv(torch, sc, sb, shapes)

    spconv_rows = phase("sparse conv kernel vs plain",
                        sparse_conv_check) or []
    if not spconv_rows or any(not r["ok"] for r in spconv_rows):
        failures.append("sparse conv kernel not checked, disagrees with "
                        "its plain version or does not repeat bitwise")

    def planted_faults():
        """Each fault, patched in at run time and taken out again, must
        fail the gate of each gather path that its sound forward passed."""
        conv = _GatherCtx._conv

        def drop_offset(self, x, w, idx, ok):
            ok = ok.clone()
            ok[..., 0] = False
            return conv(self, x, w, idx, ok)

        def sum_pool(x, pool, cap):
            return sparse_ops.avg_pool(x, pool, cap) * \
                pool.nchild.clamp(min=1)[..., None]

        faults = {"offset 0 dropped in every same-stride conv":
                  (_GatherCtx, "_conv", drop_offset),
                  "pooled pyramid sums instead of averaging":
                  (mask3d_mod, "avg_pool", sum_pool)}
        for name, (owner, attr, fake) in faults.items():
            for path, (mdl, c) in gather_models.items():
                real = getattr(owner, attr)
                setattr(owner, attr, fake)
                try:
                    out, _ = mt.infer(mdl, host.device, c, device="cuda")
                    stats = path_stats(mdl, c, out.pred_class.cpu().numpy(),
                                       out.pred_masks.cpu().numpy())
                finally:
                    setattr(owner, attr, real)
                ratio = gate_ratio(path, stats)
                log(f"planted fault '{name}' on {path}: gate ratio "
                    f"{ratio:.4g} (must be > 1); "
                    f"{json.dumps({w: st['mean'] for w, st in stats.items()})}"
                    f" mean |diff|")
                assert ratio > 1.0, (name, path, ratio)

    if len(gather_models) == 2:
        phase("planted faults fail the gather gates", planted_faults)
    else:
        failures.append("planted faults not run")

    def reference_gp():
        maps, final = small_reference_gather(
            torch, mt, cfg_mod, make_synthetic_scene, np, sparse)
        for i, stats in enumerate(maps):
            log(f"small gather_pallas backbone map {i}, card vs CPU: "
                f"{json.dumps(stats)} (bounds {BF16_BOUNDS})")
        # printed, not gated: with random weights at this width the
        # decoder's mask thresholds amplify bf16 rounding flips (mean |diff|
        # 4x the full-width gate); the decoder on the gather paths is gated
        # by the full-width `gather` outputs against dense
        for what, st in final.items():
            log(f"small gather_pallas {what}, card vs CPU: {json.dumps(st)}")
        assert all(within_bf16_bounds(st) for st in maps), maps

    phase("gather_pallas card vs CPU at a small width", reference_gp)

    # --- the JAX bench's inference stack: bf16, int8, int8 + chain ---
    int8_models = {}
    int8_runs = {}  # path -> backbone_run(...) + the forward's outputs
    counts0 = host.device.counts.cpu().numpy()
    valid0 = np.arange(host.device.capacity)[None] < counts0[:, None]

    def cfg_of(path):
        return cfg_mod.apply_overrides(
            cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}"]
            + CONFIGS[path])

    def pair_stats(ref, got):
        """diff_stats of got's outputs and backbone maps against ref's."""
        stats = {"pred_class": diff_stats(np, ref["preds"][0],
                                          got["preds"][0]),
                 "pred_masks": diff_stats(np, ref["preds"][1][valid0],
                                          got["preds"][1][valid0])}
        for i, (r, g) in enumerate(zip(ref["maps"], got["maps"])):
            stats[f"map{i} (stride {16 >> i})"] = diff_stats(np, r, g)
        return stats

    def stage8_gate(want, got):
        """int8_chain against int8 on the stage-8 grid: the JAX package's
        fused-vs-unfused tolerance with the stage's static bound."""
        ratio, med, med_step = chain_tol_ratio(
            torch, want["grid"], got["grid"], got["bounds"][8], got["occ"])
        return dict(ratio=ratio, median=med, median_step=med_step,
                    ok=ratio <= 1.0 and med < med_step)

    def int8_paths():
        """The three configurations at full width on the dense model's
        weights: launch counts, then each against the one it departs
        from."""
        ref = dict(preds=preds, maps=backbone_run(
            torch, bb_mod, model, cfg, host.device, sparse)["maps"])
        for path in INT8_PATHS:
            c = cfg_of(path)
            mdl = mt.build_model(c, device="cuda", seed=0)
            mdl.load_state_dict(model.state_dict())
            p = counted_forward(path, mdl, c)
            want = {"masked_attention": n_dec, "row_gather": 13,
                    "sparse_conv": 0,
                    "int8_conv": sum(INT8_STEPS[path].values())}
            assert launches[path] == want, (launches[path], want)
            assert step_launches[path] == INT8_STEPS[path], step_launches
            assert gather_dtypes[path] == GATHER_BY_DTYPE, gather_dtypes
            assert sum(int8_shapes[path].values()) == \
                launches[path]["int8_conv"], int8_shapes
            int8_models[path] = (mdl, c)
            int8_runs[path] = dict(backbone_run(
                torch, bb_mod, mdl, c, host.device, sparse,
                stages_in=(8,) if path == "int8_chain" else ()), preds=p)
        int8_runs["fp32"] = ref
        gates = {}
        for path, base, tol in (("bf16", ref, BF16_STACK_MEAN),
                                ("int8", int8_runs["bf16"], INT8_PATH_MEAN)):
            stats = pair_stats(base, int8_runs[path])
            for what, st in stats.items():
                log(f"{path} vs {'fp32 dense' if path == 'bf16' else 'bf16'}"
                    f" {what}: {json.dumps(st)}")
            gates[path] = worst_ratio(stats, "mean", tol)
            log(f"{path} gate: worst mean |diff| / max(1, std) "
                f"{gates[path] * tol:.4g} against {tol} (ratio "
                f"{gates[path]:.4g}, passes at <= 1)")
        whole = stage8_gate(int8_runs["int8"], int8_runs["int8_chain"])
        log(f"int8_chain vs int8, stage-8 grid of the two forwards "
            f"(printed: stage 7 differs too): {json.dumps(whole)}")
        reads = [stage8_fused_vs_unfused() for _ in range(STAGE8_READS)]
        for chain_gate in reads:
            log(f"stage 8 on the int8_chain forward's input, fused vs "
                f"unfused (the gate): {json.dumps(chain_gate)}")
        ratios = [r["ratio"] for r in reads]
        log(f"stage 8 gate over {len(reads)} readings: ratio min "
            f"{min(ratios):.4g}, max {max(ratios):.4g}, all equal "
            f"{len(set(ratios)) == 1}")
        assert gates["bf16"] <= 1.0 and gates["int8"] <= 1.0, gates
        assert all(r["ok"] for r in reads), reads

    def stage8_fused_vs_unfused():
        """Stage 8 of the int8_chain model on the input its counted
        forward's stage 8 received, fused and unfused (the int8 path's
        blocks): the JAX package's own comparison
        (tests/test_pallas_chain.py:154-196) at full width."""
        bb = int8_models["int8_chain"][0].backbone
        inp = int8_runs["int8_chain"]["inputs"][8]
        with torch.inference_mode():
            fused, fb = bb._blocks(inp["ctx"], 8, inp["x"], 0, inp["bound"])
            bb.pallas_chain = False
            try:
                unfused, _ = bb._blocks(inp["ctx"], 8, inp["x"], 0,
                                        inp["bound"])
            finally:
                bb.pallas_chain = True
        ratio, med, med_step = chain_tol_ratio(
            torch, unfused, fused, fb, inp["ctx"].occ[0])
        return dict(ratio=ratio, median=med, median_step=med_step,
                    ok=ratio <= 1.0 and med < med_step)

    if model is not None and preds is not None:
        phase("bf16 / int8 / int8_chain at full width", int8_paths)

    def int8_conv_check():
        dev = host.device
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg, dev.capacity), dev.grid_dims,
            **_sb_kwargs(cfg))
        shapes = dict(int8_shapes["int8"])
        shapes.update({k: v for k, v in int8_shapes["int8_chain"].items()
                       if k[4] != "conv"})
        log(f"int8_conv launches by (grid, Cin, Cout, k, step) in the "
            f"counted int8 / int8_chain forwards: {shapes}")
        return check_int8_conv(torch, F, ic, sb, shapes)

    int8_rows = phase("int8 conv kernel vs plain", int8_conv_check) or []
    if not int8_rows or any(not (r["equal"] and r["repeat_equal"]
                                 and r["stats_ok"]) for r in int8_rows):
        failures.append("int8 conv kernel not checked, disagrees with its "
                        "plain version or does not repeat bitwise")

    def int8_faults():
        """Each fault, patched in at run time and taken out again, must
        fail its gate: the junction's residual term dropped (stage 8 fused
        against unfused), the int8 activation scale sx doubled where
        activations are quantized while the weights keep sx (int8 against
        bf16), and the dense norms normalizing without subtracting the
        mean (bf16 against fp32)."""
        real_conv = chain_mod.int8_conv
        real_quantize = int8_ops.quantize

        def no_residual(x, occ, wq, sw, mode="none", **kw):
            if mode == "join":
                kw["Ar"] = torch.zeros_like(kw["Ar"])
                kw["Br"] = torch.zeros_like(kw["Br"])
            return real_conv(x, occ, wq, sw, mode, **kw)

        def doubled_sx(x, sx):
            return real_quantize(x, 2.0 * sx)

        def norm_without_mean(x, occ, gamma, beta, eps=1e-5):
            x32 = x.float()
            cnt = occ.float().sum(dim=(1, 2, 3), keepdim=True).clamp_min(1)
            sq = (x32 * x32).sum(dim=(1, 2, 3), keepdim=True) / cnt
            k = (torch.rsqrt(sq + eps) * gamma).to(x.dtype)
            return x * k + occ.to(x.dtype) * beta.to(x.dtype)

        chain_mod.int8_conv = no_residual
        try:
            g = stage8_fused_vs_unfused()
        finally:
            chain_mod.int8_conv = real_conv
        log(f"planted fault 'junction residual dropped': stage 8 fused vs "
            f"unfused {json.dumps(g)} (must fail)")
        assert not g["ok"], g
        faults = (("sx doubled in the int8 activation quantize", "int8",
                   int8_ops, "quantize", doubled_sx, "bf16",
                   INT8_PATH_MEAN),
                  ("the dense norms skip the mean", "bf16", dense_ops,
                   "dense_instance_norm", norm_without_mean, "fp32",
                   BF16_STACK_MEAN))
        for name, path, owner, attr, fake, base, tol in faults:
            mdl, c = int8_models[path]
            real = getattr(owner, attr)
            setattr(owner, attr, fake)
            try:
                out, _ = mt.infer(mdl, host.device, c, device="cuda")
                run = backbone_run(torch, bb_mod, mdl, c, host.device,
                                   sparse)
            finally:
                setattr(owner, attr, real)
            run["preds"] = (out.pred_class.cpu().numpy(),
                            out.pred_masks.cpu().numpy())
            stats = pair_stats(int8_runs[base], run)
            ratio = worst_ratio(stats, "mean", tol)
            log(f"planted fault '{name}' on {path}: worst mean |diff| / "
                f"max(1, std) {ratio * tol:.4g} (gate ratio {ratio:.4g}, "
                f"must be > 1); "
                f"{json.dumps({w: st['mean'] for w, st in stats.items()})}")
            assert not ratio <= 1.0, (name, ratio)  # NaN fails as well

    if len(int8_models) == len(INT8_PATHS):
        phase("planted faults fail the int8 gates", int8_faults)
    else:
        failures.append("int8 planted faults not run")

    def reference_int8():
        """int8_chain at a small width and bucket 1024 with MIN_ROWS 0
        (stages 7 and 8 fuse), card against CPU. The gate: each fused stage
        on the input the CPU forward gave it, card (kernels) against CPU
        (plain versions), median |diff| 0 over occupied cells and within
        the fused-vs-unfused tolerance everywhere. The backbone maps of the
        two whole forwards are printed: the bf16 convs before the first
        int8 conv round in another order on cuDNN, and int8 quantization
        turns those flips into whole steps."""
        import types

        real_min = chain_mod.MIN_ROWS
        chain_mod.MIN_ROWS = 0
        try:
            c, host_s, cpu_model, gpu_model = small_models(
                mt, cfg_mod, make_synthetic_scene, np, "dense", 1024,
                "Res16UNet18A", CONFIGS["int8_chain"])
            ic.int8_conv.launches_by_step.clear()
            ref = backbone_run(torch, bb_mod, cpu_model, c, host_s.device,
                               sparse, stages_in=(7, 8))
            got = backbone_run(torch, bb_mod, gpu_model, c,
                               host_s.device.to("cuda"), sparse)
        finally:
            chain_mod.MIN_ROWS = real_min
        steps = dict(ic.int8_conv.launches_by_step)
        log(f"small int8_chain on the card launched {steps}")
        assert all(steps.get(k) for k in ("entry", "mid", "junction"))
        for i, (r, g) in enumerate(zip(ref["maps"], got["maps"])):
            ratio, med, _ = chain_tol_ratio(
                torch, r, g, ref["bounds"][STAGE_OF_MAP[i]], None)
            log(f"small int8_chain backbone map {i}, card vs CPU (printed):"
                f" tol ratio {ratio:.4g}, median |diff| {med:.4g}, "
                f"{json.dumps(diff_stats(np, r, g))}")
        results = []
        for stage, level in ((7, 1), (8, 0)):
            inp = ref["inputs"][stage]
            gctx = types.SimpleNamespace(
                occ=[o.cuda() for o in inp["ctx"].occ])
            with torch.inference_mode():
                want, bound_out = cpu_model.backbone._blocks_fused(
                    inp["ctx"], stage, inp["x"], level, inp["bound"])
                have, _ = gpu_model.backbone._blocks_fused(
                    gctx, stage, inp["x"].cuda(), level,
                    inp["bound"].cuda())
            ratio, med, med_step = chain_tol_ratio(
                torch, want, have.cpu(), bound_out, inp["ctx"].occ[level])
            log(f"small fused stage {stage} on one input, card vs CPU: tol "
                f"ratio {ratio:.4g}, median |diff| {med:.4g} (median step "
                f"{med_step:.4g}), max |diff| "
                f"{float((have.cpu().float() - want.float()).abs().max()):.4g}")
            results.append((ratio, med))
        assert all(r <= 1.0 and m == 0.0 for r, m in results), results

    phase("int8_chain card vs CPU at a small width", reference_int8)

    def timing(path, mdl, c):
        ms = fwd_ms.setdefault(path, [])
        for _ in range(2):
            mt.infer(mdl, host.device, c, device="cuda")
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(mdl, host.device, c, device="cuda")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        log(f"flagship {path} forward, batch 8, bucket {BUCKET}: median "
            f"{statistics.median(ms):.2f} ms over 10 "
            f"(min {min(ms):.2f}, max {max(ms):.2f}) on {card}")

    if model is not None and preds is not None:
        phase("forward timing", lambda: timing("dense", model, cfg))
    for path, (mdl, c) in list(gather_models.items()) + list(
            int8_models.items()):
        phase(f"{path} forward timing",
              lambda: timing(path, mdl, c))

    def kernel_entry(name, source, replaces, rows, main, n_launches,
                     **extra):
        """`main` is the row of the shape the summary keys report;
        `n_launches` the count of the counted forward of the path that
        runs the kernel."""
        main = main or {}
        return extra | {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": max((r["max_abs_err"] for r in rows),
                               default=None),
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"),
            "bound_by": main.get("bound_by"),
            "library_ms": main.get("library_ms"),
            "shapes": rows,
        }

    large = phase("large_scene", lambda: run_large_scene(
        torch, F, np, mt, counters, by_key, sparse, (ma, rg, sc)))
    if large is None:
        failures.append("large_scene did not run or failed a check")

    entry_launches = phase("test_entry", lambda: run_test_entry(
        torch, np, mt, counters, card))
    if entry_launches is None:
        failures.append("test entry did not run or failed a check")
    launches["test_entry"] = entry_launches

    # --- the train path (deterministic algorithms from here on) ---
    from mask3d_tpu_torch.train.loop import configure_torch

    configure_torch(True)
    train = {}

    def train_forward_lengths():
        rows = check_attention(torch, F, ma, TRAIN_ATTN_S)
        assert all(r["ok"] for r in rows), rows
        return rows

    train["attention_forward"] = phase(
        "train: attention kernel vs plain at the sampled key lengths",
        train_forward_lengths)

    def backwards():
        dev = host.device
        sb_gp = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg_gp, dev.capacity), dev.grid_dims,
            **_sb_kwargs(cfg_gp))
        return check_backwards(
            torch, F, ma, rg, sc, sparse_ops, dense_ops, host,
            level_capacities(cfg, host.device.capacity), sb_gp,
            shape_launches["gather_pallas"])

    train["backward"] = phase("train: backwards vs the plain path",
                              backwards)
    train["step_launches"] = phase(
        "train: step gradients, determinism, gather_pallas",
        lambda: check_train_step_paths(torch, mt, counters, by_key, cfg,
                                       cfg_gp, host, card))
    train["entry"] = phase("train: cli train end to end",
                           lambda: run_train_entry(torch, np, mt, counters,
                                                   by_key, card))
    train["batch16"] = phase("train: batch 16 memory",
                             lambda: check_batch16_memory(
                                 torch, mt, counters, by_key, cfg, card))
    for name, value in train.items():
        if value is None:
            failures.append(f"train phase {name} did not run or failed a "
                            f"check")

    train_large = phase("train_large", lambda: run_train_large(
        torch, F, np, mt, counters, by_key, card, host, (ma, rg, sc)))
    if train_large is None:
        failures.append("train_large did not run or failed a check")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    log(card)
    def forward_sums(rows):
        return dict(
            forward_ms=sum(r["launches"] * r["ms"] for r in rows),
            forward_bound_ms=sum(r["launches"] * r["bound_ms"]
                                 for r in rows))

    def heaviest(rows):
        return max(rows, key=lambda r: r["launches"] * r["ms"],
                   default=None)

    int8_entries = []
    for step in ("conv", "entry", "mid", "junction"):
        path = "int8" if step == "conv" else "int8_chain"
        rows = [r for r in int8_rows if r["step"] == step]
        # the flagship's junctions take the bf16 residual of a 1x1
        fwd_rows = [r for r in rows if r["res"] != "int8"]
        int8_entries.append(kernel_entry(
            f"int8_conv:{step}", "mask3d_tpu_torch/csrc/int8_conv.cu",
            "mask3d_tpu/sparse/pallas_chain.py:512", rows,
            heaviest(fwd_rows), step_launches.get(path, {}).get(step, 0),
            bound_ms_whole_grid=(heaviest(fwd_rows) or {}).get(
                "bound_ms_whole_grid"),
            cudnn_bf16_ms_not_the_same_function=(heaviest(fwd_rows) or {}
                                                 ).get("cudnn_bf16_ms"),
            **forward_sums(fwd_rows)))
    log(json.dumps({"kernels": [
        kernel_entry("masked_attention",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102", attn_rows,
                     attn_rows[-1] if attn_rows else None,
                     launches["dense"]["masked_attention"],
                     **forward_sums(attn_rows)),
        kernel_entry("row_gather", "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather_rows,
                     next((r for r in gather_rows if r["C"] == 96), None),
                     launches["dense"]["row_gather"]),
        kernel_entry("row_gather_bf16",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather16_rows,
                     next((r for r in gather16_rows if r["C"] == 96), None),
                     gather_dtypes["bf16"]["bfloat16"]),
        kernel_entry("sparse_conv", "mask3d_tpu_torch/csrc/sparse_conv.cu",
                     "mask3d_tpu/sparse/pallas_conv.py:316", spconv_rows,
                     heaviest(spconv_rows),
                     launches["gather_pallas"]["sparse_conv"],
                     **forward_sums(spconv_rows)),
        *int8_entries,
        # the same kernels at the hall scene's shapes (phase large_scene)
        kernel_entry("masked_attention:hall",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102",
                     large["attention"], large["attention"][-1],
                     large["impls"]["bricked"]["launches"][
                         "masked_attention"],
                     **forward_sums(large["attention"])),
        kernel_entry("row_gather_bf16:brick_tap",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198",
                     [large["brick_tap"]], large["brick_tap"],
                     large["impls"]["bricked"]["launches"]["row_gather"]),
        kernel_entry("sparse_conv:hall",
                     "mask3d_tpu_torch/csrc/sparse_conv.cu",
                     "mask3d_tpu/sparse/pallas_conv.py:316",
                     large["sparse_conv"], heaviest(large["sparse_conv"]),
                     large["impls"]["gather_pallas"]["launches"][
                         "sparse_conv"],
                     **forward_sums(large["sparse_conv"])),
        # the train_large phase's counted steps: bricked fp32 in 8 x 1
        # micro-batches (attention, the row gather: 4 dense taps and the
        # brick tap a micro-batch) and gather_pallas in bf16 (sparse conv)
        kernel_entry("masked_attention:train_large",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102",
                     train_large["attention"], train_large["attention"][-1],
                     train_large["launches"]["bricked fp32 (kernels)"][
                         "masked_attention"],
                     **forward_sums(train_large["attention"])),
        kernel_entry("row_gather:train_large",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather_rows,
                     next((r for r in gather_rows if r["C"] == 96), None),
                     train_large["launches"]["bricked fp32 (kernels)"][
                         "row_gather"],
                     hall_brick_tap_backward=train_large[
                         "hall_brick_tap_backward"]),
        kernel_entry("sparse_conv:train_large",
                     "mask3d_tpu_torch/csrc/sparse_conv.cu",
                     "mask3d_tpu/sparse/pallas_conv.py:316", spconv_rows,
                     heaviest(spconv_rows),
                     train_large["launches"]["gather_pallas bf16"][
                         "sparse_conv"],
                     hall_backward_l0=train_large[
                         "hall_sparse_conv_backward"]),
    ], "launches_by_path": launches, "int8_steps_by_path": step_launches,
        "peak_gib": peak_gib, "forward_ms": fwd_ms, "train": train,
        "large_scene": {
            "scene": large["scene"], "gates": large["gates"],
            "brick_gates": large["brick_gates"],
            "brick_faults": large["brick_faults"],
            "hall_fault": large["hall_fault"],
            "bf16_vs_bricked_bf16": large["bf16_vs_bricked_bf16"],
            "impls": {k: {f: v[f] for f in ("launches", "ms", "ms_all",
                                            "points_per_s", "peak_gib")}
                      for k, v in large["impls"].items()}},
        "train_large": {k: train_large[k] for k in (
            "launches", "bricked_fp32", "bf16_gates", "bf16_faults", "steps",
            "hall", "hall_sparse_conv_backward", "hall_brick_tap_backward")}
        | {"entry": {k: v for k, v in train_large["entry"].items()}}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        # whatever escapes main() reaches the log file before the exit
        log(f"chip_smoke: uncaught exception\n{traceback.format_exc()}",
            file=sys.stderr)
        sys.exit(1)
    sys.exit(rc)
