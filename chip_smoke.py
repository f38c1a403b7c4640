#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`mask3d_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one, or when the package is not
beside this script. Phases:

1. Card and build: prints the card's name and power limit, builds the five
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
   step each (retried
   with `model.remat_backbone=true` where it does not fit), its seconds
   and peak memory, and the backwards at the hall's
   level-0 shapes timed beside their bounds: the sparse conv's (bf16
   feats) and the brick tap's scatter-add; (d) `cli train` on `bricked`
   (8^3 bricks) at batch 2 as two micro-batches of one scene, one
   validation at test_batch_size 1, then a second epoch resumed from its
   `last-epoch.ckpt`; (e) `cli test` with
   `trainer.measure_model_phases=true`: every `model_forward_*` segment,
   the median of their sum over PHASE_ROUNDS rounds within PHASE_SUM_TOL
   of the median of fenced forwards of the same batch run in turn with
   them, and each segment above twice the tolerance, left out of the sum,
   failing it; and the attention at the micro-batches' key lengths (B=1).

11. `roomformer`, the RoomFormer baseline (`mask3d_tpu_torch/baseline/`,
   plain PyTorch: no kernel of its own): (a) the JAX tests' tiny
   configuration with seeded weights, card against CPU: the forward
   (RF_FWD_TOL), one train step's loss (RF_LOSS_TOL relative) and every
   gradient leaf (RF_GRAD_TOL * max(1, max |leaf|)); (b) the deformable
   sampler's gather form against a `F.grid_sample` composition of the same
   function at RoomFormer()'s shapes (5,440 encoder and 800 decoder
   queries, batch 8), within RF_SAMPLER_TOL, a planted fault (x and y
   swapped in the sampler) failing it, both timed; (c) RoomFormer() (12.06M
   parameters) eval forward on 8 density maps of written Structured3D-layout
   scenes: the median of 10 fenced forwards, ms by phase (CUDA events at the
   backbone, encoder and decoder), peak GiB; (d) its train step through the
   engine (loss_raster at 64^2, AdamW, deterministic): seconds a step, peak
   GiB, two steps twice from one seed bitwise equal, 20 steps on one batch
   lowering the loss; (e) `engine train` 2 epochs at batch 8, then `engine
   eval --checkpoint last-epoch.ckpt --mask3d_bridge --export_las`: the
   metric keys, one .las per test scene, seconds a batch of data, forward
   and post-processing. Its criterion matches with the LSAP kernel.

12. `bench_input`, the JAX bench's input path (`bench.py:246-285`) on
   phase 3's 8 scenes: `encode_batch`'s C++ and numpy buffers
   byte-identical; the card's decode of the pinned copy equal to the
   collated keys, counts and dims, and the sparse batch built from the
   decoded precomputed levels equal to the device build, bit for bit; a
   planted fault (the base level's last escape record dropped) must fail
   that gate; `infer_u8` against `infer` on the same weights in fp32 and
   bf16 with `model.unit_features=true` (ones features), counted (12
   attention, 13 row gathers; 9 of them bf16 in bf16), bitwise or within
   1e-6 * max(1, std) with the reason printed; buffer bytes against the
   coordinates', the host encode's ms (C++, numpy), the pinned copy's, the
   decode's, the precomputed build's against the device build's, and each
   forward's.
13. `lsap`: the Jonker-Volgenant kernel against the plain JV on the card at
   13 x 8 problems of 25 x I (I the batch's padded instance count), 13 x 8
   of 100 x 32, RoomFormer's 6 x 8 of 20 x 20 and the tied fixtures of
   `tests/test_torch_lsap.py`: every assignment equal, a second launch
   bitwise equal; timed by graph replay beside the eager call, the plain
   JV, the scipy round trip (`method="host"`) and the bound (the costs'
   bytes; 4 operations a column at each search step the plain JV took).
   The criteria of phases 8-11 match with this kernel (`lsap_method`'s
   default), one launch a criterion call, counted with the others.
14. `preprocess`, the data-preparation path into `cli test` (host numpy
   but (e)): (a) 4 raw Structured3D-layout scenes (PREP_SCENES: 2 test,
   one train, one validation) of 3x2 rooms with 200 mm walls and a door,
   one PREP_PANO depth panorama a room ray-cast against the room's box,
   written by the port's PNG writer with every row filter in turn; the C++
   unfilter and the numpy reference read one scene's panoramas equal to
   each other and to what was written, and a copy with one row's filter
   type changed (PREP_FAULT_ROW) must fail that gate; (b) `stru3d.main` in
   a spawn pool of PREP_WORKERS: every scene in `run_valid_scenes.txt`,
   and in two scenes every point inside room r's polygon carries room id
   r and r's type; seconds and points a scene, the unproject / label /
   unique split; (c) `downsample.main` at each of PREP_VOXEL_SIZES:
   voxels and seconds, `native.downsample_native` equal to numpy's
   quantize + unique (vox and keep) on a full scene, the written
   `point_cloud_rasterized_{vs}.ply` equal to the records; (d)
   `analyze.main` and `kfold_splits`, their keys; (e) `cli test` on the
   card at each voxel size (`Config()` defaults, fp32 dense, seeded random
   weights, one batch of the 2 test scenes, `run_test_entry`'s hooks): 12
   attention, 13 row-gather and 1 LSAP launches, finite outputs, the
   metric keys; voxels a scene, bucket, seconds a batch by layer, points/s
   and peak GiB.
15. `parallel`, data and sequence parallelism (`mask3d_tpu_torch/
   parallel/`; deterministic algorithms on): (a) one flagship train step
   (batch 8 of phase 3's scenes, fp32 `dense`, kernels on) through the
   port's dp step on a one-rank NCCL group against phase 9 (b)'s step with
   no group (loss and every leaf bitwise, else within PAR_BITWISE_TOL x
   max(1, max|leaf|) with the reason printed), the gradient all-reduce's
   ms and bytes; the same step with the stem's weights 1 ulp up, its
   distance printed as the rounding floor. (b) Two spawned gloo ranks
   sharing the card (the kernels loaded as built, none rebuilt), each
   counted (12 attention, 13 row gathers, 1 LSAP a step): dp=2 with 4
   scenes a rank, padded to the pair's shapes: with whole levels as
   memories against one process's 2 x 4 accumulation (the same conv
   shapes a micro-batch), every leaf within PAR_LEAF_TOL x max(1,
   max|leaf|), and with sampled memories against (a)'s step, within
   PAR_STEP_TOL by `leaf_errors`; sp=2: the flagship eval forward (levels
   0-3 as x-slabs, level 4 whole) within JAX's bounds (PAR_SP_BOUNDS) of
   the unsharded forward, and a train step within PAR_STEP_TOL of (a)'s,
   the decoder's and the criterion's rows in a chunk a rank (12 attention
   launches, every one the partial form); sp=2 train steps on
   `gather_pallas` and `bricked` (the backbone whole on each rank; the
   first PAR_IMPL_SCENES scenes, `bricked` as micro-batches of one scene)
   each within PAR_STEP_TOL of its impl's one-process step; each rank's
   seconds, peak GiB and bytes by collective, the rows' bytes
   (PAR_ROW_BYTES) beside an all-reduce of the same rows whole. Planted
   faults that must fail their gates: the CE normaliser left local, one
   side of the halo exchange zeroed, the replicated (query-side)
   gradients summed over sp, the criterion's mask sums left rank-local.
   Before the ranks: two flagship `gather_pallas` forwards with
   deterministic algorithms off, bitwise equal (the segment sums' fixed
   order; `scatter_add_`'s atomics printed beside); the attention's
   partial form as the sp step runs it on a sampled memory, at the full
   sampled key length on each of two ranks (a random split of the slots,
   the absent ones dropped, the triples combined), its gradients against
   the plain form's within ATTN_TOL, its forward and its plain-PyTorch
   backward timed beside their bounds. (c)
   `InstanceSegmentationTrainer.fit()` on those ranks (8 written flagship
   scenes at batch 4, 1 epoch, then a validation of 2 scenes): rank 1
   opens no file for writing, both ranks' validation metrics equal, and
   every metric equal bit for bit to a one-process trainer's on rank 0's
   weights that forwards each rank's items at the ranks' shapes
   (`ranks_shaped_validation`); the one-process validation at the global
   batch's shapes printed beside it.

16. `model_zoo`, the rest of the model: (a) the bottleneck Res16UNet101
   at full width (PLANES x 4: every feature map 1024 wide; `Config()`'s
   decoder) on phase 3's 8 scenes through `infer`, one set of seeded
   weights, on `dense` in fp32 (batch 4 where batch 8 does not fit, the
   cut printed), `dense` in bf16 and `gather_pallas`, each counted
   (attention 12, row gathers 13 / 13 / 0, sparse convs 0 / 0 / 41), timed
   (median of ZOO_REPS) with its peak GiB, and bf16 and gather_pallas
   against fp32 dense read as ratios to BF16_STACK_MEAN and
   BF16_PATH_MEAN (phases 4 and 5) and printed, not gated: bf16 noise
   grows with depth in this random-weight net; those paths are gated in
   (c) instead; the row gather at the 1024-wide level-0 tap in f32 and bf16
   (bitwise) and the sparse conv at every shape the counted gather_pallas
   forward launched, against their plain versions, timed beside their
   bounds. (b) The decoder options at `Config()`'s width on Res16UNet34C,
   fp32 dense, batch 8 (ZOO_COMBOS): 12 attention launches each, finite
   outputs, `sampled_coords` where the queries come from FPS; the random
   ones twice from one seed, bitwise equal; one train step of the first,
   every new parameter with a finite nonzero gradient. (c) At a small
   width, card against CPU: a shallow bottleneck (every LAYERS entry 1)
   in fp32 within phase 4's fp32 form (FP32_PATH_TOL), the first
   combination within phase 3's tolerance; the shallow
   bottleneck's maps in bf16 on `dense` within BF16_STACK_MEAN (phase 5)
   and on `gather_pallas` within phase 4's bf16 bounds; the level
   embedding skipped in round 2 on the card must fail phase 3's
   tolerance. (d) `cli test` with
   ZOO_CLI on 8 written scenes (one batch): the metric keys, 12 / 13 / 1
   attention, row-gather and LSAP launches, seconds a batch by layer.
17. `config_matrix`, the rest of `Config`: (a) Res16UNet101 at full width
   on `dense` with `int8` and `int8_chain` (`profile_forward.CONFIGS`) on
   phase 3's 8 scenes, one set of seeded weights: counted (attention 12,
   gather 13, the int8 convs by shape, none a fused chain step: a
   bottleneck runs the unfused int8 blocks, bitwise `int8`'s), timed
   (median of MATRIX_REPS), peak GiB; the int8 outputs' distance from
   bf16 on the same weights printed; the int8 conv kernel against its
   plain version at every shape that forward launched (Cout up to 1024 in
   channel groups; bitwise, a second launch bitwise), each timed by graph
   replay beside its bound, the plain version and, for a 1x1,
   `torch._int_mm` (cuBLAS's int8 product); a shallow bottleneck whose
   planes reach 96-128 in `int8`, card against CPU within INT8_PATH_MEAN.
   (b) The attention kernel's partial form on two halves of the keys at
   the flagship's key lengths against its plain form, combined against
   the one-shot attention within ATTN_TOL, timed; a combine reading one
   rank's max for both must fail. Two gloo ranks sharing the card
   (MATRIX_SP): `Config()` at sp=2 on `dense` and `gather_pallas` with the
   decoder's rows sharded, a shallow bottleneck with the gate at
   Res16UNet50's widths on two scenes in fp32, bf16 and `int8`, each
   against the one-process forward at its own precision within JAX's
   sharded bounds (`par_excess`), 12 partial attention launches; the
   gate's mean over the rank's slab only (a planted fault) outside them;
   the decoder's row bytes against an all-reduce of the same rows whole
   (the inputs of a train-mode forward's reduce-scatters, which move the
   eval forward's rows); a slab's int8 conv
   against the whole grid's, bitwise, and with its absmax left unreduced
   over sp (a planted fault) not.
18. `rehearsal`, the trained-model tools: (a) `train_rehearsal.main` at
   full width (`Config()`, the JAX tool's overrides, its 48 / 8 / 8 scenes
   of the mixture, batch 16 as 8 micro-batches of 2 with the backbone
   recomputed in the backward) for REHEARSAL_EPOCHS epoch with a
   validation at its end (`trainer.check_val_every_n_epoch=1`, the one
   override): seconds a step (fenced), steps/s, peak GiB (its own: the
   card's peak less what earlier phases still hold), the attention,
   row-gather and LSAP launches around the fit; its three gates read and
   printed (the loss and mAP@50 gates need hundreds of epochs: printed, not
   gated), the bitwise restore gated, and a restore with one leaf moved by
   one ulp (a planted fault) must fail it. (b) A written dataset of
   DATASCALE_SIZES scenes -> `train_datascale.main` for one epoch (one
   step of 16 micro-batches of one scene) -> `recert_int8.main` on its
   `last-epoch.ckpt`: fp32, bf16 and `int8` through `cli test`, finite
   metrics, the int8 convs counted in the int8 variant, the RECERT lines
   printed (an untrained model's mAPs are ~0: its pass certifies
   nothing).

`python3 chip_smoke.py --trained <checkpoint>` runs, in place of the
phases above, the gates of phases 4 and 5 at full width on trained
weights (a port checkpoint of `Config()`, as the rehearsal writes):
`gather` and `gather_pallas` against dense, `bf16` against fp32 and `int8`
against `bf16`, on phase 3's 8 scenes, printed beside their limits (one
table, PATH_GATES, holds both). Beside them, two witnesses: each level of
the gather paths' sparse batch against the dense one's, bitwise, and the
dense forward with noise of NOISE_SIGMAS planted in the backbone's
outputs; for each run, the cross-attention masks' flips, query positions
and first-round keys against the dense forward's, call by call.

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
# `--trained`'s witness: noise planted in the dense backbone's outputs, the
# size of fp32 `gather`'s mean and max map differences on trained weights
NOISE_SIGMAS = (2e-6, 4e-5)
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
TRAIN_STEPS = 5
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
PHASE_ROUNDS = 7  # the timer and a fenced forward, in turn
# the rehearsal phase: epochs of the rehearsal at full width (3 steps of
# batch 16 an epoch, a validation of 8 scenes at its end); the written
# data-scale dataset (train, validation, test scenes, seed): 16 train
# scenes make one step of 16 micro-batches of one scene
REHEARSAL_EPOCHS = 1
DATASCALE_SIZES = (16, 2, 2, 0)
# the roomformer phase: (a) the JAX tests' tiny configuration
# (tests/test_roomformer.py:157-166), card against CPU (f32 sums in another
# order): outputs within RF_FWD_TOL, the train step's loss within
# RF_LOSS_TOL relative and each gradient leaf within RF_GRAD_TOL * max(1,
# max |leaf|); (b) the deformable sampler's gather form against its
# grid_sample form at RoomFormer()'s shapes (8 maps, 8 heads of 32, 4
# levels of 64^2..8^2, 4 points; 5,440 encoder and 800 decoder queries);
# (c)-(e) RoomFormer() at batch 8 on 256x256 density maps of written
# Structured3D-layout scenes, the engine trained for RF_EPOCHS epochs
RF_TINY = dict(d_model=32, n_heads=4, n_levels=4, n_points=2, enc_layers=1,
               dec_layers=2, num_polys=3, num_queries=12,
               backbone_channels=(8, 16, 32))
RF_FWD_TOL = 1e-4
RF_LOSS_TOL = 1e-5
RF_GRAD_TOL = 1e-3
RF_SAMPLER_TOL = 1e-5
RF_LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))
RF_BATCH = 8
RF_FORWARD_REPS = 10
RF_OVERFIT_STEPS = 20
RF_SCENES = {"train": (0, 8), "validation": (3000, 2), "test": (3250, 8)}
RF_EPOCHS = 2
# the preprocess phase: raw Structured3D-layout scenes of 3x2 rooms of 4.8 x
# 3.8 m with 200 mm walls and a door (`synthetic.panorama_rooms`), one
# 1024x512 uint16 depth panorama a room, rendered, labelled, downsampled
# at experiment 1's voxel sizes and read by `cli test` at each: 4 test
# scenes (one batch) and one train and one validation scene, converted in
# a spawn pool of PREP_WORKERS; the row of the planted filter-byte fault
PREP_SCENES = {"train": (0, 1), "validation": (3000, 1), "test": (3250, 2)}
PREP_PANO = (512, 1024)
PREP_VOXEL_SIZES = (100, 150, 200)
PREP_WORKERS = 6
PREP_FAULT_ROW = 7
# the parallel phase: ranks on the one card; the dp step with whole levels
# as memories against one process's 2 x 4 accumulation (the same conv shapes
# a micro-batch), every leaf within PAR_LEAF_TOL x max(1, max |leaf|); the
# dp and sp steps with sampled memories against the one-process batch-8
# step, every leaf within PAR_STEP_TOL by `leaf_errors` (cuDNN's batch-4 and
# slab convs round otherwise than its batch-8 ones, and the decoder's mask
# thresholds amplify that: the first card run read 1.00e-2 and 1.05e-2
# there, the planted faults ~1.0); the one-rank NCCL step against the
# no-group step where not bitwise; JAX's sharded-forward bounds
# (tests/test_parallel_sp.py:112-113, as (rtol, atol)); the batch of fit()
PAR_RANKS = 2
PAR_LEAF_TOL = 1e-4
PAR_STEP_TOL = 5e-2
PAR_BITWISE_TOL = 1e-6
PAR_SP_BOUNDS = {"pred_class": (5e-2, 5e-2), "pred_masks": (5e-2, 2e-1)}
PAR_FIT_BATCH = 4
# the sp=2 train steps off `dense` (the backbone whole on each rank): the
# impl -> its overrides (`par_impl_overrides`), on the first
# PAR_IMPL_SCENES of phase 3's scenes (batch 2, not 8: two ranks on one
# card each run the whole backbone, and the phase must keep the script
# under its time limit); `bricked` as micro-batches of one scene in
# PAR_BRICKS bricks (they divide the two scenes' 112x72x40 grid), one slot
# for every brick of the grid
PAR_IMPL_SCENES = 2
PAR_BRICKS = (8, 8, 8)
PAR_IMPL_STEPS = {
    "gather_pallas": ["model.backbone_impl=gather_pallas"],
    "bricked": ["model.backbone_impl=bricked",
                "model.brick_dims=[{},{},{}]".format(*PAR_BRICKS),
                f"trainer.grad_accum_steps={PAR_IMPL_SCENES}"],
}
# the decoder's and the criterion's row collectives of an sp step
# (`comm.BYTES` names): the forward reduce-scatter, its backward
# all-gather, the attention's partial softmax states, the replicated
# queries' and mask embeddings' gradients summed at their entry, the
# criterion's sums over points, the min/max and un-blocking reductions
PAR_ROW_BYTES = ("rows", "rows_grad", "attention_partials", "entry_grad",
                 "criterion_costs", "criterion_losses", "minmax", "unblock")
# the model_zoo phase: the bottleneck Res16UNet101 at full width (every
# map 1024 wide) on phase 3's scenes, its three paths and what each counted
# forward launches (the gather_pallas one: the k=5 stem and the 3^3 conv of
# each of the 40 bottleneck blocks), the timed forwards after the counted
# one; the decoder options at `Config()`'s width on Res16UNet34C; the
# options of the `cli test` run
ZOO_BACKBONE = "Res16UNet101"
ZOO_PATHS = {"dense": [], "bf16": ["model.compute_dtype=bfloat16"],
             "gather_pallas": ["model.backbone_impl=gather_pallas"]}
ZOO_LAUNCHES = {
    "dense": dict(masked_attention=12, row_gather=13, sparse_conv=0),
    "bf16": dict(masked_attention=12, row_gather=13, sparse_conv=0),
    "gather_pallas": dict(masked_attention=12, row_gather=0, sparse_conv=41)}
ZOO_REPS = 2
ZOO_COMBOS = {
    "learned_level_embed_pre_norm_unshared": [
        "model.non_parametric_queries=false", "model.use_level_embed=true",
        "model.pre_norm=true", "model.shared_decoder=false"],
    "np_features": ["model.use_np_features=true"],
    "random_queries": ["model.non_parametric_queries=false",
                       "model.random_queries=true"],
    "random_query_both_normal": ["model.non_parametric_queries=false",
                                 "model.random_query_both=true",
                                 "model.random_normal=true"]}
ZOO_CLI = ["model.backbone=Res16UNet50", "model.non_parametric_queries=false",
           "model.shared_decoder=false"]


# phase 17 (config_matrix): Res16UNet101 at full width in the int8 stacks
MATRIX_BACKBONE = "Res16UNet101"
MATRIX_PATHS = ("int8", "int8_chain")  # profile_forward.CONFIGS
MATRIX_REPS = 2
# (a) a shallow bottleneck whose planes reach 96-128, card vs CPU in int8:
# name -> (base, class attributes)
MATRIX_SMALL = ("Res16UNet50_int8_small", ("Res16UNet50", dict(
    PLANES=(32, 64, 96, 128, 128, 96, 96, 96),
    LAYERS=(1, 1, 1, 1, 1, 1, 1, 2))))
# (b) a shallow bottleneck with the gate at Res16UNet50's widths
MATRIX_BACKBONES = {"Res16UNet50_shallow_se": ("Res16UNet50", dict(
    LAYERS=(1,) * 8, SE=True))}
# (b) the sp=2 forwards: name -> (profile_forward.CONFIGS key, overrides,
# scenes of phase 3): Config() where MATRIX_SP_BACKBONE names no backbone;
# "dense" also runs once in train mode (its rows' bytes, and what an
# all-reduce of them whole would carry). Each is held to the one-process
# forward at its own precision within JAX's sharded bounds (`par_excess`)
MATRIX_SP = {
    "dense": ("fp32", [], 8),
    "gather_pallas": ("fp32", ["model.backbone_impl=gather_pallas"], 8),
    "bottleneck_se_fp32": ("fp32", [], 2),
    "bottleneck_se_bf16": ("bf16", [], 2),
    "bottleneck_se_int8": ("int8", [], 2),
}
MATRIX_SP_BACKBONE = {k: "Res16UNet50_shallow_se" for k in MATRIX_SP
                      if k.startswith("bottleneck_se")}
# (b) a planted fault on "bottleneck_se_fp32", "fault_slab_se_mean": the
# gate's mean over the rank's slab only, which must fall outside those
# bounds. (The int8 absmax left unreduced over sp is planted on a slab's
# conv instead: `int8` runs static scales, and a dynamic-scale forward
# leaves those bounds at sp=2 by itself, as on the CPU, where each
# rounding flip that moves an absmax moves a scale.)
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


# phases 4-5's gates (and `--trained`'s): each path, the run it is held
# against, and its tolerance on the mean |diff| (None: `gather`'s rule)
PATH_GATES = {"gather": ("fp32", None),
              "gather_pallas": ("fp32", BF16_PATH_MEAN),
              "bf16": ("fp32", BF16_STACK_MEAN),
              "int8": ("bf16", INT8_PATH_MEAN)}


def gate_ratio(path, stats):
    """A path's gate against the run PATH_GATES names; passes at <= 1.
    `gather`: max |diff| of the backbone maps and the 99.9% quantile of the
    outputs (summation order can flip a threshold of the decoder's
    attention masks and move a few output values) within FP32_PATH_TOL *
    max(1, std); the others: mean |diff| of both within their tolerance *
    max(1, std)."""
    tol = PATH_GATES[path][1]
    if tol is None:
        return max(
            st["q999" if what.startswith("pred") else "max"]
            / (FP32_PATH_TOL * max(1.0, st["ref_std"]))
            for what, st in stats.items())
    return worst_ratio(stats, "mean", tol)


def output_stats(np, ref, got, valid):
    """diff_stats of got's outputs and backbone maps against ref's (each a
    dict of "preds", (pred_class, pred_masks), and "maps"); pred_masks on
    the valid points only."""
    stats = {"pred_class": diff_stats(np, ref["preds"][0], got["preds"][0]),
             "pred_masks": diff_stats(np, ref["preds"][1][valid],
                                      got["preds"][1][valid])}
    for i, (r, g) in enumerate(zip(ref["maps"], got["maps"])):
        stats[f"map{i} (stride {16 >> i})"] = diff_stats(np, r, g)
    return stats


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



def write_entry_dataset(np, root, n_train=1, n_test=ENTRY_TEST_SCENES,
                        n_val=1):
    """Structured3D layout (`scene_NNNNN/point_cloud_rasterized_150.ply`,
    binary PLY with float32 x, y, z, so the coordinates round-trip exactly)
    of the flagship's scenes (`profile_forward.flagship_items`): the train
    scenes 0..., the validation scenes 3000... and the test scenes
    3250..."""
    from mask3d_tpu_torch.data.ply import write_ply
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(0)
    scenes = [f"scene_{i:05d}" for i in range(n_train)] + [
        f"scene_{3000 + i:05d}" for i in range(n_val)] + [
        f"scene_{3250 + i:05d}" for i in range(n_test)]
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


def counted(torch, counters, by_key, fn):
    """`fn()` with every count set to 0 just before it and read just
    after: (its result, launches, counts by key, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    for counts, _ in by_key.values():
        counts.clear()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    keyed = {k: dict(counts) for k, (counts, _) in by_key.items()}
    return out, launches, keyed, torch.cuda.max_memory_allocated() / 2**30


def count_forward(torch, mt, counters, by_key, mdl, dev, cfg):
    """One counted `infer` (`counted`): (output, launches, counts by key,
    peak GiB). Raises where a pyramid level or the level-0 bricks
    overflowed."""
    (out, overflow), launches, keyed, peak = counted(
        torch, counters, by_key, lambda: mt.infer(mdl, dev, cfg,
                                                  device="cuda"))
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
        want = dict(HALL_LAUNCHES[impl], masked_attention=12, int8_conv=0,
                    lsap=0)
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


def cli_test_recorded(torch, counters, args):
    """`cli.main(["test", *args])` in process, every count set to 0 just
    before it and read just after, with recording hooks: the trainer, its
    first eval batch, model, cfg and outputs, the metrics, and each
    collation's seconds. Returns dict(rc, secs, launches, peak, seen,
    collate_s)."""
    from mask3d_tpu_torch import cli
    from mask3d_tpu_torch.data import collate as collate_mod
    from mask3d_tpu_torch.train import trainer as trainer_mod

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

    trainer_mod.make_eval_step = recording_make
    cls.test = recording_test
    collate_mod.VoxelizeCollate.__call__ = timed_collate
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["test", *args])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        trainer_mod.make_eval_step = real["make"]
        cls.test = real["test"]
        collate_mod.VoxelizeCollate.__call__ = real["collate"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    return dict(rc=rc, secs=secs, launches=launches, peak=peak, seen=seen,
                collate_s=collate_s)


def entry_batch_seconds(torch, mt, run, collate_note):
    """Seconds a batch of a `cli_test_recorded` run: collation, forward +
    criterion, post-process and evaluator (means over its batches), and
    the forward alone (`infer(aux_masks=True)` on its first batch, once)
    and the criterion alone (median of 3) beside them. Returns
    (seconds by segment, the forward's output, meter statistics)."""
    from mask3d_tpu_torch.utils import meter

    seen = run["seen"]
    batch, cfg = seen["batch"], seen["cfg"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, _ = mt.infer(seen["model"], batch, cfg, aux_masks=True,
                      device="cuda")
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t
    targets = batch.target.with_label_offset(cfg.data.prediction_label_offset)
    point_valid = torch.arange(batch.capacity, device="cuda")[None] \
        < batch.counts[:, None]
    criterion_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            seen["trainer"].criterion(out, targets, point_valid)
        torch.cuda.synchronize()
        criterion_s.append(time.perf_counter() - t)
    stats = meter.get_statistics()
    per_batch = {
        f"collation ({collate_note})": statistics.mean(run["collate_s"]),
        "forward + criterion": stats["model_forward_complete"]["mean"],
        "forward alone (batch 1, once)": forward_s,
        "criterion alone (batch 1, median of 3)":
            statistics.median(criterion_s),
        "post-process": stats["eval_postprocess"]["mean"],
        "evaluator": stats["eval_metrics_calc"]["mean"]}
    return per_batch, out, stats


def run_test_entry(torch, np, mt, counters, card):
    """`python -m mask3d_tpu_torch.cli test` in process, at the flagship's
    full width (`Config()` defaults, fp32 dense, random weights from the
    seed) on a written dataset; returns the kernels' launches in it."""
    import tempfile

    from mask3d_tpu_torch.data import collate as collate_mod

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        t = time.perf_counter()
        scenes = write_entry_dataset(np, root)
        log(f"test entry: wrote {len(scenes)} scenes in "
            f"{time.perf_counter() - t:.2f} s")
        run = cli_test_recorded(torch, counters, [
            "--device", "cuda", f"data.data_root={root}",
            f"data.test_batch_size={ENTRY_BATCH}",
            f"general.save_dir={tmp}/saved"])
        rc, secs, launches, peak = (run[k] for k in ("rc", "secs",
                                                     "launches", "peak"))
        seen = run["seen"]
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
    want = entry_metric_keys("test")
    log(f"test entry metrics: {json.dumps(metrics, sort_keys=True)}")
    assert set(metrics) == want, sorted(set(metrics) ^ want)
    finite = [k for k in metrics if "loss" in k or "mean_ap" in k]
    assert all(np.isfinite(metrics[k]) for k in finite), metrics
    assert metrics["test_batch_overflow"] == 0.0, metrics
    assert launches["masked_attention"] == n_batches * 12 and \
        launches["row_gather"] == n_batches * 13 and \
        launches["lsap"] == n_batches, launches

    # the entry's forward on its first batch against `infer` on that
    # batch; the criterion alone on batch 1's outputs (its LSAP round trip
    # included), beside the forward alone
    per_batch, out, stats = entry_batch_seconds(
        torch, mt, run, "native, 16 threads")
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
    log("test entry seconds per batch (mean over "
        f"{n_batches} test batches; collation over all "
        f"{len(run['collate_s'])} calls): "
        f"{json.dumps(per_batch)}; meter {json.dumps(stats)} on {card}")
    return launches


def entry_metric_keys(prefix):
    """The keys of the JAX package's `test()` (trainer.py:430-437): 3 x 13
    losses + "loss", batch_overflow and the evaluator's keys but
    `classes`, each under `prefix`."""
    n_levels = 3 * 4 + 1  # num_decoders x hlevels + the final output
    losses = ["loss_ce", "loss_mask", "loss_dice"] + [
        f"loss_{w}_mask_module_{i}" for i in range(n_levels - 1)
        for w in ("ce", "mask", "dice")] + ["loss"]
    return {f"{prefix}_{k}" for k in losses + ["batch_overflow"]} | {
        f"{prefix}_{k}" for k in ENTRY_EVAL_KEYS}


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
                plain=False, seed=0, prepare=None):
    """`n_steps` train steps of a fresh flagship state (weights and
    generator from `seed`, then `prepare(state)` where given) on `batch`,
    with the counts set to 0 just before and read just after; returns
    (losses, launches, attention launches by S, state, peak GiB above what
    was allocated before the state was made, seconds a step)."""
    import contextlib

    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, seed=seed, device="cuda")
    if prepare is not None:
        prepare(state)
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
                launches["row_gather"] == 13 and launches["lsap"] == 1, \
                launches
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
        launches["masked_attention"] == 2 * n_dec and \
        launches["lsap"] == 2, launches
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
        assert launches["lsap"] == forwards, launches  # one a criterion
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
            "sparse_conv": 0, "int8_conv": 0, "lsap": 8}
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
                       f"train_large hall {impl} bf16 "
                       f"({int(hall.counts[0])} voxels)", oom_retry=True)
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
    `trainer.measure_model_phases=true`: every `model_forward_*` segment;
    the median of their sum over PHASE_ROUNDS rounds against the median of
    fenced forwards of the same batch run in turn with them, and each
    segment above twice the tolerance, left out of the sum, must fail."""
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
    seg_runs, fenced_s = [], []

    def interleaved(cfg, model, batch, reps=3, device="cuda"):
        """The phase timer and fenced forwards of the same batch in turn:
        PHASE_ROUNDS rounds of one timed forward of each (the timer's own
        warm-up forward first in each round; the fenced forward is the
        eval step's, `aux_masks`), so that both read the card in the same
        states (on the H100, readings minutes apart differed by 20%)."""
        from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
        from mask3d_tpu_torch.sparse.context import build_sparse_batch

        dev = batch.to(device)
        segs = None
        for _ in range(PHASE_ROUNDS):
            segs = real_measure(cfg, model, batch, 1, device)
            seg_runs.append(segs)
            with torch.inference_mode():
                sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                                        level_capacities(cfg, dev.capacity),
                                        dev.grid_dims, **_sb_kwargs(cfg))
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

            # (e) measure_model_phases through cli test (fp32 dense),
            # interleaved with fenced forwards of the same batch
            trainer_mod.measure_model_phases = interleaved
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
        phases = {k: statistics.median(r[k] for r in seg_runs)
                  for k in (seg_runs[0] if seg_runs else {})}
        ok, total, fenced = phase_sum_gate(seg_runs, fenced_s)
        out["phases"] = dict(segments=phases, sum_s=total, fenced_s=fenced,
                             rounds=len(seg_runs),
                             sums_s=[sum(r.values()) for r in seg_runs],
                             fenced_runs_s=list(fenced_s),
                             sparse_context_build_s=stats.get(
                                 "sparse_context_build", {}).get("mean"))
        for name, sec in phases.items():
            log(f"  {name}: {sec * 1e3:.3f} ms (median of {len(seg_runs)})")
        log(f"measure_model_phases (cli test, fp32 dense, batch 2), "
            f"{len(seg_runs)} rounds of the timer and a fenced forward in "
            f"turn: median model_forward_* sum {total * 1e3:.3f} ms vs median "
            f"fenced forward {fenced * 1e3:.3f} ms (tol {PHASE_SUM_TOL:.0%}); "
            f"sums {[round(x * 1e3, 3) for x in out['phases']['sums_s']]} ms,"
            f" fenced {[round(x * 1e3, 3) for x in fenced_s]} ms; "
            f"sparse_context_build "
            f"{out['phases']['sparse_context_build_s'] * 1e3:.3f} ms")
        # planted fault: a segment left out of the sum must fail the gate,
        # for each segment longer than twice the tolerance
        caught = {}
        for name, sec in phases.items():
            if sec > 2 * PHASE_SUM_TOL * fenced:
                caught[name] = not phase_sum_gate(seg_runs, fenced_s,
                                                  drop=name)[0]
        out["phases"]["fault_segment_left_out_fails"] = caught
        log(f"planted fault 'a segment left out of the sum' (each segment "
            f"above {2 * PHASE_SUM_TOL:.0%} of the forward): fails the gate "
            f"{caught}")
        if not (rc == 0 and len(phases) == 4 + 3 + 1
                and len(seg_runs) == PHASE_ROUNDS
                and all(v >= 0 for v in phases.values()) and ok
                and caught and all(caught.values())):
            failed.append(("measure_model_phases", rc, out["phases"]))
    return out


def phase_sum_gate(seg_runs, fenced_s, drop=None):
    """(ok, median sum, median fenced forward): the median over rounds of
    the `model_forward_*` segments' sum (without segment `drop`) within
    PHASE_SUM_TOL of the median fenced forward of the same rounds."""
    if not seg_runs or not fenced_s:
        return False, float("nan"), float("nan")
    total = statistics.median(
        sum(v for k, v in r.items() if k != drop) for r in seg_runs)
    fenced = statistics.median(fenced_s)
    return abs(total - fenced) <= PHASE_SUM_TOL * fenced, total, fenced


def rf_targets(torch, np, rng, b, pt, qp):
    """Padded polygon targets (`collate_floorplan`'s layout): item i holds
    i + 1 polygons of 3..qp random corners."""
    coords = np.zeros((b, pt, 2 * qp), np.float32)
    labels = np.zeros((b, pt, qp), np.float32)
    lengths = np.zeros((b, pt), np.int32)
    valid = np.zeros((b, pt), bool)
    for i in range(b):
        for j in range(min(i + 1, pt)):
            n = int(rng.integers(3, qp + 1))
            coords[i, j, :2 * n] = rng.uniform(0.05, 0.95, 2 * n)
            labels[i, j, :n] = 1.0
            lengths[i, j] = 2 * n
            valid[i, j] = True
    return {k: torch.from_numpy(v) for k, v in (
        ("coords", coords), ("labels", labels), ("lengths", lengths),
        ("poly_valid", valid))}


def rf_small_card_vs_cpu(torch, np):
    """(a) RF_TINY with seeded port weights (the zero-initialised kernels
    drawn too, so every sampling offset and coordinate head is live): the
    forward and one train step's loss and gradients, card against CPU."""
    import copy

    from mask3d_tpu_torch.baseline.criterion2d import RoomFormerCriterion
    from mask3d_tpu_torch.baseline.roomformer import RoomFormer

    gen = torch.Generator().manual_seed(0)
    cpu = RoomFormer(**RF_TINY, generator=gen)
    with torch.no_grad():
        for p in cpu.parameters():
            if not p.any():
                p.normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(0)
    density = torch.from_numpy(rng.random((2, 64, 64, 1)).astype(np.float32))
    targets = rf_targets(torch, np, rng, 2, RF_TINY["num_polys"],
                         RF_TINY["num_queries"] // RF_TINY["num_polys"])
    crit = RoomFormerCriterion(raster_res=16)

    def step(model, dev):
        out = model(density.to(dev))
        losses = crit(out, {k: v.to(dev) for k, v in targets.items()})
        losses["loss"].backward()
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).detach().cpu().double()
                 for n, p in model.named_parameters()}
        return (out.aux_logits.detach().cpu().double(),
                out.aux_coords.detach().cpu().double(),
                float(losses["loss"]), grads)

    gpu = copy.deepcopy(cpu).cuda()
    with torch.backends.mkldnn.flags(enabled=False):
        ref = step(cpu, "cpu")
    got = step(gpu, "cuda")
    fwd = max(float((a - b).abs().max()) for a, b in zip(ref[:2], got[:2]))
    loss_rel = abs(got[2] - ref[2]) / abs(ref[2])
    leaf = {n: float((got[3][n] - g).abs().max())
            / max(1.0, float(g.abs().max())) for n, g in ref[3].items()}
    worst = max(leaf, key=leaf.get)
    res = dict(forward_max_abs_diff=fwd, loss_cpu=ref[2], loss_card=got[2],
               loss_rel_diff=loss_rel, worst_leaf=worst,
               worst_leaf_err=leaf[worst])
    log(f"roomformer (a) tiny card vs CPU: {res}")
    assert fwd <= RF_FWD_TOL and loss_rel <= RF_LOSS_TOL and \
        leaf[worst] <= RF_GRAD_TOL, res
    return res


def rf_sampler_check(torch, F):
    """(b) `ms_deform_attn_core`'s gather form against the `F.grid_sample`
    form at full width, encoder and decoder queries, each timed; with x
    and y swapped in the sampler the check must fail."""
    from mask3d_tpu_torch.baseline import deform_attn as da

    rows = []
    total = sum(h * w for h, w in RF_LEVELS)
    for name, q in (("encoder", total), ("decoder", 800)):
        g = torch.Generator(device="cuda").manual_seed(q)
        b, nh, hd, nl, npt = RF_BATCH, 8, 32, len(RF_LEVELS), 4
        value = torch.randn(b, total, nh, hd, device="cuda", generator=g)
        loc = torch.rand(b, q, nh, nl, npt, 2, device="cuda",
                         generator=g) * 1.2 - 0.1
        w = torch.softmax(torch.randn(b, q, nh, nl * npt, device="cuda",
                                      generator=g), -1).reshape(
            b, q, nh, nl, npt)
        args = (value, list(RF_LEVELS), loc, w)
        with torch.no_grad():
            ref = da.ms_deform_attn_grid_sample(*args)
            err = float((da.ms_deform_attn_core(*args) - ref).abs().max())
            real = da.bilinear_sample
            da.bilinear_sample = lambda v, xy: real(v, xy.flip(-1))
            try:
                fault = float((da.ms_deform_attn_core(*args)
                               - ref).abs().max())
            finally:
                da.bilinear_sample = real
            ms = time_ms(torch, lambda: da.ms_deform_attn_core(*args))
            grid_ms = time_ms(torch,
                              lambda: da.ms_deform_attn_grid_sample(*args))
        row = dict(queries=q, max_abs_err=err, swapped_xy_err=fault,
                   gather_ms=ms, grid_sample_ms=grid_ms,
                   ok=err <= RF_SAMPLER_TOL < fault)
        log(f"roomformer (b) sampler {name}: {row}")
        rows.append(row)
    assert all(r["ok"] for r in rows), rows
    return rows


def rf_write_scenes(np, root):
    """Structured3D-layout scenes of `write_floorplan_scene` (3x2 rooms of
    24 voxels) for each split of RF_SCENES."""
    import shutil

    from mask3d_tpu_torch.data.synthetic import write_floorplan_scene

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    for first, n in RF_SCENES.values():
        for i in range(n):
            write_floorplan_scene(root, f"scene_{first + i:05d}", rng)


def rf_phase_marks(torch, model):
    """CUDA events at the model's phase boundaries: (hooks, events)."""
    ev = {}

    def mark(name):
        def hook(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev[name] = e
        return hook

    hooks = [model.register_forward_pre_hook(mark("start")),
             model.backbone.register_forward_hook(mark("backbone")),
             model.encoder[0].register_forward_pre_hook(mark("enc_start")),
             model.encoder[-1].register_forward_hook(mark("encoder")),
             model.decoder[0].register_forward_pre_hook(mark("dec_start")),
             model.register_forward_hook(mark("end"))]
    return hooks, ev


def rf_forward(torch, batch, card):
    """(c) RoomFormer() eval forward on 8 density maps: the median of
    RF_FORWARD_REPS fenced forwards, ms by phase (CUDA events), peak GiB
    (and above what the earlier phases left allocated)."""
    from mask3d_tpu_torch.baseline.roomformer import RoomFormer

    model = RoomFormer(generator=torch.Generator().manual_seed(0)).cuda()
    density = torch.from_numpy(batch["density"]).cuda()
    with torch.no_grad():
        for _ in range(2):
            out = model(density)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(RF_FORWARD_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = model(density)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        hooks, ev = rf_phase_marks(torch, model)
        model(density)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
    assert tuple(out.aux_logits.shape) == (6, RF_BATCH, 20, 40)
    assert bool(torch.isfinite(out.aux_coords).all())
    res = dict(
        ms_median=statistics.median(times), ms_all=times,
        peak_gib=peak / 2**30, peak_gib_above_start=(peak - base) / 2**30,
        backbone_ms=ev["start"].elapsed_time(ev["backbone"]),
        input_proj_ms=ev["backbone"].elapsed_time(ev["enc_start"]),
        encoder_ms=ev["enc_start"].elapsed_time(ev["encoder"]),
        decoder_ms=ev["dec_start"].elapsed_time(ev["end"]))
    log(f"roomformer (c) forward, batch {RF_BATCH} ({card}): {res}")
    return res


def rf_train(torch, np, items, batch, save_dir, card):
    """(d) RoomFormer() train steps through the engine (criterion with
    loss_raster at 64^2, AdamW, deterministic algorithms): seconds a step,
    peak GiB, two steps twice from one seed bitwise equal, and
    RF_OVERFIT_STEPS steps on one batch lowering the loss."""
    from mask3d_tpu_torch.baseline.engine import FloorplanTrainer

    def trainer():
        return FloorplanTrainer(
            "unused", save_dir=save_dir, batch_size=RF_BATCH, seed=1,
            datasets={"train": items, "validation": items, "test": items})

    runs, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        tr = trainer()
        losses = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(tr.train_step(batch)["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        runs.append((losses, [p.detach().clone() for p in
                              tr.model.parameters()]))
    peak = torch.cuda.max_memory_allocated()
    bitwise = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    losses = runs[1][0]
    for _ in range(RF_OVERFIT_STEPS - 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(tr.train_step(batch)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    res = dict(s_per_step_median=statistics.median(secs),
               s_first_step=secs[0], peak_gib=peak / 2**30,
               peak_gib_above_start=(peak - base) / 2**30,
               losses_first_run=runs[0][0], bitwise_repeat=bitwise,
               loss_first=losses[0], loss_last=losses[-1],
               finite=bool(np.isfinite(losses).all()))
    log(f"roomformer (d) train step, batch {RF_BATCH} ({card}): {res}")
    assert res["finite"] and bitwise and losses[-1] < losses[0], res
    return res


def rf_engine(torch, np, root, save_dir, card):
    """(e) `engine train` for RF_EPOCHS epochs at batch 8, then `engine
    eval --checkpoint last-epoch.ckpt --mask3d_bridge --export_las`: the
    metric keys, one .las per test scene, seconds a batch of data, forward
    and post-processing."""
    from mask3d_tpu_torch.baseline import engine

    t = time.perf_counter()
    tr, _ = engine.main(["train", "--data_root", root, "--save_dir",
                         save_dir, "--batch_size", str(RF_BATCH),
                         "--max_epochs", str(RF_EPOCHS)])
    train_s = time.perf_counter() - t
    assert tr.epoch == RF_EPOCHS - 1 and tr.state.step == RF_EPOCHS
    las = os.path.join(save_dir, "las")
    t = time.perf_counter()
    ev, metrics = engine.main([
        "eval", "--data_root", root, "--save_dir", save_dir,
        "--checkpoint", os.path.join(save_dir, "last-epoch.ckpt"),
        "--mask3d_bridge", "--export_las", "--las_dir", las])
    eval_s = time.perf_counter() - t
    keys = {p: sorted(k for k in metrics if k.startswith(p))
            for p in ("room_", "corner_", "angle_", "bridge_")}
    n_las = len([f for f in os.listdir(las) if f.endswith(".las")])
    res = dict(train_s=train_s, eval_s=eval_s, las_files=n_las,
               metrics=metrics,
               s_per_batch={k: statistics.mean(v)
                            for k, v in ev.timings.items()})
    log(f"roomformer (e) engine ({card}): {res}")
    assert all(keys.values()), keys
    assert n_las == RF_SCENES["test"][1], n_las
    assert all(np.isfinite(v) for k, v in metrics.items()
               if not k.startswith("bridge_")), metrics
    return res


def run_roomformer(torch, F, np, card):
    """Phase `roomformer`: (a)-(e) above; the summary for the JSON line."""
    import shutil

    from mask3d_tpu_torch.baseline.density_dataset import (
        FloorplanDataset, collate_floorplan)

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    root = os.path.join(build, "roomformer_scenes")
    save_dir = os.path.join(build, "roomformer_saved")
    shutil.rmtree(save_dir, ignore_errors=True)
    out = {"small": rf_small_card_vs_cpu(torch, np),
           "sampler": rf_sampler_check(torch, F)}
    rf_write_scenes(np, root)
    ds = FloorplanDataset(root, "train")
    items = [ds[i] for i in range(len(ds))]
    batch = collate_floorplan(items, 20)
    out["forward"] = rf_forward(torch, batch, card)
    out["train"] = rf_train(torch, np, items, batch, save_dir, card)
    shutil.rmtree(save_dir, ignore_errors=True)
    out["engine"] = rf_engine(torch, np, root, save_dir, card)
    return out


def host_ms(fn, reps):
    """Median host ms of `reps` calls of `fn` (host work: the encoders)."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def fenced_ms(torch, fn, reps):
    """Median wall ms of `reps` calls of `fn`, each fenced by
    `torch.cuda.synchronize()` (the copy, the decode, the builds)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def same_levels(torch, a, b):
    """The names of the fields where two sparse batches' levels, occupancy
    grids or overflow flags differ (empty: bit for bit equal)."""
    bad = []
    for li, (la, lb) in enumerate(zip(a.levels, b.levels)):
        bad += [f"level {li} {f}" for f in ("key", "coords", "valid",
                                            "count", "dims")
                if not torch.equal(getattr(la, f), getattr(lb, f))]
    bad += [f"occ {li}" for li, (x, y) in enumerate(zip(a.occ, b.occ))
            if not torch.equal(x, y)]
    bad += [f"overflow {li}" for li, (x, y) in enumerate(zip(a.pools,
                                                            b.pools))
            if not torch.equal(x.overflow, y.overflow)]
    return bad


def decode_gate(torch, dev, u8, caps):
    """The card's decode of a bench buffer against the collated batch:
    keys (on each item's rows), counts and dims, and the sparse batch
    built from the decoded precomputed levels against the device build,
    bit for bit. Returns the names of what differs."""
    from mask3d_tpu_torch.data import transfer
    from mask3d_tpu_torch.sparse.context import build_sparse_batch
    from mask3d_tpu_torch.sparse.core import pack_keys

    b, n = dev.coords.shape[:2]
    (keys, counts, dims), coarse = transfer.decode_pyramid_u8(u8, b, n, caps)
    rows = torch.arange(n, device="cuda")[None] < dev.counts[:, None]
    want = pack_keys(dev.coords, dev.dims[:, None, :]).to(torch.int32)
    bad = [] if torch.equal(torch.where(rows, keys, 0),
                            torch.where(rows, want, 0)) else ["base keys"]
    bad += [] if torch.equal(counts, dev.counts.to(torch.int32)) \
        else ["counts"]
    bad += [] if torch.equal(dims, dev.dims.to(torch.int32)) else ["dims"]
    args = (dev.coords, dev.counts, dev.dims, caps, dev.grid_dims)
    return bad + same_levels(torch, build_sparse_batch(*args),
                             build_sparse_batch(*args,
                                                precomputed_levels=coarse))


def run_bench_input(torch, np, mt, cfg_mod, counters, by_key, host, card):
    """Phase `bench_input`: the JAX bench's input path on phase 3's 8
    flagship scenes at bucket 49152 (see the module docstring)."""
    from mask3d_tpu_torch.data import transfer
    from mask3d_tpu_torch.infer import encode_batch, infer_u8, \
        level_capacities
    from mask3d_tpu_torch.profile_forward import CONFIGS
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    dev = host.device
    b, n = dev.coords.shape[:2]
    base = [f"data.point_bucket_multiple={BUCKET}", "model.unit_features=true"]
    cfg = cfg_mod.apply_overrides(cfg_mod.Config(), list(base))
    caps = level_capacities(cfg, n)
    out = {}

    buf, n_cap = encode_batch(dev, cfg)
    buf_np, _ = encode_batch(dev, cfg, use_native=False)
    assert n_cap == n and np.array_equal(buf, buf_np), \
        "C++ and numpy buffers differ"
    out["buffer_bytes"] = int(buf.nbytes)
    out["coords_bytes"] = int(b * n * 3 * 4)
    out["encode_ms_cpp"] = host_ms(lambda: encode_batch(dev, cfg), 5)
    out["encode_ms_numpy"] = host_ms(
        lambda: encode_batch(dev, cfg, use_native=False), 2)
    out["pinned_copy_ms"] = fenced_ms(
        torch, lambda: transfer.to_device(buf, "cuda"), 5)
    u8 = transfer.to_device(buf, "cuda")
    out["decode_ms"] = fenced_ms(
        torch, lambda: transfer.decode_pyramid_u8(u8, b, n, caps), 5)
    bad = decode_gate(torch, dev, u8, caps)
    assert not bad, f"decode differs: {bad}"
    _, coarse = transfer.decode_pyramid_u8(u8, b, n, caps)
    args = (dev.coords, dev.counts, dev.dims, caps, dev.grid_dims)
    out["build_ms_precomputed"] = fenced_ms(
        torch, lambda: build_sparse_batch(*args, precomputed_levels=coarse),
        5)
    out["build_ms_device"] = fenced_ms(
        torch, lambda: build_sparse_batch(*args), 5)

    # the planted fault: the base level's last escape record dropped
    rec = buf[b * n: b * n + 4096 * 12].view(np.int32).reshape(-1, 3)
    real = np.nonzero(rec[:, 1] < n)[0]
    faulty = buf.copy()
    faulty[b * n: b * n + 4096 * 12].view(np.int32).reshape(-1, 3)[
        real[-1], 1] = n
    fault = decode_gate(torch, dev, transfer.to_device(faulty, "cuda"), caps)
    out["escape_records"] = int(len(real))
    out["fault_fails"] = bool(fault)
    log(f"bench_input: buffer {out['buffer_bytes']} bytes against "
        f"{out['coords_bytes']} bytes of i32 coordinates "
        f"({out['escape_records']} base escape records); host encode "
        f"{out['encode_ms_cpp']:.3f} ms C++, {out['encode_ms_numpy']:.3f} ms "
        f"numpy (byte-identical); pinned copy {out['pinned_copy_ms']:.3f} "
        f"ms; decode {out['decode_ms']:.3f} ms (bit-equal to the collated "
        f"batch and the device build); build precomputed "
        f"{out['build_ms_precomputed']:.3f} ms vs device "
        f"{out['build_ms_device']:.3f} ms; a dropped escape record fails "
        f"the gate: {fault} on {card}")
    assert fault, "a dropped escape record passed the decode gate"

    out["forward"] = {}
    for name in ("fp32", "bf16"):
        c = cfg_mod.apply_overrides(cfg_mod.Config(), base + CONFIGS[name])
        mdl = mt.build_model(c, device="cuda", seed=0)
        with torch.inference_mode():
            ref, _ = mt.infer(mdl, dev, c, device="cuda")
            infer_u8(mdl, buf, c, b, n, dev.grid_dims)  # warm-up
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            for counts, _ in by_key.values():
                counts.clear()
            pc, pm = infer_u8(mdl, buf, c, b, n, dev.grid_dims)
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        dtypes = dict(by_key["gather_dtypes"][0])
        want = {"masked_attention": 12, "row_gather": 13, "sparse_conv": 0,
                "int8_conv": 0, "lsap": 0}
        assert launches == want, (name, launches)
        if name == "bf16":
            assert dtypes == GATHER_BY_DTYPE, dtypes
        row = {"launches": launches, "gather_dtypes": dtypes}
        for what, r, g in (("pred_class", ref.pred_class, pc),
                           ("pred_masks", ref.pred_masks, pm)):
            r, g = r.float(), g.float()
            err = float((g - r).abs().max()) / max(1.0, float(r.std()))
            row[what] = err
            if not torch.equal(r, g):
                log(f"bench_input {name}: {what} not bitwise equal to "
                    f"`infer` (max |diff|/max(1,std) {err:.3g}; the "
                    f"forward's cuDNN and reduction sums may take another "
                    f"order between calls)")
            assert err <= 1e-6, (name, what, err)
        row["infer_u8_ms"] = fenced_ms(
            torch, lambda: infer_u8(mdl, buf, c, b, n, dev.grid_dims), 3)
        row["infer_ms"] = fenced_ms(
            torch, lambda: mt.infer(mdl, dev, c, device="cuda"), 3)
        out["forward"][name] = row
        log(f"bench_input {name} (unit_features): infer_u8 vs infer "
            f"{row['pred_class']:.3g} / {row['pred_masks']:.3g} "
            f"(max|diff|/max(1,std), tol 1e-6), launches {launches}, row "
            f"gather by dtype {dtypes}; {row['infer_u8_ms']:.2f} ms vs "
            f"{row['infer_ms']:.2f} ms a forward (median of 3, fenced) on "
            f"{card}")
        del mdl
    return out


# the LSAP phase: a cost on which scipy and JAX's device solver pick
# different real columns (tests/test_torch_lsap.py TIED_COST, JAX's
# device assignment), and the tied fixtures of that test at 25 x 8
LSAP_TIED = ([[1, 0, 1, 1], [1, 2, 2, 1], [2, 2, 1, 1], [2, 1, 1, 2],
              [0, 0, 0, 0], [2, 0, 0, 1]], [1, 4, 3, 5, 0, 2])


def lsap_cases(np, n_inst):
    """(name, f32 cost) of the LSAP phase."""
    rng = np.random.default_rng(0)
    cases = [("13x8 of 25x%d (Mask3D, flagship)" % n_inst,
              rng.normal(size=(13, 8, 25, n_inst))),
             ("13x8 of 100x32 (Mask3D, 100 queries)",
              rng.normal(size=(13, 8, 100, 32))),
             ("6x8 of 20x20 (RoomFormer)", rng.normal(size=(6, 8, 20, 20))),
             ("tied fixture", np.array(LSAP_TIED[0])[None])]
    tied = rng.normal(size=(4, 3, 25, 8))
    for kind in ("small_integers", "constant_columns", "duplicated_rows",
                 "all_equal"):
        c = tied.copy()
        if kind == "small_integers":
            c = rng.integers(0, 3, size=c.shape)
        elif kind == "constant_columns":
            c[..., 4:] = 1e4
        elif kind == "duplicated_rows":
            c[..., 1::2, :] = c[..., 0:1, :]
        else:
            c[:] = 0.5
        cases.append((f"4x3 of 25x8 {kind}", c))
    return [(name, np.asarray(c, np.float32)) for name, c in cases]


def run_lsap(torch, np, lsap, host, card):
    """Phase `lsap`: the kernel against the plain JV on the card at the
    criteria's shapes and on the tied fixtures; timed beside the scipy
    round trip and its bound."""
    from mask3d_tpu_torch import cuda_build

    n_inst = int(host.device.target.valid.shape[-1])
    rows = []
    for name, cost in lsap_cases(np, n_inst):
        x = torch.from_numpy(cost).cuda()
        r, c = cost.shape[-2:]
        nn = max(r, c)
        a = lsap.linear_sum_assignment(x)
        b2 = lsap.linear_sum_assignment(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with cuda_build.plain_versions():
            p = lsap.linear_sum_assignment(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        steps = lsap.solve_square_plain.steps
        equal, repeat = torch.equal(a, p), torch.equal(a, b2)
        sq = lsap.pad_square(x)
        ms = time_graph_ms(torch, lambda: lsap.solve_square(sq))
        eager_ms = time_ms(torch, lambda: lsap.linear_sum_assignment(x))
        scipy_ms = fenced_ms(
            torch, lambda: lsap.linear_sum_assignment(x, "host"), 5)
        n_prob = sq.shape[0]
        # bytes: the square costs read once, col4row written once;
        # operations: 4 a column (3 adds, 1 compare) at each search step
        bound_ms, bound_by = bound(n_prob * nn * nn * 4 + n_prob * nn * 4,
                                   4 * nn * steps)
        row = dict(shape=name, problems=n_prob, n=nn, equal=equal,
                   repeat_bitwise=repeat, search_steps=steps,
                   max_abs_err=float((a - p).abs().max()), ms=ms,
                   eager_ms=eager_ms, plain_ms=plain_ms, scipy_ms=scipy_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        rows.append(row)
        log(f"lsap {name}: kernel == plain {equal}, second launch bitwise "
            f"{repeat}; {ms:.4f} ms (graph replay; eager call with the "
            f"padding {eager_ms:.4f}), plain JV {plain_ms:.1f} ms, scipy "
            f"round trip {scipy_ms:.3f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}, {steps} search steps) on {card}")
        assert equal and repeat, name
    got = lsap.linear_sum_assignment(
        torch.tensor(LSAP_TIED[0], dtype=torch.float32, device="cuda"))
    assert got.cpu().tolist() == LSAP_TIED[1], got
    return rows


def png_gate(np, png, path, depth):
    """A written depth PNG read by the C++ unfilter and by the numpy
    reference: (both equal to each other and to `depth`, detail, ms of
    each read)."""
    try:
        t = time.perf_counter()
        nat = png.read_png(path)
        t_nat = time.perf_counter() - t
        ref = png.read_png(path, use_native=False)
        t_ref = time.perf_counter() - t - t_nat
    except png.PNGError as e:
        return False, f"refused: {e}", {}
    same = np.array_equal(nat, ref)
    ok = same and nat.dtype == depth.dtype and np.array_equal(nat, depth)
    return ok, (f"C++ == numpy: {same}; == written: "
                f"{bool(np.array_equal(nat, depth))}"), dict(
                    native_ms=t_nat * 1e3, numpy_ms=t_ref * 1e3)


def plant_filter_fault(png, src, dst, row):
    """`src` rewritten to `dst` with row `row`'s filter type changed (the
    image stream recompressed, every CRC valid): a PNG that reads, to the
    wrong pixels."""
    import zlib

    with open(src, "rb") as f:
        data = f.read()
    chunks = list(png._chunks(data, src))
    ihdr = next(p for t, p in chunks if t == b"IHDR")
    stream = bytearray(zlib.decompress(b"".join(p for t, p in chunks
                                               if t == b"IDAT")))
    w, depth = int.from_bytes(ihdr[:4], "big"), ihdr[8]
    pos = row * (1 + w * depth // 8)
    stream[pos] = (stream[pos] + 1) % 5
    with open(dst, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(bytes(stream)))
                + png._chunk(b"IEND", b""))


def run_preprocess(torch, np, mt, counters, card):
    """Phase `preprocess`: the data-preparation path end to end, from raw
    Structured3D-layout scenes to `cli test` on the card at each of
    experiment 1's voxel sizes; returns its numbers."""
    import contextlib
    import io
    import tempfile

    from mask3d_tpu_torch import native
    from mask3d_tpu_torch.data import synthetic
    from mask3d_tpu_torch.data.ply import read_ply
    from mask3d_tpu_torch.preprocess import analyze, downsample, png, stru3d
    from mask3d_tpu_torch.preprocess.geometry import points_in_polygon
    from mask3d_tpu_torch.utils.kfold import kfold_splits

    out = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        # (a) raw scenes, rooms 0-300 mm larger from one to the next: one
        # panorama a room, each row's filter in turn
        scenes = [f"scene_{first + i:05d}"
                  for first, n in PREP_SCENES.values() for i in range(n)]
        rooms = {s: synthetic.panorama_rooms(3, 2, (4800 + 100 * (i % 4),
                                                    3800 + 100 * (i % 3)))
                 for i, s in enumerate(scenes)}
        t = time.perf_counter()
        depths = {s: synthetic.write_panorama_scene(root, s, rooms[s],
                                                    PREP_PANO)
                  for s in scenes}
        out["write_s"] = time.perf_counter() - t
        pano0 = os.path.join(root, scenes[-1], "2D_rendering", "0",
                             "panorama", "full", "depth.png")
        gates = [png_gate(np, png, os.path.join(
            root, s, "2D_rendering", str(r), "panorama", "full",
            "depth.png"), d) for s in scenes[-1:] for r, d in
            enumerate(depths[s])]
        faulty = os.path.join(tmp, "fault.png")
        plant_filter_fault(png, pano0, faulty, PREP_FAULT_ROW)
        fault = png_gate(np, png, faulty, depths[scenes[-1]][0])
        out["png_read_ms"] = {k: statistics.mean(g[2].get(k, float("nan"))
                                                 for g in gates)
                              for k in ("native_ms", "numpy_ms")}
        log(f"preprocess (a): wrote {len(scenes)} scenes x "
            f"{len(depths[scenes[0]])} panoramas of {PREP_PANO[1]}x"
            f"{PREP_PANO[0]} in {out['write_s']:.2f} s; PNG gate on "
            f"{scenes[-1]}'s {len(gates)} panoramas: "
            f"{[g[1] for g in gates]}, a read (mean ms, zlib included) "
            f"{json.dumps(out['png_read_ms'])}; planted fault (row "
            f"{PREP_FAULT_ROW}'s filter type changed): {fault[1]}")
        assert all(g[0] for g in gates), gates
        assert not fault[0], "the planted PNG fault passed the gate"
        out["png_fault_caught"] = True

        # (b) render: panoramas -> labelled clouds, in a spawn pool
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as report:
            results = stru3d.main(["--data_root", root, "--num_workers",
                                   str(PREP_WORKERS)])
        out["render_s"] = time.perf_counter() - t
        ok = [r for r in results if r["success"]]
        split = {k: statistics.mean(r["timings"][k] for r in ok)
                 for k in ("read", "unproject", "label", "unique")}
        out["render"] = dict(
            seconds=out["render_s"], workers=PREP_WORKERS,
            seconds_a_scene=statistics.mean(r["seconds"] for r in ok),
            points_a_scene=[r["points"] for r in ok],
            split_s=split)
        log(f"preprocess (b): stru3d.main over {len(scenes)} scenes in "
            f"{out['render_s']:.2f} s ({PREP_WORKERS} spawn workers); "
            f"{out['render']['seconds_a_scene']:.2f} s a scene in its "
            f"worker; points a scene {out['render']['points_a_scene']}; "
            f"a scene's seconds by part (mean) {json.dumps(split)}; report "
            f"{report.getvalue().strip().splitlines()[-1]!r}")
        assert len(ok) == len(scenes), [r.get("exception") for r in results]
        with open(os.path.join(root, "run_valid_scenes.txt")) as f:
            assert f.read().split() == sorted(scenes)
        for s in scenes[-2:]:
            v = read_ply(os.path.join(root, s, "point_cloud.ply"))
            xy = np.stack([v["x"], v["y"]], 1).astype(np.float64)
            for r, (x0, y0, x1, y1, sem) in enumerate(rooms[s][:-1]):
                inside = points_in_polygon(xy, np.array(
                    [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float))
                assert inside.sum() > 0 and \
                    (v["room_id"][inside] == r + 1).all() and \
                    (v["type"][inside]
                     == stru3d.SEMANTIC_TYPE_INT_MAP[sem]).all(), (s, r)

        # (c) downsample at each voxel size
        v = read_ply(os.path.join(root, scenes[-1], "point_cloud.ply"))
        coords = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
        out["downsample"] = {}
        for vs in PREP_VOXEL_SIZES:
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = downsample.main(["--data_root", root, "--voxel_size",
                                       str(vs), "--num_workers",
                                       str(PREP_WORKERS)])
            secs = time.perf_counter() - t
            assert all(r["success"] for r in res), res
            t = time.perf_counter()
            vox, keep = native.downsample_native(coords, vs)
            native_s = time.perf_counter() - t
            t = time.perf_counter()
            q = np.floor((coords - coords.min(0)) / vs).astype(np.int64)
            u, k = np.unique(q, axis=0, return_index=True)
            numpy_s = time.perf_counter() - t
            _, sparse = downsample.downsample_point_cloud(
                coords, np.asarray(v["type"]), np.asarray(v["room_id"]), vs)
            back = read_ply(os.path.join(
                root, scenes[-1], f"point_cloud_rasterized_{vs}.ply"))
            same_ply = all(back[key].dtype == val.dtype
                           and np.array_equal(back[key], val)
                           for key, val in sparse.items())
            out["downsample"][vs] = dict(
                seconds=secs, voxels=[r["voxels"] for r in res],
                grid=(q.max(0) + 1).tolist(), native_ms=native_s * 1e3,
                numpy_ms=numpy_s * 1e3)
            log(f"preprocess (c): {vs} mm: downsample.main in {secs:.2f} s;"
                f" voxels a scene {out['downsample'][vs]['voxels']}; "
                f"{scenes[-1]} grid {out['downsample'][vs]['grid']}; "
                f"downsample_native {native_s * 1e3:.1f} ms vs numpy "
                f"{numpy_s * 1e3:.1f} ms: vox equal "
                f"{np.array_equal(vox, u)}, keep equal "
                f"{np.array_equal(keep, k)}; PLY reads back equal: "
                f"{same_ply}")
            assert np.array_equal(vox, u) and np.array_equal(keep, k), vs
            assert same_ply, vs

        # (d) host tools
        with contextlib.redirect_stdout(io.StringIO()):
            agg = analyze.main(["--data_root", root])
        folds = kfold_splits(scenes, 3, seed=0)
        log(f"preprocess (d): analyze {json.dumps(agg)}; kfold(3) sizes "
            f"{[(len(a), len(b)) for a, b in folds]}")
        assert set(agg) == {"num_scenes", "rooms_min", "rooms_max",
                            "rooms_mean", "rooms_median",
                            "num_undefined_total", "num_other_total",
                            "min_other_area_m2"}, agg
        assert agg["num_scenes"] == len(scenes) and agg["rooms_min"] == 6 \
            and agg["rooms_max"] == 6, agg
        assert len(folds) == 3 and all(
            sorted(a + b) == sorted(scenes) for a, b in folds), folds

        # (e) cli test on the card at each voxel size, one test batch
        n_test = PREP_SCENES["test"][1]
        out["cli_test"] = {}
        for vs in PREP_VOXEL_SIZES:
            run = cli_test_recorded(torch, counters, [
                "--device", "cuda", f"data.data_root={root}",
                f"data.rasterization_factor={vs}",
                f"data.valid_scenes_file_path={root}/run_valid_scenes.txt",
                f"data.test_batch_size={n_test}",
                f"general.save_dir={tmp}/saved_{vs}"])
            assert run["rc"] == 0, run["rc"]
            seen = run["seen"]
            per_batch, fwd, _ = entry_batch_seconds(
                torch, mt, run, "native")
            batch = seen["batch"]
            n_points = int(batch.counts.sum())
            row = dict(
                voxels_a_scene=batch.counts.tolist(),
                bucket=int(batch.capacity), cli_s=run["secs"],
                seconds_a_batch=per_batch, launches=run["launches"],
                points_per_s=n_points
                / per_batch["forward alone (batch 1, once)"],
                peak_gib=run["peak"])
            out["cli_test"][vs] = row
            log(f"preprocess (e): {vs} mm: cli test in {run['secs']:.2f} s;"
                f" voxels a scene {row['voxels_a_scene']}, bucket "
                f"{row['bucket']}; launches {run['launches']}; seconds a "
                f"batch {json.dumps(per_batch)}; {row['points_per_s']:.0f} "
                f"points/s (forward alone); peak {row['peak_gib']:.2f} GiB "
                f"on {card}")
            metrics = seen["metrics"]
            assert set(metrics) == entry_metric_keys("test"), sorted(
                set(metrics) ^ entry_metric_keys("test"))
            assert all(np.isfinite(metrics[k]) for k in metrics
                       if "loss" in k or "mean_ap" in k), metrics
            assert bool(torch.isfinite(seen["pred_class"]).all()) and \
                bool(torch.isfinite(seen["pred_masks"]).all())
            assert bool(torch.isfinite(fwd.pred_class).all())
            assert run["launches"]["masked_attention"] == 12 and \
                run["launches"]["row_gather"] == 13 and \
                run["launches"]["lsap"] == 1, run["launches"]
    return out


def kernel_counters():
    """(counters, by_key) of the kernel wrappers, as `main` builds them:
    for a spawned rank of the parallel phase."""
    from mask3d_tpu_torch.ops import lsap as lsap_mod
    from mask3d_tpu_torch.ops import masked_attention as ma
    from mask3d_tpu_torch.sparse import int8_conv as ic
    from mask3d_tpu_torch.sparse import row_gather as rg
    from mask3d_tpu_torch.sparse import sparse_conv as sc

    counters = {"masked_attention": ma.masked_cross_attention,
                "row_gather": rg.row_gather, "sparse_conv": sc.sparse_conv,
                "int8_conv": ic.int8_conv,
                "lsap": lsap_mod.linear_sum_assignment}
    by_key = {"attention": (ma.masked_cross_attention.launches_by_shape,
                            {}),
              "attention_partial": (
                  ma.masked_cross_attention.partial_by_shape, {})}
    return counters, by_key


def par_cfg(cfg_mod, extra=()):
    """The flagship train configuration of phase 9 (b) (`Config()` at the
    main path's bucket, no train-split metrics), with `extra`."""
    return cfg_mod.apply_overrides(cfg_mod.Config(), [
        f"data.point_bucket_multiple={BUCKET}",
        "trainer.train_split_metrics=false", *extra])


def par_leaf_ratio(ref, got):
    """(worst leaf, max |got - ref| / max(1, max |ref|)) over the leaves."""
    errs = {k: float((got[k].double() - r.double()).abs().max())
            / max(1.0, float(r.double().abs().max())) for k, r in ref.items()}
    k = max(errs, key=errs.get)
    return k, errs[k]


def par_excess(np, ref, got):
    """JAX's sharded-forward bounds (tests/test_parallel_sp.py:112-113) on
    the outputs: per output the max |diff| and the worst excess over
    atol + rtol |ref| (passes at <= 0)."""
    out = {}
    for name, (r, g) in zip(PAR_SP_BOUNDS, zip(ref, got)):
        rtol, atol = PAR_SP_BOUNDS[name]
        d = np.abs(g.astype(np.float64) - r)
        out[name] = dict(max_abs_diff=float(d.max()),
                         excess=float((d - (atol + rtol * np.abs(r))).max()))
    return out


def same_value(a, b):
    """Equal, or both NaN."""
    return a == b or (a != a and b != b)


class PatchAttr:
    """Set `owner.name` to `value` for the block."""

    def __init__(self, owner, name, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.saved = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


def timed_collectives(torch, comm):
    """A patch of `comm.flat_all_reduce` (the gradient all-reduces) that
    records each call's fenced milliseconds in the returned list."""
    real = comm.flat_all_reduce
    ms = []

    def flat_all_reduce(tensors, group, name):
        if not name.endswith("_grads"):  # not a gradient all-reduce
            return real(tensors, group, name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(tensors, group, name)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)

    return PatchAttr(comm, "flat_all_reduce", flat_all_reduce), ms


def par_impl_overrides(impl, batch):
    """PAR_IMPL_STEPS[impl], with `bricked`'s brick capacity: every brick
    of the batch's level-0 grid."""
    extra = list(PAR_IMPL_STEPS[impl])
    if impl == "bricked":
        slots = 1
        for g, b in zip(batch.grid_dims[0], PAR_BRICKS):
            slots *= int(g) // b
        extra.append(f"model.brick_capacity={slots}")
    return extra


def whole_row_payload(comm):
    """A patch of `comm.reduce_scatter_rows` that adds each call's input
    bytes to the returned one-element list: what an all-reduce of the same
    rows, whole on every rank, would carry."""
    real = comm.reduce_scatter_rows
    total = [0]

    def reduce_scatter_rows(x, bounds, group, name="rows"):
        total[0] += x.numel() * x.element_size()
        return real(x, bounds, group, name)

    return PatchAttr(comm, "reduce_scatter_rows", reduce_scatter_rows), total


def par_rank_work(torch, np, rank, world, work_dir, data_root):
    """The parallel phase's part (b) and (c) on one spawned gloo rank of
    `world`, sharing the card: the dp=2 step, the sp=2 eval forward and
    train step, each with its planted fault, and `fit()`. Returns the
    numbers; the parent gates them."""
    import torch.distributed as tdist

    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch import config as cfg_mod
    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.data.collate import VoxelizeCollate
    from mask3d_tpu_torch.parallel import comm, dist, make_mesh, \
        make_mesh_2d, use_mesh
    from mask3d_tpu_torch.profile_forward import flagship_items
    from mask3d_tpu_torch.train import loop
    from mask3d_tpu_torch.train.criterion import SetCriterion

    counters, by_key = kernel_counters()
    refs = {}
    for name in ("sampled", "whole", *PAR_IMPL_STEPS):
        r = torch.load(os.path.join(work_dir, f"ref_{name}.pt"),
                       weights_only=False)
        refs[name] = (r["loss"], {k: g.cuda() for k, g in r["grads"].items()})
    cfg = par_cfg(cfg_mod)
    cfg_whole = par_cfg(cfg_mod, ["model.max_sample_size=true"])
    cfg_sp = par_cfg(cfg_mod, ["model.sp_axis=sp"])
    items = flagship_items()
    out = {}

    def step(cfg_, batch, tag, ref):
        """One step against the reference `refs[ref]`."""
        ref_loss, ref_grads = refs[ref]
        comm.reset_bytes()
        patch, ms = timed_collectives(torch, comm)
        payload, whole = whole_row_payload(comm)
        with patch, payload:
            losses, launches, by_s, state, peak, secs = train_steps(
                torch, mt, counters, by_key, cfg_, batch)
        partial_by_s = dict(by_key["attention_partial"][0])
        grads = {k: p.grad.detach().clone()
                 for k, p in state.model.named_parameters()}
        del state
        loss = losses[0]["loss"]
        name, ratio = par_leaf_ratio(ref_grads, grads)
        errs = leaf_errors(ref_grads, grads)
        worst = max(errs, key=errs.get)
        out[tag] = dict(
            reference=ref, loss=loss,
            loss_rel=abs(loss - ref_loss) / abs(ref_loss),
            worst_leaf=name, worst_ratio=ratio, worst_norm_leaf=worst,
            worst_norm_ratio=errs[worst], launches=launches,
            attention_by_s=by_s, attention_partial_by_s=partial_by_s,
            seconds=secs[0], peak_gib=peak, bytes=dict(comm.BYTES),
            whole_row_bytes=whole[0], all_reduce_ms=ms)
        del grads
        torch.cuda.empty_cache()

    # (b) dp=2: this rank's 4 scenes, padded to the pair's shapes
    mesh = make_mesh(world)
    host = VoxelizeCollate(point_bucket_multiple=BUCKET)(
        [items[i] for i in dist.local_batch_indices(np.arange(8))])
    with use_mesh(mesh):
        host, batch = dist.put_global(host, "cuda", mesh.dp_group)
        step(cfg, batch, "dp", "sampled")
        out["dp"]["batch"] = [batch.capacity, list(batch.grid_dims[0]),
                              int(batch.coords.shape[0])]
        step(cfg_whole, batch, "dp whole levels", "whole")
        with PatchAttr(SetCriterion, "ce_denominators",
                       lambda self, w: w.sum(dim=(1, 2)).detach()):
            step(cfg_whole, batch, "dp fault: local CE normaliser", "whole")
    del batch

    # (b) sp=2: the flagship eval forward and a train step on all 8 scenes
    mesh2 = make_mesh_2d(1, world)
    full = mt.collate(items, device="cuda",
                      point_bucket_multiple=BUCKET).device
    ref_out = np.load(os.path.join(work_dir, "forward.npz"))
    ref_out = (ref_out["pred_class"], ref_out["pred_masks"])
    model = mt.build_model(cfg_sp, device="cuda", seed=0)

    def forward(tag):
        comm.reset_bytes()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with use_mesh(mesh2):
            o, _ = mt.infer(model, full, cfg_sp, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = (o.pred_class.cpu().numpy(), o.pred_masks.cpu().numpy())
        out[tag] = dict(
            gates=par_excess(np, ref_out, got),
            launches={k: fn.launches for k, fn in counters.items()},
            seconds=secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            bytes=dict(comm.BYTES))

    forward("sp forward (warm-up)")
    forward("sp forward")
    real_halo = comm.halo

    def one_sided_halo(x, h, group):
        y = real_halo(x, h, group)
        return torch.cat([y[:, :-h], torch.zeros_like(y[:, -h:])], dim=1)

    with PatchAttr(comm, "halo", one_sided_halo):
        forward("sp fault: one side of the halo zeroed")
    del model
    torch.cuda.empty_cache()
    real_sum = comm.sum_partials

    def local_sums(x, group, name="partials"):
        return x if name == "criterion_losses" else real_sum(x, group, name)

    with use_mesh(mesh2):
        step(cfg_sp, full, "sp step", "sampled")
        # every parameter's gradient summed over sp: the replicated ones
        # (the queries' side, complete on every rank) count twice
        with PatchAttr(loop, "grad_groups", lambda m: (
                [p for p in m.parameters() if p.requires_grad],) * 2):
            step(cfg_sp, full, "sp fault: replicated gradients summed over "
                 "sp", "sampled")
        with PatchAttr(comm, "sum_partials", local_sums):
            step(cfg_sp, full, "sp fault: criterion mask sums left "
                 "rank-local", "sampled")
    del full
    torch.cuda.empty_cache()
    # the sp steps off `dense`: the backbone whole on every rank
    part = mt.collate(items[:PAR_IMPL_SCENES], device="cuda",
                      point_bucket_multiple=BUCKET).device
    with use_mesh(mesh2):
        for impl in PAR_IMPL_STEPS:
            step(par_cfg(cfg_mod, ["model.sp_axis=sp",
                                   *par_impl_overrides(impl, part)]),
                 part, f"sp step {impl}", impl)
    del part
    torch.cuda.empty_cache()

    # (c) fit() on the two ranks: 1 epoch at batch 4, then a validation
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    save_dir = os.path.join(work_dir, "fit")
    written = []

    def audit(event, args):
        if event == "open" and isinstance(args[0], str) and \
                any(c in str(args[1]) for c in "wax+") and \
                os.path.abspath(args[0]).startswith(save_dir):
            written.append(args[0])

    sys.addaudithook(audit)
    fit_cfg = cfg_mod.apply_overrides(cfg_mod.Config(), [
        f"data.data_root={data_root}", f"data.batch_size={PAR_FIT_BATCH}",
        "trainer.max_epochs=1", f"trainer.num_data_parallel={world}",
        "general.experiment_id=fit", f"general.save_dir={save_dir}"])
    t = time.perf_counter()
    from mask3d_tpu_torch.cli import seed_everything

    seed_everything(fit_cfg.general.seed)  # the augmentations, as cli does
    trainer = InstanceSegmentationTrainer(fit_cfg, device="cuda")
    trainer.fit()
    with use_mesh(trainer.mesh):
        val = trainer.eval_epoch("validation")
    if rank == 0:
        torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
                   os.path.join(work_dir, "fit_weights.pt"))
    tdist.barrier()
    out["fit"] = dict(val=val, steps=trainer.state.step,
                      seconds=time.perf_counter() - t,
                      written=sorted({os.path.relpath(p, save_dir)
                                      for p in written}),
                      run_dir=trainer.run_dir)
    out["rebuilt_kernels"] = sorted(cuda_build.build_logs)
    return out


def ranks_shaped_validation(torch, np, one, world, device="cuda"):
    """`one.eval_epoch("validation")` (a trainer with no group) computed as
    `world` dp ranks compute it: each global batch's rank slices
    (`dist.local_batch_indices`), padded to their shared shapes as
    `dist.pad_to_group` pads them, forwarded one slice at a time; the CE
    normaliser is the slices' weight sums summed (a first pass records
    them), the losses are summed over the slices and `batch_overflow` is
    their MAX, and the evaluator sees the items in global order. On one
    card every metric is the ranks' bit for bit: the same inputs, shapes
    and kernels, and the collectives' sums of two operands."""
    from mask3d_tpu_torch.parallel import dist

    cfg, crit = one.cfg, one.criterion
    ds = one.datasets["validation"]
    bs = cfg.data.test_batch_size if cfg.data.test_batch_size > 0 \
        else cfg.data.batch_size
    one.model.eval()
    one.evaluator.notify_new_epoch()
    loss_acc, all_metrics = {}, []
    for s in range(0, len(ds), bs):
        idxs = np.arange(s, min(s + bs, len(ds)))
        hosts = [one.collate([ds[int(i)] for i in dist.local_batch_indices(
            idxs, r, world)]) for r in range(world)]
        ds_ = [h.device for h in hosts]
        ones = [0 if d.feats_all_ones is None else
                (1 if d.feats_all_ones else -1) for d in ds_]
        neg = max(-v for v in ones)  # pad_to_group's MAX of the negation
        padded = [dist.pad_host_batch(
            h, max(d.coords.shape[1] for d in ds_),
            max(d.target.labels.shape[1] for d in ds_),
            tuple(max(d.grid_dims[0][a] for d in ds_) for a in range(3)),
            None if neg == 0 else neg < 0) for h in hosts]
        dens = []

        def record(w):
            dens.append(w.sum(dim=(1, 2)).detach())
            return dens[-1]

        with PatchAttr(crit, "ce_denominators", record):
            for p in padded:
                one.eval_step(p.device.to(device))
        assert len(dens) == world, len(dens)
        total = dens[0]
        for d in dens[1:]:
            total = total + d
        outs = []
        with PatchAttr(crit, "ce_denominators", lambda w: total):
            for p in padded:
                outs.append(one.eval_step(p.device.to(device)))
        keys = [k for k in outs[0][2] if k != "batch_overflow"]
        vals = None
        for _, _, losses in outs:
            v = torch.stack([losses[k].float() for k in keys])
            vals = v if vals is None else vals + v
        for k, v in zip(keys, vals.cpu().numpy()):
            loss_acc.setdefault(f"val_{k}", []).append(float(v))
        loss_acc.setdefault("val_batch_overflow", []).append(float(max(
            int(o[2]["batch_overflow"]) for o in outs)))
        preds, targets = [], []
        for h, (pred_class, pred_masks, _) in zip(hosts, outs):
            p, t = one._postprocess_batch(h, pred_class.cpu().numpy(),
                                          pred_masks.cpu().numpy())
            preds += p
            targets += t
        all_metrics.append(one._evaluate(preds, targets, "val"))
    out = {k: float(np.mean(v)) for k, v in loss_acc.items()}
    for k in all_metrics[0]:
        vals = [m[k] for m in all_metrics if np.isfinite(m[k])]
        out[k] = float(np.mean(vals)) if vals else float("nan")
    return out


def _rank_entry(rank, world, store, work_dir, fn_name, args):
    """A spawned rank of the parallel phases: one gloo group through a file
    store, the rank's card the one card, the parent's numerics
    (`configure_torch(True)`); runs `fn_name(torch, np, rank, world,
    work_dir, *args)` and writes its numbers (or its traceback) to
    `work_dir/rank<r>.pt`."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch
    import torch.distributed as tdist

    path = os.path.join(work_dir, f"rank{rank}.pt")
    try:
        torch.cuda.set_device(0)
        from mask3d_tpu_torch.train.loop import configure_torch

        configure_torch(True)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=world)
        torch.save({"ok": globals()[fn_name](torch, np, rank, world,
                                             work_dir, *args)}, path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_ranks(torch, work, fn_name, *args):
    """PAR_RANKS spawned gloo ranks sharing the card, each running
    `fn_name` (`_rank_entry`); every rank's numbers, rank order (a failed
    rank raises with its traceback)."""
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(PAR_RANKS, os.path.join(work, "store"), work,
                           fn_name, args),
        nprocs=PAR_RANKS, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = []
    for r in range(PAR_RANKS):
        got = torch.load(os.path.join(work, f"rank{r}.pt"),
                         weights_only=False)
        if "error" in got:
            raise RuntimeError(f"rank {r}:\n{got['error']}")
        ranks.append(got["ok"])
    return ranks


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def segment_sum_determinism(torch, mt, cfg_mod, batch, card):
    """Two flagship `gather_pallas` forwards with deterministic algorithms
    off (as `infer` runs outside `cli`), which must be bitwise equal: the
    segment sums of the stride-2 convs and the pools add each segment in a
    fixed order (`sparse/ops.py`). The same two forwards with those sums
    as `scatter_add_` (atomics on the card) are printed beside."""
    import contextlib

    from mask3d_tpu_torch.sparse import ops

    cfg = par_cfg(cfg_mod, ["model.backbone_impl=gather_pallas"])
    model = mt.build_model(cfg, device="cuda", seed=0)

    def atomic(x, pool, cap):
        b, _, c = x.shape
        out = x.new_zeros((b, cap + 1, c))
        out.scatter_add_(1, pool.parent.long()[..., None].expand(-1, -1, c),
                         x)
        return out[:, :cap]

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    res = {}
    try:
        for name, patch in (
                ("fixed order", contextlib.nullcontext()),
                ("scatter_add_", PatchAttr(ops, "_segment_sum_batched",
                                           atomic))):
            with patch:
                outs = [mt.infer(model, batch, cfg, device="cuda")[0]
                        for _ in range(2)]
            res[name] = dict(
                bitwise=all(torch.equal(getattr(outs[0], k),
                                        getattr(outs[1], k))
                            for k in ("pred_class", "pred_masks")),
                max_abs_diff=float((outs[0].pred_masks
                                    - outs[1].pred_masks).abs().max()))
    finally:
        torch.use_deterministic_algorithms(was)
    del model
    torch.cuda.empty_cache()
    log(f"parallel: two gather_pallas forwards with deterministic "
        f"algorithms off: {json.dumps(res)} (gate: the fixed-order sums "
        f"bitwise; scatter_add_ printed) on {card}")
    assert res["fixed order"]["bitwise"], res
    return res


def partial_attention_backward(torch, ma, card):
    """The attention's partial form as the sp=2 train step runs it on a
    sampled memory: each rank holds the whole sampled length S (every one
    of TRAIN_ATTN_S), its slots of the other rank's rows blocked with v
    zero and dropped (`drop_absent_keys`), and the two ranks' triples are
    combined with the maxes detached. A random split of the slots between
    the ranks, an item whose sampled rows all lie on rank 0 (none on rank
    1) and a query blocked on every key. The (q, k, v) gradients of a
    random cotangent through the kernel's forward against the same graph
    on the plain partial form (max |err| / max(1, |ref|) <= ATTN_TOL), the
    combined output against the one-shot plain attention over the sampled
    keys (max |err| <= ATTN_TOL), the kernel's forward timed at a rank's
    shapes beside the plain form's, and its backward (the plain form's
    VJP, `masked_cross_attention_partial_backward`) beside its bound.
    Returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, nq, d, h = 8, 25, 128, 8
    rows = []
    for s in TRAIN_ATTN_S:
        q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen)
                   for n in (nq, s, s))
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        mask[0, 0] = True  # blocked on every key
        mine = torch.rand(b, s, device="cuda", generator=gen) < 0.5
        mine[1] = True  # item 1's rows all on rank 0: rank 1 has none
        ranks = [(mask | ~own[:, None, :], own) for own in (mine, ~mine)]
        g_out = torch.randn(b, nq, d, device="cuda", generator=gen)
        g_sum = torch.randn(b, h, nq, device="cuda", generator=gen)

        def combined(fn):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            parts = []
            for mm, own in ranks:
                o, m, lsum = fn(leaves[0], leaves[1],
                                leaves[2] * own[..., None], mm, h)
                o, lsum = ma.drop_absent_keys(o, m, lsum, (~own).sum(dim=1),
                                              h)
                parts.append((o, m.detach(), lsum))
            outs, maxes, sums = zip(*parts)
            out = ma.combine_partial_softmax(outs, maxes, sums, h)
            return out.detach(), torch.autograd.grad(out, leaves, g_out)

        out, got = combined(ma.masked_cross_attention_partial)
        _, ref = combined(ma.masked_cross_attention_partial_plain)
        one_shot = ma.masked_cross_attention_plain(q, k, v, mask, h)
        err = max(float((a.double() - r.double()).abs().max())
                  / max(1.0, float(r.double().abs().max()))
                  for a, r in zip(got, ref))
        out_err = float((out - one_shot).abs().max())
        mm, own = ranks[0]
        v0 = v * own[..., None]
        fwd_ms = time_graph_ms(torch, lambda: ma.masked_cross_attention_partial(
            q, k, v0, mm, h))
        fwd_plain_ms = time_ms(torch, lambda: ma
                               .masked_cross_attention_partial_plain(
                                   q, k, v0, mm, h), iters=5)
        ms, eager = time_backward_ms(
            torch, lambda: ma.masked_cross_attention_partial_backward(
                q, k, v0, mm, h, g_out, g_sum))
        fwd_bound_ms, fwd_by = bound(
            4 * (2 * b * nq * d + 2 * b * s * d + 2 * b * h * nq)
            + b * nq * s, 4 * b * nq * s * d)
        bound_ms, by = bound(4 * 2 * (2 * b * nq * d + 2 * b * s * d)
                             + 4 * b * h * nq + b * nq * s,
                             12 * b * nq * s * d)
        rows.append(dict(S=s, S_rank=s, max_rel_err=err, out_err=out_err,
                         fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                         fwd_bound_ms=fwd_bound_ms, fwd_bound_by=fwd_by,
                         ms=ms, eager_ms=eager, bound_ms=bound_ms,
                         bound_by=by))
        log(f"parallel: the attention's partial form at the sampled length "
            f"S={s} on each of two ranks (a random split of the slots), "
            f"kernel forward vs the plain partial form through "
            f"drop_absent_keys and the combine: (q, k, v) gradients "
            f"max|err|/max(1,|ref|) {err:.3g}, combined output vs one-shot "
            f"{out_err:.3g} (tol {ATTN_TOL}); forward {fwd_ms:.4f} ms a rank"
            f" (plain {fwd_plain_ms:.4f}, bound {fwd_bound_ms:.4f} ms, "
            f"{fwd_by}); backward {ms:.4f} ms (eager {eager:.4f}), bound "
            f"{bound_ms:.4f} ms ({by}) on {card}")
        assert err <= ATTN_TOL and out_err <= ATTN_TOL, rows[-1]
        del q, k, v, v0, mask, ranks
    return rows


def run_parallel(torch, np, mt, cfg_mod, counters, by_key, card, host):
    """Phase `parallel` (see the docstring's phase 15): (a) one flagship
    train step through the port's dp step on a one-rank NCCL group against
    the same step with no group; (b) two gloo ranks sharing the card: the
    dp=2 step and the sp=2 eval forward and train step against the
    one-process ones, three planted faults; (c) `fit()` on those ranks
    against a one-process validation on the same weights. Every gate is
    checked here; returns the numbers."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from mask3d_tpu_torch.parallel import comm, make_mesh, use_mesh
    from mask3d_tpu_torch.profile_forward import flagship_items
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    res = {}
    cfg = par_cfg(cfg_mod)
    batch = host.device
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    work = tempfile.mkdtemp(dir=build)
    try:
        # the no-group step (phase 9 (b)'s, kernels on)
        losses, launches, by_s, state, _, secs = train_steps(
            torch, mt, counters, by_key, cfg, batch)
        ref_loss = losses[0]["loss"]
        ref_grads = {k: p.grad.detach().clone()
                     for k, p in state.model.named_parameters()}
        del state
        # (a) the port's dp step on a one-rank NCCL group
        torch.cuda.set_device(0)
        tdist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1)
        try:
            comm.reset_bytes()
            patch, ms = timed_collectives(torch, comm)
            with patch, use_mesh(make_mesh(1)):
                losses, launches, _, state, _, secs1 = train_steps(
                    torch, mt, counters, by_key, cfg, batch)
            grads = {k: p.grad.detach().clone()
                     for k, p in state.model.named_parameters()}
            del state
            nbytes = dict(comm.BYTES)
        finally:
            tdist.destroy_process_group()
        bitwise = losses[0]["loss"] == ref_loss and all(
            torch.equal(grads[k], g) for k, g in ref_grads.items())
        name, ratio = par_leaf_ratio(ref_grads, grads)
        res["nccl_one_rank"] = dict(
            loss=losses[0]["loss"], ref_loss=ref_loss, bitwise=bitwise,
            worst_leaf=name, worst_ratio=ratio, launches=launches,
            seconds=secs1[0], no_group_seconds=secs[0], all_reduce_ms=ms,
            bytes=nbytes)
        log(f"parallel (a) NCCL, one rank: dp step loss {losses[0]['loss']}"
            f" vs no group {ref_loss}, bitwise {bitwise}"
            + ("" if bitwise else
               f" (not bitwise: worst leaf {name} at {ratio:.3g} x max(1, "
               f"max|leaf|); NCCL's one-rank all-reduce sums in its own "
               f"kernel)") + f"; gradient all-reduce {ms} ms for "
            f"{nbytes.get('dp_grads', 0)} bytes a step, all bytes {nbytes}; "
            f"step {secs1[0]:.3f} s (no group {secs[0]:.3f} s); launches "
            f"{launches} on {card}")
        assert bitwise or ratio <= PAR_BITWISE_TOL, (name, ratio)
        assert launches["masked_attention"] == 12 and \
            launches["row_gather"] == 13 and launches["lsap"] == 1, launches
        del grads

        torch.save({"loss": ref_loss,
                    "grads": {k: g.cpu() for k, g in ref_grads.items()}},
                   os.path.join(work, "ref_sampled.pt"))
        # how far an equivalent step lies: the stem's weights 1 ulp up
        *_, state, _, _ = train_steps(
            torch, mt, counters, by_key, cfg, batch,
            prepare=lambda st: st.model.backbone.convs[
                "conv0p1s1"].weight.data.mul_(1 + 2 ** -23))
        errs = leaf_errors(ref_grads, {
            k: p.grad for k, p in state.model.named_parameters()})
        worst = max(errs, key=errs.get)
        res["one_ulp_floor"] = dict(leaf=worst, ratio=errs[worst])
        log(f"parallel: the batch-8 step with the stem's weights 1 ulp up "
            f"sits {errs[worst]:.4g} from it by leaf_errors (worst leaf "
            f"{worst}): the rounding floor of a flagship step at init on "
            f"{card}")
        del state, ref_grads
        # the dp reference with whole levels as memories: one process, 2 x
        # 4 micro-batches, so each micro-batch's convs are a dp rank's
        cfg_acc = par_cfg(cfg_mod, ["model.max_sample_size=true",
                                    "trainer.grad_accum_steps=2"])
        losses, _, _, state, _, secs2 = train_steps(
            torch, mt, counters, by_key, cfg_acc, batch)
        torch.save({"loss": losses[0]["loss"],
                    "grads": {k: p.grad.cpu() for k, p in
                              state.model.named_parameters()}},
                   os.path.join(work, "ref_whole.pt"))
        del state
        model = mt.build_model(cfg, device="cuda", seed=0)
        out, _ = mt.infer(model, batch, cfg, device="cuda")
        np.savez(os.path.join(work, "forward.npz"),
                 pred_class=out.pred_class.cpu().numpy(),
                 pred_masks=out.pred_masks.cpu().numpy())
        del model, out
        torch.cuda.empty_cache()
        # the one-process steps the sp steps off `dense` are held to
        part = mt.collate(flagship_items()[:PAR_IMPL_SCENES], device="cuda",
                          point_bucket_multiple=BUCKET).device
        for impl in PAR_IMPL_STEPS:
            losses, launches, _, state, peak, secs3 = train_steps(
                torch, mt, counters, by_key,
                par_cfg(cfg_mod, par_impl_overrides(impl, part)), part)
            torch.save({"loss": losses[0]["loss"],
                        "grads": {k: p.grad.cpu() for k, p in
                                  state.model.named_parameters()}},
                       os.path.join(work, f"ref_{impl}.pt"))
            res[f"one_process_{impl}"] = dict(
                loss=losses[0]["loss"], launches=launches, peak_gib=peak,
                seconds=secs3[0])
            log(f"parallel: the one-process {impl} step on "
                f"{PAR_IMPL_SCENES} scenes: loss {losses[0]['loss']}, "
                f"{secs3[0]:.3f} s, {peak:.2f} GiB, launches {launches} on "
                f"{card}")
            del state
        del part
        torch.cuda.empty_cache()
        res["determinism"] = segment_sum_determinism(
            torch, mt, cfg_mod, batch, card)
        from mask3d_tpu_torch.ops import masked_attention as ma

        res["partial_backward"] = partial_attention_backward(torch, ma, card)
        root = os.path.join(work, "data")
        write_entry_dataset(np, root, n_train=8, n_test=1, n_val=2)

        # (b) and (c): two gloo ranks sharing the card
        t = time.perf_counter()
        ranks = run_ranks(torch, work, "par_rank_work", root)
        res["ranks_seconds"] = time.perf_counter() - t
        for r, got in enumerate(ranks):
            for tag, v in got.items():
                if tag != "fit":
                    log(f"parallel rank {r} {tag}: {json.dumps(v)} on {card}")
        gates = {}
        for r, got in enumerate(ranks):
            dp, whole = got["dp"], got["dp whole levels"]
            assert dp["batch"][2] == 4, dp["batch"]
            for d in (dp, whole):
                assert d["launches"]["masked_attention"] == 12 and \
                    d["launches"]["row_gather"] == 13 and \
                    d["launches"]["lsap"] == 1, d["launches"]
                assert d["loss_rel"] <= TRAIN_LOSS_TOL, d
            assert dp["worst_norm_ratio"] <= PAR_STEP_TOL, dp
            assert whole["worst_ratio"] <= PAR_LEAF_TOL, whole
            fault = got["dp fault: local CE normaliser"]
            assert fault["worst_ratio"] > PAR_LEAF_TOL, fault
            sp = got["sp forward"]
            assert sp["launches"]["masked_attention"] == 12 and \
                sp["launches"]["row_gather"] == 13, sp["launches"]
            assert all(g["excess"] <= 0 for g in sp["gates"].values()), sp
            fault = got["sp fault: one side of the halo zeroed"]
            assert any(g["excess"] > 0 for g in fault["gates"].values()), \
                fault
            st = got["sp step"]
            assert st["launches"]["masked_attention"] == 12 and \
                st["launches"]["row_gather"] == 13, st["launches"]
            sp_steps = {"dense": st, **{
                impl: got[f"sp step {impl}"] for impl in PAR_IMPL_STEPS}}
            for impl, d in sp_steps.items():
                # every cross-attention a micro-batch is the partial form
                n_attn = 12 * (PAR_IMPL_SCENES if impl == "bricked" else 1)
                assert d["launches"]["masked_attention"] == n_attn == sum(
                    d["attention_partial_by_s"].values()), (impl, d)
                assert d["loss_rel"] <= TRAIN_LOSS_TOL, (impl, d)
                assert d["worst_norm_ratio"] <= PAR_STEP_TOL, (impl, d)
                if impl == "dense":  # the slabs' rows reduce-scattered
                    assert d["whole_row_bytes"] > d["bytes"]["rows"] > 0, d
            assert sp_steps["gather_pallas"]["launches"]["sparse_conv"] > 0
            assert sp_steps["bricked"]["launches"]["row_gather"] > 0
            faults = {k: got[f"sp fault: {k}"] for k in (
                "replicated gradients summed over sp",
                "criterion mask sums left rank-local")}
            for k, fault in faults.items():
                assert fault["worst_norm_ratio"] > PAR_STEP_TOL, (k, fault)
            assert got["rebuilt_kernels"] == [], got["rebuilt_kernels"]
            gates[r] = dict(
                dp_worst_norm_ratio=dp["worst_norm_ratio"],
                dp_whole_worst_ratio=whole["worst_ratio"],
                dp_fault_ratio=got["dp fault: local CE normaliser"][
                    "worst_ratio"],
                sp_forward=sp["gates"],
                sp_fault=got["sp fault: one side of the halo zeroed"][
                    "gates"],
                sp_step_worst={k: d["worst_norm_ratio"]
                               for k, d in sp_steps.items()},
                sp_step_faults={k: f["worst_norm_ratio"]
                                for k, f in faults.items()})
            for impl, d in sp_steps.items():
                rows = {k: d["bytes"].get(k, 0) for k in PAR_ROW_BYTES}
                log(f"parallel rank {r} sp=2 step on {impl} ({d['reference']}"
                    f" batch): row bytes by collective {json.dumps(rows)}, "
                    f"{sum(rows.values())} in all, against "
                    f"{d['whole_row_bytes']} for an all-reduce of the same "
                    f"rows whole; peak {d['peak_gib']:.2f} GiB, "
                    f"{d['seconds']:.3f} s a step, partial attention "
                    f"launches by S {d['attention_partial_by_s']} on {card}")
        log(f"parallel (b) gates by rank: {json.dumps(gates)} (dp with "
            f"whole levels against 2 x 4 in one process: leaves <= "
            f"{PAR_LEAF_TOL} x max(1, max|leaf|); the sampled dp and sp "
            f"steps against the batch-8 step: leaf_errors <= "
            f"{PAR_STEP_TOL}, the sp steps off dense against their "
            f"one-process {PAR_IMPL_SCENES}-scene steps likewise; sp forward "
            f"excess over JAX's bounds <= 0; each fault past its gate) on "
            f"{card}")

        # (c) fit(): rank 0 alone wrote, and the validation equals a
        # one-process one on the same weights and scenes
        fits = [got["fit"] for got in ranks]
        log(f"parallel (c) fit on {PAR_RANKS} gloo ranks: "
            f"{json.dumps(fits)} on {card}")
        assert fits[0]["written"] and fits[1]["written"] == [], fits
        assert all(same_value(v, fits[1]["val"][k])
                   for k, v in fits[0]["val"].items()), fits
        assert all(f["steps"] == 8 // PAR_FIT_BATCH for f in fits), fits
        one_cfg = cfg_mod.apply_overrides(cfg_mod.Config(), [
            f"data.data_root={root}", f"data.batch_size={PAR_FIT_BATCH}",
            "general.experiment_id=one",
            f"general.save_dir={os.path.join(work, 'one')}"])
        one = InstanceSegmentationTrainer(one_cfg, device="cuda")
        one.model.load_state_dict(torch.load(
            os.path.join(work, "fit_weights.pt"), weights_only=True))
        shaped = ranks_shaped_validation(torch, np, one, PAR_RANKS)
        ref_val = one.eval_epoch("validation")
        del one
        assert set(ref_val) == set(fits[0]["val"]) == set(shaped), (
            ref_val, shaped, fits[0])
        unequal = {k: (v, shaped[k]) for k, v in fits[0]["val"].items()
                   if not same_value(v, shaped[k])}
        log(f"parallel (c) validation, {PAR_RANKS} ranks vs one process on "
            f"rank 0's weights at the ranks' shapes: {len(shaped)} metrics, "
            f"unequal {json.dumps(unequal)} (gate: none) on {card}")
        assert not unequal, unequal
        # the one-process validation at the global batch's shapes: its
        # convs and matmuls run at batch 2, the ranks' at batch 1, and the
        # decoder's mask thresholds amplify that rounding (card runs read
        # 2.3e-4 on a final loss and 1.2e-2 on an auxiliary level); printed
        rel = {k: abs(a - v) / max(1.0, abs(v)) for k, v in ref_val.items()
               for a in (fits[0]["val"][k],) if not same_value(a, v)}
        n_eval = sum("loss" not in k for k in ref_val)
        worst = max(rel, key=rel.get, default=None)
        log(f"parallel (c) validation, {PAR_RANKS} ranks vs one process at "
            f"the global batch's shapes: {len(rel)} of {len(ref_val)} "
            f"metrics unequal ({n_eval} of the evaluator's among them: "
            f"{sum('loss' not in k for k in rel)}), worst {worst} at "
            f"{rel.get(worst, 0.0):.3g} relative (printed) on {card}")
        res["ranks"] = ranks
        res["gates"] = gates
        res["fit_vs_global_shapes"] = rel
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def zoo_cfg(cfg_mod, extra=(), backbone=ZOO_BACKBONE):
    return cfg_mod.apply_overrides(cfg_mod.Config(), [
        f"data.point_bucket_multiple={BUCKET}", f"model.backbone={backbone}",
        *extra])


def zoo_maps(torch, mdl, cfg, dev, sparse, items):
    """The backbone's five maps [strides 16..1] as f32 tensors on the card
    of the valid rows of the first `items` items (the 1024-wide maps stay
    on the card: their numpy copies would take a host GiB each)."""
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    with torch.inference_mode():
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg, dev.capacity), dev.grid_dims,
            **sb_kwargs(cfg))
        _, maps, _ = mdl.backbone(dev.feats, sb, dev.grid_dims)
        n = sb.num_levels
        return [m[:items][sb.levels[n - 1 - i].valid[:items]].float()
                for i, m in enumerate(maps)]


def card_diff_stats(torch, ref, got):
    """`diff_stats` on the card: mean, max and std(ref) over every element,
    the 99.9% quantile over at most 2^24 of them (every k-th, k fixed:
    torch.quantile's limit)."""
    diff = (got.float() - ref.float()).abs().flatten()
    k = max(1, -(-diff.numel() // 2 ** 24))
    return dict(mean=float(diff.double().mean()),
                q999=float(torch.quantile(diff[::k], 0.999)),
                max=float(diff.max()), ref_std=float(ref.double().std()))


def zoo_full_width(torch, np, mt, cfg_mod, counters, by_key, card, host,
                   sparse, res):
    """(a): Res16UNet101 through `infer` on `dense` (fp32, then bf16) and
    `gather_pallas` at batch 8 on phase 3's scenes, one set of seeded
    weights; each forward counted, timed (median of ZOO_REPS fenced
    forwards), its peak GiB; bf16 and gather_pallas against fp32 dense
    with the existing constants. Returns the sparse conv's launches by
    shape in the counted gather_pallas forward."""
    from mask3d_tpu_torch.train.loop import split_batch

    dev = host.device
    state, ref, runs = None, None, {}
    shapes = {}
    for path, extra in ZOO_PATHS.items():
        c = zoo_cfg(cfg_mod, extra)
        mdl = mt.build_model(c, device="cuda", seed=0)
        if state is None:
            state = {k: v.clone() for k, v in mdl.state_dict().items()}
        else:
            mdl.load_state_dict(state)
        batch = dev
        try:
            out, launches, keyed, peak = counted(
                torch, counters, by_key,
                lambda: mt.infer(mdl, batch, c, device="cuda"))
        except torch.cuda.OutOfMemoryError:
            if path != "dense":
                raise
            # the fp32 grids of batch 8 do not fit: batch 4 (the cut is
            # listed in PERF.md)
            torch.cuda.empty_cache()
            batch = split_batch(dev, 2)[0]
            log(f"model_zoo {path}: batch 8 out of memory, cut to batch 4")
            out, launches, keyed, peak = counted(
                torch, counters, by_key,
                lambda: mt.infer(mdl, batch, c, device="cuda"))
        out, overflow = out
        assert not bool(overflow), path
        b = batch.coords.shape[0]
        pc, pm = out.pred_class, out.pred_masks
        assert tuple(pc.shape) == (b, 25, 2) and \
            tuple(pm.shape) == (b, dev.capacity, 25), (pc.shape, pm.shape)
        assert bool(torch.isfinite(pc).all()) and \
            bool(torch.isfinite(pm).all()), path
        assert out.backbone_feats.shape[-1] == 1024, out.backbone_feats.shape
        want = dict(ZOO_LAUNCHES[path], int8_conv=0, lsap=0)
        assert launches == want, (path, launches, want)
        assert sum(keyed["attention"].values()) == 12
        if path == "gather_pallas":
            shapes = keyed["sparse_conv"]
            assert sum(shapes.values()) == launches["sparse_conv"]
        ms = []
        for _ in range(ZOO_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(mdl, batch, c, device="cuda")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        maps = zoo_maps(torch, mdl, c, batch, sparse,
                        ref["items"] if ref else b)
        preds = (pc.float(), pm.float())
        runs[path] = dict(batch=b, launches=launches, peak_gib=peak,
                          ms=statistics.median(ms), ms_all=ms,
                          gather_dtypes=keyed["gather_dtypes"])
        log(f"model_zoo {ZOO_BACKBONE} {path} batch {b}: launches "
            f"{launches}, attention by key length {keyed['attention']}; "
            f"forward median {runs[path]['ms']:.2f} ms over {ZOO_REPS} "
            f"({[round(x, 2) for x in ms]}), peak {peak:.2f} GiB on {card}")
        if ref is None:
            ref = dict(items=b, preds=preds, maps=maps)
        else:
            n = ref["items"]
            valid = (torch.arange(dev.capacity, device="cuda")[None]
                     < batch.counts[:n, None])
            stats = {"pred_class": card_diff_stats(
                torch, ref["preds"][0], preds[0][:n]),
                "pred_masks": card_diff_stats(
                    torch, ref["preds"][1][valid], preds[1][:n][valid])}
            for i, (r, g) in enumerate(zip(ref["maps"], maps)):
                stats[f"map{i} (stride {16 >> i})"] = card_diff_stats(
                    torch, r, g)
            tol = BF16_STACK_MEAN if path == "bf16" else BF16_PATH_MEAN
            ratio = worst_ratio(stats, "mean", tol)
            for what, st in stats.items():
                log(f"model_zoo {path} vs fp32 dense {what}: "
                    f"{json.dumps(st)}")
            # printed, not gated: bf16 rounding grows with depth in this
            # random-weight net (Res16UNet101 on an NVIDIA H100 read the
            # bf16 ratio 6.45, map0 after stage 4's 23 blocks the worst);
            # the bf16 paths are gated card against CPU at a small width
            # in (c), as phase 7 does for the hall's bf16 paths
            log(f"model_zoo {path} vs fp32 dense (printed, not gated): "
                f"worst mean |diff| / max(1, std) {ratio * tol:.4g} "
                f"against {tol} (ratio {ratio:.4g})")
            runs[path]["ratio_to_fp32_gate"] = ratio
        del mdl, out, maps
        torch.cuda.empty_cache()
    res["paths"] = runs
    return shapes


def zoo_kernels(torch, rg, sc, dense_ops, host, cfg_mod, sparse, shapes,
                res):
    """(a) the kernels at the new shapes against their plain versions: the
    row gather at C=1024 (the 1024-wide level-0 tap) in f32 and bf16,
    bitwise; the sparse conv at every (N, K, Cin, Cout) the counted
    Res16UNet101 gather_pallas forward launched; each timed beside its
    bound (and the row gather beside `index_select`, printed: the speed
    gate of phase 2 is the flagship's)."""
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    dev = host.device
    caps = level_capacities(zoo_cfg(cfg_mod), dev.capacity)
    res["row_gather"] = check_gather(torch, rg, dense_ops, dev, caps,
                                     taps={1024: 0})
    res["row_gather_bf16"] = check_gather(torch, rg, dense_ops, dev, caps,
                                          torch.bfloat16, {1024: 0})
    for r in res["row_gather"] + res["row_gather_bf16"]:
        assert r["equal"], r
    c = zoo_cfg(cfg_mod, ZOO_PATHS["gather_pallas"])
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(c, dev.capacity), dev.grid_dims,
                            **sb_kwargs(c))
    log(f"model_zoo sparse_conv launches by (N, K, Cin, Cout) in the "
        f"counted {ZOO_BACKBONE} gather_pallas forward: {shapes}")
    res["sparse_conv"] = check_sparse_conv(torch, sc, sb, shapes)
    assert all(r["ok"] for r in res["sparse_conv"]), res["sparse_conv"]


def zoo_options(torch, mt, cfg_mod, counters, by_key, card, host, res):
    """(b): the decoder options at `Config()`'s width on Res16UNet34C,
    fp32 dense, batch 8: each counted (12 attention launches), finite,
    `sampled_coords` where the queries come from FPS and `backbone_feats`
    always; the random ones twice from one seed, bitwise equal; then one
    train step of the first combination, every new parameter with a
    finite nonzero gradient."""
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    dev = host.device
    runs = {}
    for name, extra in ZOO_COMBOS.items():
        c = zoo_cfg(cfg_mod, extra, backbone="Res16UNet34C")
        mdl = mt.build_model(c, device="cuda", seed=0)

        def forward():
            gen = torch.Generator(device="cuda").manual_seed(7)
            return mt.infer(mdl, dev, c, aux_masks=True, device="cuda",
                            generator=gen)[0]
        out, launches, _, peak = counted(torch, counters, by_key,
                                             forward)
        assert launches["masked_attention"] == 12, (name, launches)
        assert all(bool(torch.isfinite(t).all()) for t in (
            out.aux_pred_class, out.aux_pred_masks)), name
        fps = not any("non_parametric_queries=false" in e for e in extra)
        assert (out.sampled_coords is not None) == fps, name
        if fps:
            assert tuple(out.sampled_coords.shape) == (8, 25, 3)
        assert tuple(out.backbone_feats.shape) == (8, dev.capacity, 96)
        row = dict(launches=launches, peak_gib=peak)
        if "random" in name:
            again = forward()
            row["repeat_bitwise"] = torch.equal(
                out.aux_pred_class, again.aux_pred_class) and torch.equal(
                out.aux_pred_masks, again.aux_pred_masks)
            assert row["repeat_bitwise"], name
        runs[name] = row
        log(f"model_zoo option {name}: launches {launches}, peak "
            f"{peak:.2f} GiB, {json.dumps(row)}")
        del mdl, out
    first, extra = next(iter(ZOO_COMBOS.items()))
    c = zoo_cfg(cfg_mod, extra, backbone="Res16UNet34C")
    state = init_state(c, seed=0, device="cuda")
    step = make_train_step(c, make_criterion(c), "cuda")
    t = time.perf_counter()
    losses, _ = step(state, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    assert all(bool(torch.isfinite(v)) for v in losses.values()), losses
    new = {n: p for n, p in state.model.named_parameters()
           if n in ("query_feat", "query_pos", "level_embed")
           or any(f".{r}_" in n for r in (1, 2))}
    assert {"query_feat", "query_pos", "level_embed"} <= set(new), \
        sorted(new)
    bad = [n for n, p in new.items() if p.grad is None
           or not bool(torch.isfinite(p.grad).all())
           or float(p.grad.abs().sum()) == 0.0]
    # the attention's K biases have a true gradient of 0 (a per-query
    # shift of all logits), only rounding noise
    bad = [n for n in bad if not n.endswith("attn.k.bias")]
    log(f"model_zoo train step of {first}: loss {float(losses['loss']):.5g} "
        f"in {secs:.2f} s; {len(new)} new parameters, those without a "
        f"finite nonzero gradient: {bad}")
    assert not bad, bad
    runs[first]["train_step_s"] = secs
    res["options"] = runs


def zoo_small(torch, mt, cfg_mod, np, sparse, res):
    """(c): card (kernels) against CPU (plain versions) at a small width:
    a shallow bottleneck (every LAYERS entry 1) on fp32 `dense` in phase
    4's fp32 form (FP32_PATH_TOL on the maps' max |diff| and the outputs'
    99.9% quantile; phase 3's reading printed) and the first decoder
    combination within phase 3's tolerance; the shallow
    bottleneck's backbone maps on bf16 `dense` (bucket 512) within the
    bf16 stack's BF16_STACK_MEAN (phase 5) and on `gather_pallas` (bucket
    1024, levels 0 and 1 on the kernel) within phase 4's bf16 bounds (the
    bf16 paths' gate: see (a)); the level
    embedding skipped in round 2 on the card only must fail phase 3's
    gate."""
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
    from mask3d_tpu_torch.models import backbone as bb_mod
    from mask3d_tpu_torch.models.mask3d import Mask3D

    def worst(cfg, host, cpu_model, gpu_model):
        ref, _ = mt.infer(cpu_model, host.device, cfg, aux_masks=True,
                          device="cpu")
        got, _ = mt.infer(gpu_model, host.device, cfg, aux_masks=True,
                          device="cuda")
        return max(float((g.cpu() - r).abs().max()) / max(1.0, float(
            r.std())) for r, g in ((ref.aux_pred_class, got.aux_pred_class),
                                   (ref.aux_pred_masks, got.aux_pred_masks)))

    name = "Res16UNet50_shallow"
    bb_mod.BACKBONES[name] = type(name, (bb_mod.BACKBONES["Res16UNet50"],),
                                  dict(LAYERS=(1,) * 8))
    try:
        models = small_models(mt, cfg_mod, make_synthetic_scene, np,
                              "dense", 512, backbone=name)
        res["small_bottleneck"] = worst(*models)
        # phase 4's fp32 form as the gate (the same function in another
        # summation order: max |diff| of the maps, the 99.9% quantile of
        # the outputs, within FP32_PATH_TOL): on an NVIDIA H100 it read
        # 1.06e-4 on the outputs' max against phase 3's 1e-4, a gate that
        # has read 1.24e-4 on Res16UNet14A too (ROADMAP.md Queue 3)
        c, host, cpu_model, gpu_model = models
        ref, _ = mt.infer(cpu_model, host.device, c, device="cpu")
        got, _ = mt.infer(gpu_model, host.device, c, device="cuda")
        stats = {w: diff_stats(np, getattr(ref, w).numpy(),
                               getattr(got, w).cpu().numpy())
                 for w in ("pred_class", "pred_masks")}
        for i, (r, g) in enumerate(zip(
                backbone_maps(torch, cpu_model, c, host.device, sparse),
                backbone_maps(torch, gpu_model, c, host.device.to("cuda"),
                              sparse))):
            stats[f"map{i}"] = diff_stats(np, r, g)
        res["small_bottleneck_fp32_gate"] = gate_ratio("gather", stats)
        log(f"model_zoo small shallow bottleneck fp32, card vs CPU: "
            f"{json.dumps(stats)}; phase 4's fp32 gate ratio "
            f"{res['small_bottleneck_fp32_gate']:.4g} (passes at <= 1)")
        res["small_bottleneck_bf16_maps"] = {}
        for path, impl, bucket, extra in (
                ("bf16", "dense", 512, ["model.compute_dtype=bfloat16"]),
                ("gather_pallas", "gather_pallas", 1024, [])):
            c, host, cpu_model, gpu_model = small_models(
                mt, cfg_mod, make_synthetic_scene, np, impl, bucket,
                backbone=name, extra=extra)
            ref = backbone_maps(torch, cpu_model, c, host.device, sparse)
            got = backbone_maps(torch, gpu_model, c, host.device.to("cuda"),
                                sparse)
            maps = [diff_stats(np, r, g) for r, g in zip(ref, got)]
            # each path's own bf16 tolerance: the bf16 stack's mean (phase
            # 5; every grid stored in bf16), the bf16 gather conv's bounds
            # (phase 4's small-width check; conv inputs rounded only)
            if path == "bf16":
                ratio = worst_ratio(dict(enumerate(maps)), "mean",
                                    BF16_STACK_MEAN)
                ok = ratio <= 1.0
                gate = f"ratio to the {BF16_STACK_MEAN} mean {ratio:.4g}"
            else:
                ok = all(within_bf16_bounds(st) for st in maps)
                gate = f"bounds {BF16_BOUNDS}"
            log(f"model_zoo small shallow bottleneck {path}, card vs CPU, "
                f"backbone maps: {json.dumps(maps)} ({gate}, passes {ok})")
            res["small_bottleneck_bf16_maps"][path] = maps
            res.setdefault("small_bf16_ok", {})[path] = ok
    finally:
        del bb_mod.BACKBONES[name]
    first = next(iter(ZOO_COMBOS.values()))
    models = small_models(mt, cfg_mod, make_synthetic_scene, np, "dense",
                          512, extra=first)
    res["small_options"] = worst(*models)
    gpu_model = models[3]
    real = Mask3D._squeezed

    def no_embed_in_round_2(self, key, li, feats):
        if self is gpu_model and key.startswith("1_"):
            return self.squeeze[key](feats)
        return real(self, key, li, feats)

    Mask3D._squeezed = no_embed_in_round_2
    try:
        res["small_options_fault"] = worst(*models)
    finally:
        Mask3D._squeezed = real
    log(f"model_zoo small width, card vs CPU max|diff|/max(1,std): shallow "
        f"bottleneck {res['small_bottleneck']:.3g} (printed; gated in "
        f"phase 4's form above), first decoder combination "
        f"{res['small_options']:.3g} (tol 1e-4); planted fault (level "
        f"embedding skipped in round 2 on the card) "
        f"{res['small_options_fault']:.3g} (must be > 1e-4)")
    assert res["small_bottleneck_fp32_gate"] <= 1.0 and \
        res["small_options"] <= 1e-4, res
    assert res["small_options_fault"] > 1e-4, res
    assert all(res["small_bf16_ok"].values()), res["small_bf16_ok"]


def zoo_cli(torch, np, mt, counters, card, res):
    """(d): `cli test` on the card with Res16UNet50, learned queries and a
    set of decoder layers a round, one batch of written test scenes: the
    metric keys, the launches around the call, seconds by layer."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = os.path.join(tmp, "data")
        write_entry_dataset(np, root, n_test=ENTRY_BATCH)
        run = cli_test_recorded(torch, counters, [
            "--device", "cuda", f"data.data_root={root}",
            f"data.test_batch_size={ENTRY_BATCH}",
            f"general.save_dir={tmp}/saved", *ZOO_CLI])
    assert run["rc"] == 0, run["rc"]
    metrics = run["seen"]["metrics"]
    assert set(metrics) == entry_metric_keys("test"), sorted(metrics)
    assert run["launches"]["masked_attention"] == 12 and \
        run["launches"]["row_gather"] == 13 and \
        run["launches"]["lsap"] == 1, run["launches"]
    per_batch, _, _ = entry_batch_seconds(torch, mt, run, "native")
    log(f"model_zoo cli test {' '.join(ZOO_CLI)}: {run['secs']:.2f} s, "
        f"launches {run['launches']}, peak {run['peak']:.2f} GiB; metric "
        f"keys {sorted(metrics)}; seconds a batch {json.dumps(per_batch)} "
        f"on {card}")
    res["cli"] = dict(secs=run["secs"], launches=run["launches"],
                      peak_gib=run["peak"], per_batch=per_batch)


def run_model_zoo(torch, np, mt, cfg_mod, counters, by_key, card, host,
                  kmods, sparse):
    """Phase 16 (see the module docstring); returns its numbers."""
    rg, sc, dense_ops = kmods
    res = {}
    t = time.perf_counter()
    shapes = zoo_full_width(torch, np, mt, cfg_mod, counters, by_key, card,
                            host, sparse, res)
    zoo_kernels(torch, rg, sc, dense_ops, host, cfg_mod, sparse, shapes,
                res)
    res["seconds"] = {"a": time.perf_counter() - t}
    failed = []
    for part, fn in (("b", lambda: zoo_options(torch, mt, cfg_mod, counters,
                                                by_key, card, host, res)),
                     ("c", lambda: zoo_small(torch, mt, cfg_mod, np, sparse,
                                             res)),
                     ("d", lambda: zoo_cli(torch, np, mt, counters, card,
                                           res))):
        t = time.perf_counter()
        try:
            fn()
        except Exception:
            # the other parts still run; the phase fails below
            failed.append(part)
            log(f"model_zoo ({part}) failed\n{traceback.format_exc()}",
                file=sys.stderr)
        res["seconds"][part] = time.perf_counter() - t
    log(f"model_zoo seconds by part: {json.dumps(res['seconds'])}")
    assert not failed, f"model_zoo parts failed: {failed}"
    return res


def matrix_int8_shapes(torch, ic, sb, shape_launches, res):
    """(a) The int8 conv kernel against its plain version at every (grid,
    Cin, Cout, k) the counted Res16UNet101 `int8` forward launched, on the
    batch's occupancy at that grid: outputs bitwise, a second launch
    bitwise; each timed by graph replay beside its bound (operations of the
    occupied outputs, or bytes), the plain version (one call) and, for a
    1x1, `torch._int_mm` (cuBLAS's int8 product of the same integers over
    every cell of the grid, without the requant: the library yardstick)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    level_of = {tuple(o.shape[1:4]): li for li, o in enumerate(sb.occ)}
    rows = []
    for (dims, cin, cout, k, step), n_launch in sorted(
            shape_launches.items(), key=lambda kv: kv[0][:4]):
        occ = sb.occ[level_of[dims]]
        args, kw = int8_inputs(torch, gen, occ, cin, cout, k, step)
        got = ic.int8_conv(*args, **kw)
        again = ic.int8_conv(*args, **kw)
        ref = ic.int8_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        equal = torch.equal(got.out, ref.out)
        repeat = torch.equal(got.out, again.out)
        p = ic.plan(occ.shape[0], dims, cin, cout, k)
        cells = occ[..., 0].numel()
        occupied = int(occ.sum().item())
        nbytes = cells * (cin + 4 + 2 * cout) + k ** 3 * cin * cout
        row = dict(
            step=step, grid=list(dims), Cin=cin, Cout=cout, k=k,
            launches=n_launch, cells=cells, occupied=occupied, equal=equal,
            repeat_equal=repeat,
            max_abs_err=float((got.out.float() - ref.out.float()).abs()
                              .max()),
            plan=dict(tile=p.tile, groups=p.groups, splits=p.splits,
                      kcs=p.kcs, mf=p.mf, smem=p.smem),
            ms=time_graph_ms(torch, lambda: ic.int8_conv(*args, **kw)),
            plain_ms=time_ms(torch, lambda: ic.int8_conv_plain(*args, **kw),
                             iters=1, warmup=0),
            library_ms=None)
        if k == 1:
            a = args[0].reshape(cells, cin)
            b = args[2][0].contiguous()
            try:
                row["library_ms"] = time_ms(torch,
                                            lambda: torch._int_mm(a, b))
            except RuntimeError as e:  # printed; the row keeps null
                log(f"config_matrix torch._int_mm {cin}->{cout}: {e}")
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * k ** 3 * cin * cout * occupied, INT8_OPS_PER_S)
        log(f"config_matrix int8_conv {list(dims)} {cin}->{cout} k{k} "
            f"x{n_launch}: bitwise {equal}, repeat {repeat}; plan "
            f"{row['plan']}; kernel {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.2f} ms, torch._int_mm "
            f"{row['library_ms'] if k == 1 else None}")
        rows.append(row)
        del args, kw, got, again, ref
    res["int8_shapes"] = rows
    assert all(r["equal"] and r["repeat_equal"] for r in rows), [
        (r["grid"], r["Cin"], r["Cout"], r["k"]) for r in rows
        if not (r["equal"] and r["repeat_equal"])]
    return rows


def matrix_full_width(torch, np, mt, cfg_mod, counters, by_key, card, host,
                      ic, res):
    """(a) Res16UNet101 at full width on `dense` with `int8` and
    `int8_chain` (`profile_forward.CONFIGS`) on phase 3's 8 scenes, one set
    of seeded weights: counted (12 attention, 13 row gathers, the int8
    convs by shape), timed (median of MATRIX_REPS), peak GiB; int8_chain
    runs the unfused int8 blocks on a bottleneck (bitwise `int8`'s, no
    chain step); the int8 outputs' distance from bf16 on the same weights
    printed. Returns the int8 launches by shape and the batch's sparse
    batch."""
    from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
    from mask3d_tpu_torch.profile_forward import CONFIGS
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    dev = host.device
    runs, outs = {}, {}
    c = zoo_cfg(cfg_mod, CONFIGS["int8"])
    mdl = mt.build_model(c, device="cuda", seed=0)
    shapes = None
    for path in MATRIX_PATHS:
        mdl.backbone.pallas_chain = path == "int8_chain"
        ic.int8_conv.launches_by_shape.clear()
        ic.int8_conv.launches_by_step.clear()
        (out, overflow), launches, keyed, peak = counted(
            torch, counters, by_key,
            lambda: mt.infer(mdl, dev, c, device="cuda"))
        assert not bool(overflow), path
        by_shape = dict(ic.int8_conv.launches_by_shape)
        steps = dict(ic.int8_conv.launches_by_step)
        assert set(steps) == {"conv"}, steps  # no fused chain step
        assert launches["masked_attention"] == 12 and \
            launches["row_gather"] == 13 and launches["int8_conv"] == \
            sum(by_shape.values()) > 0, launches
        ms = []
        for _ in range(MATRIX_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(mdl, dev, c, device="cuda")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        outs[path] = (out.pred_class.float(), out.pred_masks.float())
        wide = sum(n for (_, _, co, _, _), n in by_shape.items() if co > 384)
        runs[path] = dict(launches=launches, int8_launches=steps["conv"],
                          int8_launches_past_384=wide, peak_gib=peak,
                          ms=statistics.median(ms), ms_all=ms)
        log(f"config_matrix {MATRIX_BACKBONE} {path} batch 8: launches "
            f"{launches} ({wide} int8 convs past 384 outputs, "
            f"{len(by_shape)} shapes); forward median "
            f"{runs[path]['ms']:.2f} ms over {MATRIX_REPS} "
            f"({[round(x, 2) for x in ms]}), peak {peak:.2f} GiB on {card}")
        if shapes is None:
            shapes = {(d, ci, co, k, s): n
                      for (d, ci, co, k, s), n in by_shape.items()}
    mdl.backbone.pallas_chain = False
    same = all(torch.equal(a, b) for a, b in zip(outs["int8"],
                                                 outs["int8_chain"]))
    assert same, "int8_chain on a bottleneck is not the unfused int8 blocks"
    # the int8 distance from bf16 on the same weights (printed)
    mdl.backbone.int8_stride1 = False
    with torch.inference_mode():
        ref, _ = mt.infer(mdl, dev, c, device="cuda")
    valid = (torch.arange(dev.capacity, device="cuda")[None]
             < dev.counts[:, None])
    stats = {"pred_class": card_diff_stats(torch, ref.pred_class,
                                           outs["int8"][0]),
             "pred_masks": card_diff_stats(torch, ref.pred_masks[valid],
                                           outs["int8"][1][valid])}
    ratio = worst_ratio(stats, "mean", INT8_PATH_MEAN)
    log(f"config_matrix {MATRIX_BACKBONE} int8 vs bf16 on the same weights "
        f"(printed, not gated: random-weight noise grows with depth): "
        f"{json.dumps(stats)}; ratio to INT8_PATH_MEAN {ratio:.4g}")
    runs["int8_vs_bf16"] = dict(stats=stats, ratio=ratio)
    res["full_width"] = runs
    res["int8_chain_bitwise_int8"] = same
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(c, dev.capacity),
                            dev.grid_dims, **_sb_kwargs(c))
    del mdl, ref, outs
    torch.cuda.empty_cache()
    return shapes, sb


def matrix_small(torch, np, mt, cfg_mod, res):
    """(a) Card (kernels) against CPU (plain versions) on a shallow
    bottleneck whose planes reach 96-128 (MATRIX_SMALL: stage 8 of two
    blocks, a 384-channel QGrid junction at level 0) with the `int8`
    stack at a small width, bucket 1024: the backbone maps' and outputs'
    mean |diff| within INT8_PATH_MEAN x max(1, std)."""
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
    from mask3d_tpu_torch.models import backbone as bb_mod
    from mask3d_tpu_torch.profile_forward import CONFIGS

    name, (base, attrs) = MATRIX_SMALL
    bb_mod.BACKBONES[name] = type(name, (bb_mod.BACKBONES[base],), attrs)
    try:
        c, host_s, cpu_model, gpu_model = small_models(
            mt, cfg_mod, make_synthetic_scene, np, "dense", 1024, name,
            CONFIGS["int8"])
        with torch.inference_mode():
            ref, _ = mt.infer(cpu_model, host_s.device, c, device="cpu")
            got, _ = mt.infer(gpu_model, host_s.device, c, device="cuda")
        stats = {w: diff_stats(np, getattr(ref, w).numpy(),
                               getattr(got, w).cpu().numpy())
                 for w in ("pred_class", "pred_masks")}
        from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
        from mask3d_tpu_torch.sparse.context import build_sparse_batch

        sparse = (build_sparse_batch, level_capacities, _sb_kwargs)
        for i, (r, g) in enumerate(zip(
                backbone_maps(torch, cpu_model, c, host_s.device, sparse),
                backbone_maps(torch, gpu_model, c, host_s.device.to("cuda"),
                              sparse))):
            stats[f"map{i}"] = diff_stats(np, r, g)
    finally:
        del bb_mod.BACKBONES[name]
    ratio = worst_ratio(stats, "mean", INT8_PATH_MEAN)
    log(f"config_matrix small bottleneck int8, card vs CPU: "
        f"{json.dumps(stats)}; ratio to INT8_PATH_MEAN {ratio:.4g} (passes "
        f"at <= 1)")
    res["small_int8"] = dict(stats=stats, ratio=ratio)
    assert ratio <= 1.0, ratio


def matrix_attention(torch, ma, res):
    """(b) The attention kernel's partial form at the flagship's key
    lengths, split into two ranks' halves: each half against the plain
    partial form (out and sum within ATTN_TOL relative, the max within
    1e-5 relative), timed by graph replay beside its bound and the plain
    form; the two combined against the plain one-shot attention within
    ATTN_TOL; a combine that reads rank 0's max for both ranks (a planted
    fault) must miss it."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, nq, d, h = 8, 25, 128, 8
    rows = []
    for s in ATTN_S:
        q = torch.randn(b, nq, d, device="cuda", generator=gen)
        k = torch.randn(b, s, d, device="cuda", generator=gen)
        v = torch.randn(b, s, d, device="cuda", generator=gen)
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        mask |= torch.arange(s, device="cuda")[None, None] >= s - s // 8
        mask[0, 0] = True  # blocked everywhere: uniform weights
        mask[1, 2, :s // 2] = True  # blocked on rank 0's half
        ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
        halves = [(k[:, a:z].contiguous(), v[:, a:z].contiguous(),
                   mask[:, :, a:z].contiguous())
                  for a, z in ((0, s // 2), (s // 2, s))]
        parts, errs = [], []
        for kk, vv, mm in halves:
            got = ma.masked_cross_attention_partial(q, kk, vv, mm, h)
            want = ma.masked_cross_attention_partial_plain(q, kk, vv, mm, h)
            errs.append(max(float(((g - w).abs() / w.abs().clamp_min(1))
                                  .max()) for g, w in zip(got, want)))
            parts.append(got)
        outs, maxes, sums = zip(*parts)
        comb = ma.combine_partial_softmax(outs, maxes, sums, h)
        bad = ma.combine_partial_softmax(outs, [maxes[0]] * 2, sums, h)
        torch.cuda.synchronize()
        err = float((comb - ref).abs().max())
        fault = float((bad - ref).abs().max())
        kk, vv, mm = halves[0]
        half = s // 2
        row = dict(
            S=s, S_rank=half, B=b, max_abs_err=err, partial_rel_err=errs,
            fault_err=fault,
            ms=time_graph_ms(torch, lambda: ma.masked_cross_attention_partial(
                q, kk, vv, mm, h)),
            plain_ms=time_ms(torch, lambda: ma
                             .masked_cross_attention_partial_plain(
                                 q, kk, vv, mm, h), iters=5),
            combine_ms=time_ms(torch, lambda: ma.combine_partial_softmax(
                outs, maxes, sums, h)),
            library_ms=None)
        nbytes = 4 * (b * nq * d + 2 * b * half * d + b * nq * d
                      + 2 * b * h * nq) + b * nq * half
        row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                 4 * b * nq * half * d)
        log(f"config_matrix attention partial form, S={s} as two halves: "
            f"partial vs plain rel err {errs}, combined vs one-shot "
            f"{err:.3g} (tol {ATTN_TOL}); planted fault (rank 0's max for "
            f"both) {fault:.3g}; partial kernel {row['ms']:.4f} ms a half "
            f"(bound {row['bound_ms']:.4f} ms, {row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, combine {row['combine_ms']:.4f} ms")
        rows.append(row)
        assert err <= ATTN_TOL and max(errs) <= ATTN_TOL, row
        assert fault > ATTN_TOL, row
        del q, k, v, mask, halves, parts
    res["attention_partial"] = rows
    return rows


def matrix_rank_work(torch, np, rank, world, work_dir):
    """(b) on one spawned gloo rank of `world` sharing the card: the sp=2
    eval forwards of MATRIX_SP against the one-process outputs the parent
    saved (JAX's sharded bounds, `par_excess`), counted, timed, with each
    forward's collective bytes; the planted gate fault; `Config()` on
    `dense` once more in train mode, for its rows' bytes and what an
    all-reduce of them whole would carry; and a slab's int8 conv against
    the whole
    grid's (bitwise), and with the absmax not reduced over sp (a planted
    fault)."""
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch import config as cfg_mod
    from mask3d_tpu_torch.models import backbone as bb_mod
    from mask3d_tpu_torch.parallel import comm, make_mesh_2d, use_mesh
    from mask3d_tpu_torch.parallel.mesh import slab_plan
    from mask3d_tpu_torch.profile_forward import CONFIGS, flagship_items
    from mask3d_tpu_torch.sparse import int8_ops

    counters, _ = kernel_counters()
    register_matrix_backbones(bb_mod)
    items = flagship_items()
    mesh = make_mesh_2d(1, world)
    out = {}

    def forward(model, dev, c, ref):
        comm.reset_bytes()
        for fn in counters.values():
            fn.launches = 0
        ma_fn = counters["masked_attention"]
        ma_fn.partial_by_shape.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with use_mesh(mesh):
            o, _ = mt.infer(model, dev, c, device="cuda")
        torch.cuda.synchronize()
        res = dict(
            seconds=time.perf_counter() - t,
            launches={k: fn.launches for k, fn in counters.items()},
            partial_by_s=dict(ma_fn.partial_by_shape),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            bytes=dict(comm.BYTES))
        got = (o.pred_class.cpu().numpy(), o.pred_masks.cpu().numpy())
        res["gates"] = par_excess(np, ref, got)
        res["stats"] = {w: diff_stats(np, r, g) for w, r, g in zip(
            ("pred_class", "pred_masks"), ref, got)}
        return res

    def train_mode_rows(model, dev, c):
        """The collective bytes of a train-mode forward (sampled memories
        from a seeded generator), whose decoder's rows are chunks as at
        inference, and `whole_rows`: what an all-reduce of the rows that
        its reduce-scatters split would carry."""
        comm.reset_bytes()
        payload, whole = whole_row_payload(comm)
        model.train()
        try:
            with use_mesh(mesh), payload:
                mt.infer(model, dev, c, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
        finally:
            model.eval()
        return dict(bytes=dict(comm.BYTES), whole_rows=whole[0])

    for name, (path, extra, n_items) in MATRIX_SP.items():
        c = zoo_cfg(cfg_mod, CONFIGS[path] + extra + ["model.sp_axis=sp"],
                    backbone=MATRIX_SP_BACKBONE.get(name, "Res16UNet34C"))
        dev = mt.collate(items[:n_items], device="cuda",
                         point_bucket_multiple=BUCKET).device
        model = mt.build_model(c, device="cuda", seed=0)
        ref = np.load(os.path.join(work_dir, f"{name}.npz"))
        ref = (ref["pred_class"], ref["pred_masks"])
        if name == "dense":
            forward(model, dev, c, ref)  # warm-up: the first forward
            out["dense_train_mode"] = train_mode_rows(model, dev, c)
        out[name] = forward(model, dev, c, ref)
        if name == "bottleneck_se_fp32":
            # planted: `_DenseCtx`'s mean over the slab's cells, not summed
            # over sp
            with PatchAttr(bb_mod._SlabCtx, "global_mean",
                           bb_mod._DenseCtx.global_mean):
                out["fault_slab_se_mean"] = forward(model, dev, c, ref)
        del model, dev
        torch.cuda.empty_cache()
    # a slab's int8 conv (dynamic scales) against the whole grid's
    gen = torch.Generator(device="cuda").manual_seed(2)
    grid = (112, 80, 40)
    occ = (torch.rand((2, *grid, 1), generator=gen, device="cuda")
           < 0.11).float()
    x = (torch.randn((2, *grid, 256), generator=gen, device="cuda")
         * occ).bfloat16()
    conv = bb_mod.Conv(3, 256, 256).cuda()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device="cuda") * 0.02)
    with use_mesh(mesh), torch.inference_mode():
        s = slab_plan([grid], "sp")[0]
        sb = type("SB", (), {"occ": [occ], "levels": [None]})()
        ctx = bb_mod._SlabCtx(sb, [grid], [s], s.group, torch.bfloat16,
                              int8_stride1=True)
        whole = int8_ops.dense_conv_same_int8(x, conv.weight, occ)
        got = ctx.conv3(x[:, s.x0:s.x1].contiguous(), conv, 0)
        with PatchAttr(bb_mod._SlabCtx, "_absmax",
                       lambda self, x_, s_: x_.float().abs().amax(
                           dim=(0, 1, 2, 3))):
            bad = ctx.conv3(x[:, s.x0:s.x1].contiguous(), conv, 0)
    want = whole[:, s.x0:s.x1]
    out["slab_int8"] = dict(
        bitwise=bool(torch.equal(got, want)),
        fault_max_abs_diff=float((bad.float() - want.float()).abs().max()))
    return out


def register_matrix_backbones(bb_mod):
    """The phase's test backbones in the port's `BACKBONES`."""
    for name, (base, attrs) in MATRIX_BACKBONES.items():
        if name not in bb_mod.BACKBONES:
            bb_mod.BACKBONES[name] = type(name, (bb_mod.BACKBONES[base],),
                                          dict(attrs))


def matrix_sp(torch, np, mt, cfg_mod, card, res):
    """(b) Two gloo ranks sharing the card (`matrix_rank_work`) against
    one-process forwards on the same weights, computed here first."""
    import shutil
    import tempfile

    from mask3d_tpu_torch.models import backbone as bb_mod
    from mask3d_tpu_torch.profile_forward import CONFIGS, flagship_items

    register_matrix_backbones(bb_mod)
    torch.cuda.empty_cache()  # the ranks share the card
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    work = tempfile.mkdtemp(dir=build)
    items = flagship_items()
    try:
        for name, (path, extra, n_items) in MATRIX_SP.items():
            c = zoo_cfg(cfg_mod, CONFIGS[path] + extra,
                        backbone=MATRIX_SP_BACKBONE.get(name, "Res16UNet34C"))
            dev = mt.collate(items[:n_items], device="cuda",
                             point_bucket_multiple=BUCKET).device
            model = mt.build_model(c, device="cuda", seed=0)
            with torch.inference_mode():
                o, _ = mt.infer(model, dev, c, device="cuda")
            np.savez(os.path.join(work, f"{name}.npz"),
                     pred_class=o.pred_class.cpu().numpy(),
                     pred_masks=o.pred_masks.cpu().numpy())
            del model, dev, o
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ranks = run_ranks(torch, work, "matrix_rank_work")
        res["ranks_seconds"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r, got in enumerate(ranks):
        for tag, v in got.items():
            log(f"config_matrix rank {r} {tag}: {json.dumps(v)} on {card}")
    rows_keys = ("rows", "attention_partials", "minmax", "unblock",
                 "out_masks", "np_features")
    summary = {}
    for r, got in enumerate(ranks):
        excess = {}
        for name, v in got.items():
            if name in ("slab_int8", "dense_train_mode"):
                continue
            excess[name] = max(g["excess"] for g in v["gates"].values())
            if name.startswith("fault_"):
                assert excess[name] > 0, (r, name, v["gates"])
            else:
                assert excess[name] <= 0, (r, name, v["gates"])
            assert v["launches"]["masked_attention"] == 12, (r, name, v)
            # the decoder over row chunks: every launch the partial form
            assert sum(v["partial_by_s"].values()) == 12, (r, name, v)
        sharded = sum(got["dense"]["bytes"].get(k, 0) for k in rows_keys)
        whole = got["dense_train_mode"]["whole_rows"]
        assert got["dense_train_mode"]["bytes"]["rows"] == \
            got["dense"]["bytes"]["rows"], got["dense_train_mode"]
        summary[r] = dict(rows_bytes_sharded=sharded,
                          rows_bytes_whole=whole, excess=excess,
                          peak_gib={n: v["peak_gib"] for n, v in got.items()
                                    if "peak_gib" in v},
                          slab_int8=got["slab_int8"])
        assert got["slab_int8"]["bitwise"], got["slab_int8"]
        assert got["slab_int8"]["fault_max_abs_diff"] > 0, got["slab_int8"]
        assert sharded < whole, (sharded, whole)
    log(f"config_matrix (b) by rank: {json.dumps(summary)} (excess: the "
        f"worst of each forward over JAX's sharded bounds, passing at <= 0, "
        f"the planted faults' > 0; the decoder's row bytes of a Config() "
        f"forward on dense at sp=2, this rank's payload: row chunks against "
        f"an all-reduce of the same rows whole, the inputs of a train-mode "
        f"forward's reduce-scatters, which move the eval forward's rows) "
        f"on {card}")
    res["sp"] = ranks
    res["sp_summary"] = summary


def run_config_matrix(torch, np, mt, cfg_mod, counters, by_key, card, host,
                      ic, ma):
    """Phase 17 (see the module docstring); returns its numbers."""
    res = {"seconds": {}}
    failed = []
    t = time.perf_counter()
    shapes, sb = matrix_full_width(torch, np, mt, cfg_mod, counters, by_key,
                                   card, host, ic, res)
    for part, fn in (
            ("a_shapes", lambda: matrix_int8_shapes(torch, ic, sb, shapes,
                                                    res)),
            ("a_small", lambda: matrix_small(torch, np, mt, cfg_mod, res)),
            ("b_attention", lambda: matrix_attention(torch, ma, res)),
            ("b_ranks", lambda: matrix_sp(torch, np, mt, cfg_mod, card,
                                          res))):
        try:
            fn()
        except Exception:
            failed.append(part)
            log(f"config_matrix ({part}) failed\n{traceback.format_exc()}",
                file=sys.stderr)
        res["seconds"][part] = time.perf_counter() - t
        t = time.perf_counter()
    log(f"config_matrix seconds by part: {json.dumps(res['seconds'])}")
    assert not failed, f"config_matrix parts failed: {failed}"
    return res


def run_rehearsal(torch, np, counters, card):
    """Phase 18 (the module docstring): the rehearsal at full width, then
    the data-scale launcher and the recertification on a small written
    dataset."""
    import tempfile

    from mask3d_tpu_torch import recert_int8, train_datascale
    from mask3d_tpu_torch import train_rehearsal as reh

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mask3d_tpu_torch", "_build")
    out = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        # (a) the rehearsal, counted around the whole fit
        for fn in counters.values():
            fn.launches = 0
        # what earlier phases still hold: the rehearsal's own peak is the
        # card's peak less this
        held = torch.cuda.memory_allocated() / 2**30
        t = time.perf_counter()
        try:
            res = reh.main(REHEARSAL_EPOCHS, fresh=True,
                           save_dir=os.path.join(tmp, "rehearsal"),
                           extra=["trainer.check_val_every_n_epoch=1"],
                           device="cuda")
        except reh.RehearsalFailed as e:
            res = e.results
        wall = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        gates = res["gates"]
        planted = reh.restore_check(res["trainer"], res["cfg"],
                                    res["datasets"], "cuda", plant=True)
        out["rehearsal"] = dict(
            epochs=REHEARSAL_EPOCHS, steps=res["steps"],
            step_s=res["step_s"],
            step_s_median=statistics.median(res["step_s"]),
            steps_per_s=res["steps_per_s"],
            peak_gib_own=res["peak_gib"] - held,
            peak_gib_with_earlier_phases=res["peak_gib"],
            wall_s=wall, launches=launches, mixture=res["mixture"],
            train_loss=res["train_loss"],
            val_mean_ap_50=res["val_mean_ap_50"], gates=gates,
            planted_one_ulp_first_mismatch=planted)
        log(f"rehearsal (Config(), 48/8/8 scenes, batch 16 as 8 x 2, "
            f"{REHEARSAL_EPOCHS} epoch + validation): "
            f"{json.dumps(out['rehearsal'])} on {card}")
        del res
        ok = (gates["restore"]["ok"] and planted is not None
              and all(launches[k] > 0 for k in ("masked_attention",
                                                "row_gather", "lsap")))

        # (b) a written dataset -> the data-scale launcher for one epoch
        # -> the recertification on its checkpoint
        root = os.path.join(tmp, "data")
        saved = os.path.join(tmp, "saved")
        t = time.perf_counter()
        rc = train_datascale.main(
            1, root=root, run_id="smoke", device="cuda",
            extra=[f"general.save_dir={saved}"], sizes=DATASCALE_SIZES)
        train_s = time.perf_counter() - t
        ckpt_path = os.path.join(saved, train_datascale.EXPERIMENT_NAME,
                                 "smoke", "last-epoch.ckpt")
        for fn in counters.values():
            fn.launches = 0
        counted = {}
        real = recert_int8.run_variant

        def counted_variant(name, *a, **k):
            before = {n: fn.launches for n, fn in counters.items()}
            m = real(name, *a, **k)
            counted[name] = {n: fn.launches - before[n]
                             for n, fn in counters.items()}
            return m

        recert_int8.run_variant = counted_variant
        t = time.perf_counter()
        try:
            rec = recert_int8.main(ckpt_path, root, device="cuda",
                                   extra=[f"general.save_dir={saved}"])
        finally:
            recert_int8.run_variant = real
        recert_s = time.perf_counter() - t
        maps = {n: recert_int8.map_values(m) for n, m in rec["runs"].items()}
        out["datascale"] = dict(rc=rc, seconds=train_s,
                                sizes=list(DATASCALE_SIZES),
                                grid=list(rec["grid"]))
        out["recert"] = dict(seconds=recert_s, maps=maps, lines=rec["lines"],
                             ok=rec["ok"], launches=counted)
        log(f"train_datascale 1 epoch on {DATASCALE_SIZES[:3]} written "
            f"scenes: rc {rc}, {train_s:.1f} s; recert_int8 on its "
            f"last-epoch.ckpt ({recert_s:.1f} s, launches by variant "
            f"{counted}):")
        for line in rec["lines"]:
            log(f"  {line}")
        ok = ok and rc == 0 and len(maps) == 3 and all(
            len(m) == 3 and all(np.isfinite(v) for v in m.values())
            for m in maps.values()) and counted["int8"]["int8_conv"] > 0 \
            and counted["fp32"]["int8_conv"] == 0
    out["launches"] = out["rehearsal"]["launches"] | {
        "int8_conv": out["recert"]["launches"]["int8"]["int8_conv"]}
    if not ok:
        raise AssertionError(f"rehearsal phase: {json.dumps(out)}")
    return out


def plant_backbone_noise(torch, mdl, sigma, seed=0):
    """Add N(0, sigma) to every nonzero value the backbone returns (its
    output rows, its five maps and its level-0 grid; padding rows and empty
    cells stay zero), the same draw at every call."""
    real = mdl.backbone.forward

    def noisy(*a, **k):
        out, maps, grid = real(*a, **k)
        gen = torch.Generator(device=out.device).manual_seed(seed)

        def add(x):
            if x is None:
                return None
            e = torch.randn(x.shape, generator=gen, device=x.device)
            return x + (sigma * e * (x != 0)).to(x.dtype)

        return add(out), [add(m) for m in maps], add(grid)

    mdl.backbone.forward = noisy


def record_decoder_inputs(mdl):
    """Forward pre-hooks on the decoder's cross-attention layers: per call,
    in order, its memory mask (True blocks a row), its query positions
    and, in the first round, its keys (memory + positional encoding,
    projected). Returns (calls, hook handles)."""
    calls, first = [], len(mdl.hlevels)

    def hook(_mod, args):
        _, mask, pos, kvp = args[:4]
        calls.append(dict(mask=mask.clone(), pos=pos.float().clone(),
                          k=kvp[0].float().clone() if len(calls) < first
                          else None))

    return calls, [m.register_forward_pre_hook(hook)
                   for m in mdl.cross.values()]


def decoder_input_diffs(ref, got):
    """Per cross-attention call of `record_decoder_inputs`: how many of the
    memory mask's entries differ (and how many block in `ref`), the queries
    whose mask blocks every key in `ref` and in `got` (the all-blocked
    rule counts the padding rows, whose pooled mask features the dense
    path reads off its grids and the gather paths hold at 0), the query
    positions' max |diff| and, in the first round, the keys'."""
    rows = []
    for a, b in zip(ref, got):
        row = dict(flips=int((a["mask"] != b["mask"]).sum()),
                   blocked=int(a["mask"].sum()), entries=a["mask"].numel(),
                   keyless_ref=int(a["mask"].all(-1).sum()),
                   keyless=int(b["mask"].all(-1).sum()),
                   pos_max=float((a["pos"] - b["pos"]).abs().max()))
        if a["k"] is not None:
            row["k_max"] = float((a["k"] - b["k"]).abs().max())
        rows.append(row)
    return rows


def run_trained_gates(ckpt_path):
    """`--trained <checkpoint>`: phases 4 and 5's gates (PATH_GATES) at full
    width (`Config()`) on the checkpoint's weights, printed beside their
    limits, and two witnesses of what the decoder does with the paths'
    differences: each level's keys, coordinates and valid rows on the dense
    and the gather paths' sparse batches, and the dense forward with noise
    of the size of fp32 `gather`'s map differences planted in the
    backbone's outputs; each run's cross-attention masks, query positions
    and first-round keys against the dense forward's. Returns the exit
    code (0 where every gate held)."""
    import numpy as np
    import torch

    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch import config as cfg_mod
    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
    from mask3d_tpu_torch.models import backbone as bb_mod
    from mask3d_tpu_torch.profile_forward import CONFIGS, flagship_items
    from mask3d_tpu_torch.sparse.context import build_sparse_batch
    from mask3d_tpu_torch.train import checkpoint as ckpt
    from mask3d_tpu_torch.train.loop import configure_torch

    configure_torch(True)
    log(f"card: {card_line()}; trained-weight gates on {ckpt_path}")
    log(f"built {', '.join(cuda_build.KERNELS)} in {cuda_build.build():.2f} s")
    sparse = (build_sparse_batch, level_capacities, _sb_kwargs)
    dev = mt.collate(flagship_items(), device="cuda",
                     point_bucket_multiple=BUCKET).device
    counts = dev.counts.cpu().numpy()
    valid = np.arange(dev.capacity)[None] < counts[:, None]

    def cfg_of(extra):
        return cfg_mod.apply_overrides(
            cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}"]
            + list(extra))

    def levels(c):
        sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                                level_capacities(c, dev.capacity),
                                dev.grid_dims, **_sb_kwargs(c))
        return [(lv.key, lv.coords, lv.valid, lv.count) for lv in sb.levels]

    dense_levels = levels(cfg_of([]))
    for impl in ("gather", "gather_pallas"):
        same = [all(torch.equal(a, b) for a, b in zip(x, y)) for x, y in
                zip(dense_levels, levels(cfg_of(
                    [f"model.backbone_impl={impl}"])))]
        log(f"{impl} sparse batch vs dense, each level's keys, coordinates, "
            f"valid rows and counts bitwise equal: {same}")

    def run(extra, sigma=0.0):
        c = cfg_of(extra)
        mdl = mt.build_model(c, device="cuda", seed=0)
        ckpt.load_checkpoint(ckpt_path, mdl)
        mdl.eval()
        if sigma:
            plant_backbone_noise(torch, mdl, sigma)
        calls, hooks = record_decoder_inputs(mdl)
        out, _ = mt.infer(mdl, dev, c, device="cuda")
        for h in hooks:
            h.remove()
        return dict(preds=(out.pred_class.cpu().numpy(),
                           out.pred_masks.cpu().numpy()),
                    maps=backbone_run(torch, bb_mod, mdl, c, dev,
                                      sparse)["maps"], calls=calls)

    runs = {"fp32": run([]), "gather": run(["model.backbone_impl=gather"]),
            "gather_pallas": run(["model.backbone_impl=gather_pallas"]),
            "bf16": run(CONFIGS["bf16"]), "int8": run(CONFIGS["int8"])}
    ratios = {}
    for path, (base, _) in PATH_GATES.items():
        st = output_stats(np, runs[base], runs[path], valid)
        for what, v in st.items():
            log(f"trained {path} vs {base} {what}: {json.dumps(v)}")
        ratios[path] = gate_ratio(path, st)
    log(f"trained-weight gate ratios (pass at <= 1): {json.dumps(ratios)} "
        f"on {card_line()}")
    for sigma in NOISE_SIGMAS:
        runs[f"fp32 + N(0, {sigma:g})"] = run([], sigma)
    for path, r in runs.items():
        if path == "fp32":
            continue
        st = output_stats(np, runs["fp32"], r, valid)
        worst_map = max(v["max"] for w, v in st.items()
                        if w.startswith("map"))
        calls = decoder_input_diffs(runs["fp32"]["calls"], r["calls"])
        log(f"trained {path} vs fp32: worst map max |diff| {worst_map:.3g}, "
            f"pred_masks mean |diff| {st['pred_masks']['mean']:.4g}, "
            f"pred_class mean |diff| {st['pred_class']['mean']:.4g}; "
            f"decoder inputs by cross-attention call: {json.dumps(calls)}")
    return 0 if all(r <= 1.0 for r in ratios.values()) else 1


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
        from mask3d_tpu_torch.ops import lsap as lsap_mod
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
            # on standard error too: its tail is what a caller keeps
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}",
                file=sys.stderr)
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
                "int8_conv": ic.int8_conv,
                "lsap": lsap_mod.linear_sum_assignment}
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
                                     "sparse_conv": 0, "int8_conv": 0,
                                     "lsap": 0}, launches
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
    counts0 = host.device.counts.cpu().numpy()
    valid0 = np.arange(host.device.capacity)[None] < counts0[:, None]

    def path_stats(mdl, c, pc, pm):
        """diff_stats of a path's outputs and backbone maps against the
        dense forward on the same weights."""
        if not dense_ref:
            dense_ref.update(preds=preds, maps=backbone_maps(
                torch, model, cfg, host.device, sparse))
        return output_stats(np, dense_ref, dict(
            preds=(pc, pm),
            maps=backbone_maps(torch, mdl, c, host.device, sparse)), valid0)

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
                "int8_conv": 0, "lsap": 0}, launches
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

    def cfg_of(path):
        return cfg_mod.apply_overrides(
            cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}"]
            + CONFIGS[path])

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
                    "sparse_conv": 0, "lsap": 0,
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
        for path in ("bf16", "int8"):
            base, tol = PATH_GATES[path]
            stats = output_stats(np, int8_runs[base], int8_runs[path],
                                 valid0)
            for what, st in stats.items():
                log(f"{path} vs {base} {what}: {json.dumps(st)}")
            gates[path] = gate_ratio(path, stats)
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
                   int8_ops, "quantize", doubled_sx),
                  ("the dense norms skip the mean", "bf16", dense_ops,
                   "dense_instance_norm", norm_without_mean))
        for name, path, owner, attr, fake in faults:
            base, tol = PATH_GATES[path]
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
            stats = output_stats(np, int8_runs[base], run, valid0)
            ratio = gate_ratio(path, stats)
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

    roomformer = phase("roomformer", lambda: run_roomformer(
        torch, F, np, card))
    if roomformer is None:
        failures.append("roomformer did not run or failed a check")

    bench_input = phase("bench_input", lambda: run_bench_input(
        torch, np, mt, cfg_mod, counters, by_key, host, card))
    if bench_input is None:
        failures.append("bench_input did not run or failed a check")
    lsap_rows = phase("lsap", lambda: run_lsap(torch, np, lsap_mod, host,
                                                card))
    if not lsap_rows:
        failures.append("lsap did not run or failed a check")
    preprocess = phase("preprocess", lambda: run_preprocess(
        torch, np, mt, counters, card))
    if preprocess is None:
        failures.append("preprocess did not run or failed a check")
    parallel = phase("parallel", lambda: run_parallel(
        torch, np, mt, cfg_mod, counters, by_key, card, host))
    if parallel is None:
        failures.append("parallel did not run or failed a check")
    zoo = phase("model_zoo", lambda: run_model_zoo(
        torch, np, mt, cfg_mod, counters, by_key, card, host,
        (rg, sc, dense_ops), sparse))
    if zoo is None:
        failures.append("model_zoo did not run or failed a check")
    matrix = phase("config_matrix", lambda: run_config_matrix(
        torch, np, mt, cfg_mod, counters, by_key, card, host, ic, ma))
    if matrix is None:
        failures.append("config_matrix did not run or failed a check")
    rehearsal = phase("rehearsal", lambda: run_rehearsal(
        torch, np, counters, card))
    if rehearsal is None:
        failures.append("rehearsal did not run or failed a check")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        log(f"FAILED phases: {failures}", file=sys.stderr)
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
        # the same kernels at Res16UNet101's shapes (phase model_zoo): the
        # attention at the flagship's key lengths (the same levels), the
        # row gather at the 1024-wide level-0 tap, the sparse conv at every
        # shape of the bottleneck's gather_pallas forward
        kernel_entry("masked_attention:model_zoo",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102", attn_rows,
                     attn_rows[-1] if attn_rows else None,
                     zoo["paths"]["dense"]["launches"]["masked_attention"],
                     **forward_sums(attn_rows)),
        kernel_entry("row_gather:model_zoo",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198",
                     zoo["row_gather"], zoo["row_gather"][0],
                     zoo["paths"]["dense"]["launches"]["row_gather"]),
        kernel_entry("row_gather_bf16:model_zoo",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198",
                     zoo["row_gather_bf16"], zoo["row_gather_bf16"][0],
                     zoo["paths"]["bf16"]["gather_dtypes"].get("bfloat16",
                                                               0)),
        kernel_entry("sparse_conv:model_zoo",
                     "mask3d_tpu_torch/csrc/sparse_conv.cu",
                     "mask3d_tpu/sparse/pallas_conv.py:316",
                     zoo["sparse_conv"], heaviest(zoo["sparse_conv"]),
                     zoo["paths"]["gather_pallas"]["launches"]["sparse_conv"],
                     **forward_sums(zoo["sparse_conv"])),
        # the same kernels in phase config_matrix: the int8 conv at every
        # shape of Res16UNet101's int8 forward (Cout up to 1024 in channel
        # groups), the attention's partial form over a rank's half of the
        # keys (launches: a sharded rank's Config() forward)
        kernel_entry("int8_conv:config_matrix",
                     "mask3d_tpu_torch/csrc/int8_conv.cu",
                     "mask3d_tpu/sparse/pallas_chain.py:512",
                     matrix["int8_shapes"], heaviest(matrix["int8_shapes"]),
                     matrix["full_width"]["int8"]["int8_launches"],
                     **forward_sums(matrix["int8_shapes"])),
        kernel_entry("masked_attention_partial:config_matrix",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102",
                     matrix["attention_partial"],
                     matrix["attention_partial"][-1],
                     sum(matrix["sp"][0]["dense"]["partial_by_s"].values())),
        # the same kernels in phase rehearsal: the train steps' attention
        # at the sampled key lengths, the row gather at the flagship taps
        # (launches: the whole fit, validation included), the int8 conv at
        # the int8 stack's shapes (launches: the recert's int8 variant)
        kernel_entry("masked_attention:rehearsal",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102",
                     train["attention_forward"],
                     train["attention_forward"][-1],
                     rehearsal["launches"]["masked_attention"]),
        kernel_entry("row_gather:rehearsal",
                     "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather_rows,
                     next((r for r in gather_rows if r["C"] == 96), None),
                     rehearsal["launches"]["row_gather"]),
        kernel_entry("int8_conv:rehearsal",
                     "mask3d_tpu_torch/csrc/int8_conv.cu",
                     "mask3d_tpu/sparse/pallas_chain.py:512",
                     [r for r in int8_rows if r["step"] == "conv"],
                     heaviest([r for r in int8_rows if r["step"] == "conv"]),
                     rehearsal["launches"]["int8_conv"]),
        kernel_entry("lsap:rehearsal", "mask3d_tpu_torch/csrc/lsap.cu",
                     "mask3d_tpu/ops/lsap.py:30", lsap_rows, lsap_rows[0],
                     rehearsal["launches"]["lsap"],
                     scipy_ms=lsap_rows[0]["scipy_ms"]),
        # no Pallas counterpart: JAX's device LSAP is lax.while_loop code;
        # its launches are the counted dense train step's (one a criterion)
        kernel_entry("lsap", "mask3d_tpu_torch/csrc/lsap.cu",
                     "mask3d_tpu/ops/lsap.py:30", lsap_rows, lsap_rows[0],
                     train["step_launches"]["dense step (kernels)"]["lsap"],
                     scipy_ms=lsap_rows[0]["scipy_ms"]),
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
        | {"entry": {k: v for k, v in train_large["entry"].items()}},
        "roomformer": roomformer, "bench_input": bench_input,
        "preprocess": preprocess,
        "parallel": {k: parallel[k] for k in (
            "nccl_one_rank", "one_ulp_floor", "gates", "fit_vs_global_shapes",
            "ranks_seconds")}
        | {"ranks": [{k: v for k, v in r.items() if k != "fit"}
                     for r in parallel["ranks"]]},
        "model_zoo": {k: zoo[k] for k in (
            "paths", "options", "small_bottleneck",
            "small_bottleneck_fp32_gate", "small_bottleneck_bf16_maps",
            "small_options",
            "small_options_fault", "cli", "seconds")},
        "config_matrix": {k: matrix[k] for k in (
            "full_width", "int8_chain_bitwise_int8", "small_int8",
            "sp_summary", "seconds")},
        "rehearsal": rehearsal}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--trained"]:
            open_log()
            rc = run_trained_gates(sys.argv[2])
        else:
            rc = main()
    except BaseException:
        # whatever escapes main() reaches the log file before the exit
        log(f"chip_smoke: uncaught exception\n{traceback.format_exc()}",
            file=sys.stderr)
        sys.exit(1)
    sys.exit(rc)
