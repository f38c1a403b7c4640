"""Spawned gloo ranks of the port's parallel tests.

`run(fn, world, tmp_path, *args)` starts `world` processes with
`torch.multiprocessing` spawn; each runs on one torch thread, joins a gloo
group through a `file://` store in `tmp_path`, calls `fn(rank, world,
*args)` and hands its result back through a file. This module imports
torch and the port only, never jax, so a child does not import the JAX
package or the tests' conftest. The one-process counterparts run through
the same functions with world 1 and no group.
"""

from __future__ import annotations

import contextlib
import pathlib
import traceback

import numpy as np
import torch

# tests/test_parallel_sp.py:_cfg as overrides (model.sp_axis added by the
# callers); tests/torch_parity.py:SMALL_OVERRIDES is small_config's
SP_OVERRIDES = [
    "model.hidden_dim=32", "model.dim_feedforward=64", "model.num_queries=5",
    "model.num_decoders=1", "model.backbone=Res16UNet14A",
    "model.conv1_kernel_size=3", "model.sample_sizes=[16,32,64,128,256]",
    "data.point_bucket_multiple=256",
]
SP_BUCKET = 256
# the train steps: scipy's assignment (no device-solver ties), no
# train-split metrics
STEP_OVERRIDES = ["trainer.train_split_metrics=false",
                  "matcher.lsap_method=host", "model.attention_pallas_tile=16"]


def sp_items(n_items):
    """tests/test_parallel_sp.py:_batch's scenes (2x1 rooms of 10)."""
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(3)
    return [make_synthetic_scene(rng, num_rooms_x=2, num_rooms_y=1,
                                 room_size=10, height=6, jitter=0.0,
                                 dropout=0.4) for _ in range(n_items)]


def train_items():
    """tests/test_torch_train_step.py:train_scenes (3x2 rooms of 12)."""
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    return [make_synthetic_scene(np.random.default_rng(3 + i), num_rooms_x=3,
                                 num_rooms_y=2, room_size=12, height=6,
                                 jitter=0.0, dropout=0.5) for i in range(2)]


@contextlib.contextmanager
def norm_stub(identity: bool):
    """With `identity`, the dense InstanceNorm stubbed to the masking
    identity `x * occ` (the counterpart of tests/test_parallel_sp.py's
    stub; the sharded form too) until the block ends."""
    from mask3d_tpu_torch.sparse import dense_ops

    orig = dense_ops.dense_instance_norm
    if identity:
        dense_ops.dense_instance_norm = \
            lambda x, occ, g, b, eps=1e-5, group=None: x * occ.to(x.dtype)
    try:
        yield
    finally:
        dense_ops.dense_instance_norm = orig


def make_cfg(overrides):
    from mask3d_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), list(overrides))


def load_weights(model, weights):
    """`weights`: None (the seeded init), a state dict file, or a Flax
    variables .npz (`bridge`)."""
    if weights is None:
        return
    if str(weights).endswith(".npz"):
        from mask3d_tpu_torch import bridge

        flat = dict(np.load(weights))
        tree = {}
        for k, v in flat.items():
            node = tree
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        bridge.load_flax(model, tree)
    else:
        model.load_state_dict(torch.load(weights, weights_only=True))


def dp_items(make=None):
    """A scene of 3x2 rooms and one of 4x2 rooms (12 m rooms): their
    instance counts, and so their CE weight sums, differ."""
    if make is None:
        from mask3d_tpu_torch.data.synthetic import make_synthetic_scene \
            as make
    return [make(np.random.default_rng(3 + i), num_rooms_x=3 + i,
                 num_rooms_y=2, room_size=12, height=6, jitter=0.0,
                 dropout=0.5) for i in range(2)]


def scenes_of(items: str, n: int = 2):
    """`sp`: n of JAX's sequence-parallel test scenes (2x1 rooms, whose
    coarse InstanceNorms hold one or two occupied cells an item);
    `parity`: the port's parity scenes (3x2 rooms, two); `dp`:
    `dp_items`."""
    if items == "dp":
        return dp_items()
    return sp_items(n) if items == "sp" else train_items()[:n]


# test backbones of tests/test_torch_sp_model.py, registered in both
# packages: name -> (base, class attributes). Res16UNet50's bottleneck
# blocks with the gate, planes 96 at levels 1-2 (sharded at sp=2 on the
# parity scenes), stage 7 of two blocks: int8 3^3 and 1x1 convs on slabs,
# a 384-channel QGrid junction exchanging int8 halo planes, the gate's
# mean over sp; levels 0 and 3-4 stay narrow (JAX's int8 conv on the CPU
# is slow at width)
TEST_BACKBONES = {
    "SpBottleneckSE": ("Res16UNet50", dict(
        PLANES=(32, 32, 32, 32, 32, 96, 96, 32),
        LAYERS=(1, 1, 1, 1, 1, 1, 2, 1), SE=True)),
    # one block a stage, 128 wide: the gated bottleneck in bf16
    "SpBottleneckSENarrow": ("Res16UNet50", dict(
        PLANES=(32,) * 8, LAYERS=(1,) * 8, SE=True)),
}


def register_backbones():
    """TEST_BACKBONES into the port's `BACKBONES` (idempotent)."""
    from mask3d_tpu_torch.models.backbone import BACKBONES

    for name, (base, attrs) in TEST_BACKBONES.items():
        if name not in BACKBONES:
            BACKBONES[name] = type(name, (BACKBONES[base],), dict(attrs))


def forward(rank, world, overrides, weights, n_dp, n_sp, identity=False,
            items="sp", n_items=2, train=False, record=False):
    """(pred_class, pred_masks, backbone maps) of the eval forward on
    `scenes_of(items, n_items)`, rank (d, s) of an (n_dp, n_sp) mesh taking
    its dp rows; under sp the backbone's stride-1 rows (each rank's chunk)
    are gathered whole. `train` runs the forward in train mode instead
    (the memories sampled from a seeded generator; its masks, each rank's
    chunk of the rows, are gathered whole). With `record`, a fourth entry:
    the bytes of each collective of the forward (`comm.BYTES`), the rows
    each squeezed memory and the mask-feature head took, and `whole_rows`,
    the bytes an all-reduce of the rows that the reduce-scatters split
    would carry (their inputs' sizes)."""
    from mask3d_tpu_torch import build_model, collate, infer
    from mask3d_tpu_torch.parallel import comm, make_mesh_2d, shard_batch, \
        use_mesh
    from mask3d_tpu_torch.parallel.mesh import row_chunks

    register_backbones()
    cfg = make_cfg(overrides)
    model = build_model(cfg, device="cpu")
    model.train(train)
    load_weights(model, weights)
    host = collate(scenes_of(items, n_items), device="cpu",
                   point_bucket_multiple=cfg.data.point_bucket_multiple)
    maps, rows = [], {}
    hooks = [model.backbone.register_forward_hook(
        lambda m, i, o: maps.append(o[0].detach().clone()))]
    for name, mod in [("mask_features_head", model.mask_features_head)] + [
            (f"squeeze_{k}", m) for k, m in model.squeeze.items()]:
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, name=name: rows.setdefault(name, i[0].shape[1])
            and None))
    mesh = make_mesh_2d(n_dp, n_sp)
    comm.reset_bytes()
    whole_rows = [0]
    real_rs = comm.reduce_scatter_rows

    def reduce_scatter_rows(x, bounds, group, name="rows"):
        whole_rows[0] += x.numel() * x.element_size()
        return real_rs(x, bounds, group, name)

    comm.reduce_scatter_rows = reduce_scatter_rows
    try:
        with use_mesh(mesh), norm_stub(identity), \
                torch.backends.mkldnn.flags(enabled=False):
            batch = shard_batch(host.device, mesh)
            out, _ = infer(model, batch, cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
            chunks = row_chunks(cfg.model.sp_axis)
            n = batch.capacity
            masks = out.pred_masks
            if out.chunks is not None:  # train mode: this rank's rows
                masks = out.chunks.gather(masks, n)
            if chunks is not None and maps[0].shape[1] < n:  # dense: a chunk
                maps[0] = chunks.gather(maps[0], n)
    finally:
        comm.reduce_scatter_rows = real_rs
    for h in hooks:
        h.remove()
    res = (out.pred_class.numpy(), masks.numpy(), maps[0].float().numpy())
    return res + (dict(bytes=dict(comm.BYTES), rows=rows,
                       whole_rows=whole_rows[0]),) if record else res


def train_step(rank, world, overrides, weights, n_dp, n_sp, items="sp",
               identity=False, local_ce=False, n_items=None, uniforms=None):
    """(losses, {name: grad}, {name: parameter after the update}, the
    batch's shape, this rank's CE weight sums by level) of one train step,
    rank (d, s) of an (n_dp, n_sp) mesh on its dp rows of the batch.
    `local_ce` plants a fault: the CE normaliser left local. `uniforms`: a
    numpy seed; the sampled memories' `torch.rand` draws then come from
    `np.random.default_rng(uniforms)` in call order (the draws that
    tests/test_torch_train_step.py:Uniforms hands JAX)."""
    from mask3d_tpu_torch import collate
    from mask3d_tpu_torch.parallel import dist, make_mesh_2d, use_mesh
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    cfg = make_cfg(overrides)
    state = init_state(cfg, device="cpu")
    load_weights(state.model, weights)
    mesh = make_mesh_2d(n_dp, n_sp)
    scenes = scenes_of(items, n_items or 2 * n_dp)
    bucket = cfg.data.point_bucket_multiple
    idx = dist.local_batch_indices(np.arange(len(scenes)), mesh.dp_rank,
                                   n_dp)
    from mask3d_tpu_torch.data.collate import VoxelizeCollate

    host = VoxelizeCollate(point_bucket_multiple=bucket)(
        [scenes[i] for i in idx])
    with use_mesh(mesh), norm_stub(identity), \
            torch.backends.mkldnn.flags(enabled=False):
        host, batch = dist.put_global(host, "cpu", mesh.dp_group)
        criterion = make_criterion(cfg)
        sums, global_den = [], criterion.ce_denominators

        def den(w):
            sums.append(w.sum(dim=(1, 2)).detach().clone())
            return w.sum(dim=(1, 2)).detach() if local_ce else global_den(w)

        criterion.ce_denominators = den
        step = make_train_step(cfg, criterion, device="cpu")
        real_rand = torch.rand
        if uniforms is not None:
            rng = np.random.default_rng(uniforms)
            torch.rand = lambda size, *a, device=None, **k: torch.from_numpy(
                rng.random(size).astype(np.float32)).to(device)
        try:
            losses, _ = step(state, batch)
        finally:
            torch.rand = real_rand
    # a parameter the step leaves without a gradient reads as zeros
    grads = {k: (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.clone().numpy())
             for k, p in state.model.named_parameters()}
    params = {k: p.detach().clone().numpy()
              for k, p in state.model.named_parameters()}
    return ({k: float(v) for k, v in losses.items()}, grads, params,
            tuple(batch.coords.shape), sums[0].numpy())


SP = ["model.sp_axis=sp"]


def sp_suite(rank, world, step_overrides):
    """The sp=2 runs of tests/test_torch_sp.py: the eval forward with the
    norm stubbed (JAX's scenes) and with it (the parity scenes), and one
    train step of each."""
    return {
        "fwd_identity": forward(rank, world, SP_OVERRIDES + SP, None, 1, 2,
                                True, "sp"),
        "fwd_norm": forward(rank, world, SP_OVERRIDES + SP, None, 1, 2,
                            False, "parity"),
        "step_identity": train_step(rank, world, step_overrides + SP, None,
                                    1, 2, "sp", True),
        "step_norm": train_step(rank, world, step_overrides + SP, None, 1, 2,
                                "parity", False),
    }


def sp_model_suite(rank, world, cases):
    """The sp=2 forwards of tests/test_torch_sp_model.py: `cases` maps a
    name to (overrides, identity norm, items, n_items, train mode)."""
    return {name: forward(rank, world, ov + SP, None, 1, 2, ident, items, n,
                          train, record=True)
            for name, (ov, ident, items, n, train) in cases.items()}


def port_forwards(rank, world, cases):
    """The one-process forwards of `cases` (as `sp_model_suite` takes
    them, without sp), in a process of their own."""
    return {name: forward(rank, world, ov, None, 1, 1, ident, items, n,
                          train, record=True)
            for name, (ov, ident, items, n, train) in cases.items()}


def sp_train_suite(rank, world, cases, adjoint=False):
    """The sp=2 train steps of tests/test_torch_sp_train*.py: `cases` maps
    a name to (overrides, scenes, items, uniforms seed); with `adjoint`,
    `reduce_scatter_adjoint` under "adjoint"."""
    out = {name: train_step(rank, world, ov + SP, None, 1, 2, items,
                            n_items=n, uniforms=seed)
           for name, (ov, items, n, seed) in cases.items()}
    if adjoint:
        out["adjoint"] = reduce_scatter_adjoint(rank, world)
    return out


def port_steps(rank, world, cases):
    """The one-process steps of `cases` (as `sp_train_suite` takes them,
    without sp), in a process of their own."""
    return {name: train_step(rank, world, ov, None, 1, 1, items, n_items=n,
                             uniforms=seed)
            for name, (ov, items, n, seed) in cases.items()}


def reduce_scatter_adjoint(rank, world, b=2, n=11, c=3):
    """`comm.reduce_scatter_rows` and its gradient on this rank: x_r and
    the chunk cotangent g_r drawn from seeds r; returns (<y_r, g_r>,
    <x_r, dx_r>, max |dx_r - every rank's g_s concatenated|): the sums of
    the first two over the ranks agree when the backward is the forward's
    transpose, and the third is 0 when it is the all-gather of the
    chunks' gradients."""
    from mask3d_tpu_torch.parallel import comm, make_mesh_2d
    from mask3d_tpu_torch.parallel.mesh import RowChunks

    mesh = make_mesh_2d(1, world)
    chunks = RowChunks(mesh.sp_group, rank, world)
    bounds = chunks.bounds(n)

    def draw(seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed), dtype=torch.float64)

    x = draw(100 + rank, (b, n, c)).requires_grad_(True)
    gs = [draw(s, (b, bounds[s + 1] - bounds[s], c)) for s in range(world)]
    y = comm.reduce_scatter_rows(x, bounds, mesh.sp_group)
    y.backward(gs[rank])
    return (float((y * gs[rank]).sum()), float((x * x.grad).sum()),
            float((x.grad - torch.cat(gs, dim=1)).abs().max()))


def grid_suite(rank, world, step_overrides):
    """The four-rank runs of tests/test_torch_sp.py: a 2x2 (dp x sp) train
    step with the norm stubbed (4 of JAX's scenes) and with it (the 2
    parity scenes), and the grid ops on a 1x4 mesh."""
    return {
        "step_identity": train_step(rank, world, step_overrides + SP, None,
                                    2, 2, "sp", True),
        "step_norm": train_step(rank, world, step_overrides + SP, None, 2, 2,
                                "parity", False),
        "slab_ops": slab_ops(rank, world),
    }


def dp_suite(rank, world, overrides, weights):
    """The dp=2 runs of tests/test_torch_dp.py on `dp_items`, one scene a
    rank: whole levels as memories, sampled memories, and the planted
    local CE normaliser."""
    m = ["model.max_sample_size=true"]
    return {
        "max": train_step(rank, world, overrides + m, weights, 2, 1, "dp"),
        "sampled": train_step(rank, world, overrides, weights, 2, 1, "dp"),
        "local_ce": train_step(rank, world, overrides + m, weights, 2, 1,
                               "dp", local_ce=True),
    }


def _entry(rank, world, init_file, out_dir, fn_name, args):
    torch.set_num_threads(1)
    out = pathlib.Path(out_dir) / f"rank{rank}.pt"
    try:
        if world > 1:
            torch.distributed.init_process_group(
                "gloo", init_method=f"file://{init_file}", rank=rank,
                world_size=world)
        result = globals()[fn_name](rank, world, *args)
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class Ranks:
    """`world` spawned ranks running `fn_name(rank, world, *args)`; the
    caller works on while they run and reads `results()`."""

    def __init__(self, fn_name: str, world: int, tmp_path, *args):
        import torch.multiprocessing as mp

        self.world = world
        self.tmp = pathlib.Path(tmp_path) / f"{fn_name}-{world}"
        self.tmp.mkdir(parents=True, exist_ok=True)
        self.ctx = mp.spawn(
            _entry, args=(world, str(self.tmp / "store"), str(self.tmp),
                          fn_name, args),
            nprocs=world, join=False)

    def results(self):
        """Every rank's result, rank order (a failed rank raises with its
        traceback)."""
        while not self.ctx.join():
            pass
        out = []
        for r in range(self.world):
            got = torch.load(self.tmp / f"rank{r}.pt", weights_only=False)
            if "error" in got:
                raise RuntimeError(f"rank {r}:\n{got['error']}")
            out.append(got["ok"])
        return out


def run(fn_name: str, world: int, tmp_path, *args):
    """Every rank's result of `fn_name(rank, world, *args)`, rank order."""
    return Ranks(fn_name, world, tmp_path, *args).results()


def slab_ops(rank, world, grid=(24, 8, 6), c=5, seed=0):
    """Each sharded grid op on this rank's x-slab against the same op on
    the whole grid (computed on every rank), as max |diff| by op: the same-
    stride conv at k 3 and 5, the norm, and their gradients w.r.t. the
    input (the slab's part of the whole grid's gradient)."""
    from mask3d_tpu_torch.parallel import make_mesh_2d, use_mesh
    from mask3d_tpu_torch.parallel.mesh import slab_plan
    from mask3d_tpu_torch.sparse import dense_ops

    g = torch.Generator().manual_seed(seed)
    b = 2
    occ = (torch.rand((b, *grid, 1), generator=g) < 0.3).float()
    x = torch.randn((b, *grid, c), generator=g) * occ
    w3 = torch.randn((c, c, 3, 3, 3), generator=g) * 0.1
    w5 = torch.randn((c, c, 5, 5, 5), generator=g) * 0.1
    gamma = torch.rand(c, generator=g) + 0.5
    beta = torch.randn(c, generator=g)
    cot = torch.randn((b, *grid, c), generator=g)
    mesh = make_mesh_2d(1, world)
    out = {}
    with use_mesh(mesh):
        s = slab_plan([grid], "sp")[0]
        for name, whole_fn, slab_fn in (
                ("conv3", lambda v: dense_ops.dense_conv_same(v, w3, occ),
                 lambda v: dense_ops.dense_conv_same_slab(
                     v, w3, occ[:, s.x0:s.x1], s)),
                ("conv5", lambda v: dense_ops.dense_conv_same(v, w5, occ),
                 lambda v: dense_ops.dense_conv_same_slab(
                     v, w5, occ[:, s.x0:s.x1], s)),
                ("norm", lambda v: dense_ops.dense_instance_norm(
                    v, occ, gamma, beta),
                 lambda v: dense_ops.dense_instance_norm(
                     v, occ[:, s.x0:s.x1], gamma, beta, group=s.group))):
            xw = x.clone().requires_grad_(True)
            yw = whole_fn(xw)
            (yw * cot).sum().backward()
            xs = x[:, s.x0:s.x1].clone().requires_grad_(True)
            ys = slab_fn(xs)
            (ys * cot[:, s.x0:s.x1]).sum().backward()
            out[name] = float((ys - yw[:, s.x0:s.x1]).abs().max())
            out[name + "_grad"] = float(
                (xs.grad - xw.grad[:, s.x0:s.x1]).abs().max())
    return out


def fit(rank, world, overrides, n_sp=1):
    """`InstanceSegmentationTrainer.fit()` on this rank, the trainer built
    under a (world / n_sp, n_sp) mesh where n_sp > 1, then one more
    validation on the trained weights: (the validation's metrics, the
    trained state dict, the run directory, the files this rank opened for
    writing under `general.save_dir`, {"train": each epoch's train means,
    "bytes": the bytes of each collective})."""
    import sys

    from mask3d_tpu_torch.parallel import comm, make_mesh_2d
    from mask3d_tpu_torch.parallel.mesh import use_mesh
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    cfg = make_cfg(overrides)
    save_dir = str(pathlib.Path(cfg.general.save_dir).resolve())
    written = []

    def audit(event, args):
        if event == "open" and isinstance(args[0], str) and \
                str(args[1]) != "r" and any(c in str(args[1])
                                             for c in "wax+") and \
                str(pathlib.Path(args[0]).resolve()).startswith(save_dir):
            written.append(args[0])

    sys.addaudithook(audit)
    # CSV metrics only: importing TensorBoard here loads TensorFlow (~16 s)
    sys.modules["torch.utils.tensorboard"] = None
    comm.reset_bytes()
    with use_mesh(make_mesh_2d(world // n_sp, n_sp) if n_sp > 1 else None):
        trainer = InstanceSegmentationTrainer(cfg, device="cpu")
    train = record_train_means(trainer)
    trainer.fit()
    with use_mesh(trainer.mesh):
        val = trainer.eval_epoch("validation")
    return (val, {k: v.detach().clone()
                  for k, v in trainer.model.state_dict().items()},
            trainer.run_dir, sorted(set(written)),
            {"train": train, "bytes": dict(comm.BYTES)})


def record_train_means(trainer):
    """The list that each `trainer.train_epoch()` of `fit()` appends its
    returned epoch means to."""
    out = []
    run = trainer.train_epoch

    def train_epoch():
        out.append(run())
        return out[-1]

    trainer.train_epoch = train_epoch
    return out
