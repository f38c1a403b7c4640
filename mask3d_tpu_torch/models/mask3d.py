"""Mask3D: instance queries refined by masked cross-attention over the
multi-scale backbone features, with a mask module emitting per-point mask
logits and class logits after every refinement.

The JAX package's model, batched over the `[B, N]` padded layout. In eval
mode the full padded level is the attention memory (padding rows blocked),
and the squeezed memory and its K/V projections are computed once per
level and reused by every shared decoder round. In train mode
(`model.train()`) each cross-attention attends to a random sample of
`sample_sizes[hlevel]` rows of its level (`sample_memory_idx`, drawn from
the caller's `torch.Generator`) unless `max_sample_size`, the int8 convs
stay off, and `remat_backbone` recomputes the backbone in the backward.
Every masked cross-attention runs the CUDA kernel of
`ops/masked_attention.py`. Every decoder option of the JAX package runs:
FPS, random or learned queries (with the backbone's rows as FPS query
features), pre-norm layers, a level embedding, and a set of layers a round
(`shared_decoder=False`).
Attention masks come from the pooled mask-feature pyramid: on the dense
grids (pooling commutes with the linear mask head) on the dense backbone,
by row-space average pooling over the PoolMaps on the gather backbones.

With `model.sp_axis` at inference, each sp rank holds one contiguous chunk
of every level's rows (`parallel.mesh.RowChunks`, as the JAX package's
`maybe_constrain` splits its row arrays): the feature maps, the mask
features and their pyramid, the coordinate pyramid, the attention masks
and the mask logits. The sharded dense backbone reduce-scatters its rows
to the chunks; the other impls run whole on every rank and each takes its
chunk. The positional encodings' min/max and the un-blocking of fully
blocked queries reduce over `sp`; each cross-attention runs the kernel's
partial form over the rank's rows and combines the ranks' softmax states
(`ops.masked_attention.combine_partial_softmax`); FPS reads the input
coordinates, whole on every rank; the output masks are gathered whole. In
training the decoder keeps whole rows on every rank (`parallel/comm.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.models.backbone import BACKBONES
from mask3d_tpu_torch.models.posenc import fourier_embeddings, \
    sine_embeddings
from mask3d_tpu_torch.ops.fps import furthest_point_sample
from mask3d_tpu_torch.ops import masked_attention as ma
from mask3d_tpu_torch.ops.masked_attention import masked_cross_attention
from mask3d_tpu_torch.parallel import comm
from mask3d_tpu_torch.parallel.mesh import dp_coords, row_chunks, slab_plan
from mask3d_tpu_torch.sparse import dense_ops
from mask3d_tpu_torch.sparse.context import SparseBatch
from mask3d_tpu_torch.sparse.ops import avg_pool

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


# from mask3d_tpu/models/mask3d.py:47 Mask3DOutput
@dataclasses.dataclass
class Mask3DOutput:
    """Every mask-module output in emission order; the last is the final
    prediction. `sampled_coords` holds the FPS query positions (None
    unless `non_parametric_queries`), `backbone_feats` the backbone's
    stride-1 rows."""

    aux_pred_class: torch.Tensor  # f32[L, B, Q, C+1]
    aux_pred_masks: torch.Tensor  # f32[L or 1, B, N1, Q]
    sampled_coords: Optional[torch.Tensor] = None  # f32[B, Q, 3]
    backbone_feats: Optional[torch.Tensor] = None  # [B, N1, C_bb]

    @property
    def pred_class(self):
        return self.aux_pred_class[-1]

    @property
    def pred_masks(self):
        return self.aux_pred_masks[-1]


# from mask3d_tpu/models/mask3d.py:115 MultiheadAttention
class MultiheadAttention(nn.Module):
    """MHA with a boolean block-mask (True = do not attend). A masked call
    goes through the masked cross-attention kernel; the unmasked one
    (self-attention over the queries) is plain PyTorch."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def project_kv(self, k, v):
        return self.k(k), self.v(v)

    def forward(self, q, k=None, v=None, mask=None, kv_proj=None,
                group=None):
        """`group`: the keys are this sp rank's chunk of the rows (see
        `sharded_attention`)."""
        h = self.num_heads
        wq = self.q(q)
        wk, wv = kv_proj if kv_proj is not None else self.project_kv(k, v)
        if mask is not None and group is not None:
            return self.out(sharded_attention(wq, wk, wv, mask, h, group))
        if mask is not None:
            return self.out(masked_cross_attention(wq, wk, wv, mask, h))
        b, nq, d = wq.shape
        hd = d // h

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], h, hd)

        logits = torch.einsum("bqhd,bkhd->bhqk", split(wq), split(wk))
        att = torch.softmax(logits / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, split(wv))
        return self.out(out.reshape(b, nq, d))


# from mask3d_tpu/models/mask3d.py:192 CrossAttentionLayer
class CrossAttentionLayer(nn.Module):
    """Masked cross-attention of the queries to a level's memory, with its
    residual and LayerNorm after (post-norm) or the LayerNorm on the
    queries first (`pre_norm`)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 pre_norm: bool = False):
        super().__init__()
        self.attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.pre_norm = pre_norm

    def project_kv(self, memory, pos):
        """K attends to memory+pos, V to memory; constant across the
        shared-decoder rounds, so the caller hoists them."""
        return self.attn.project_kv(memory + pos, memory)

    def forward(self, tgt, memory_mask, query_pos, kv_proj, group=None):
        if self.pre_norm:
            t2 = self.attn(self.norm(tgt) + query_pos, mask=memory_mask,
                           kv_proj=kv_proj, group=group)
            return tgt + self.drop(t2)
        t2 = self.attn(tgt + query_pos, mask=memory_mask, kv_proj=kv_proj,
                       group=group)
        return self.norm(tgt + self.drop(t2))


# from mask3d_tpu/models/mask3d.py:231 SelfAttentionLayer
class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 pre_norm: bool = False):
        super().__init__()
        self.attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.pre_norm = pre_norm

    def forward(self, tgt, query_pos):
        if self.pre_norm:
            t2 = self.norm(tgt)
            t2 = self.attn(t2 + query_pos, t2 + query_pos, t2)
            return tgt + self.drop(t2)
        t2 = self.attn(tgt + query_pos, tgt + query_pos, tgt)
        return self.norm(tgt + self.drop(t2))


# from mask3d_tpu/models/mask3d.py:252 FFNLayer
class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.0, pre_norm: bool = False):
        super().__init__()
        self.lin1 = nn.Linear(d_model, dim_feedforward)
        self.lin2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.pre_norm = pre_norm

    def forward(self, tgt):
        t2 = self.norm(tgt) if self.pre_norm else tgt
        t2 = self.lin2(self.drop(torch.relu(self.lin1(t2))))
        if self.pre_norm:
            return tgt + self.drop(t2)
        return self.norm(tgt + self.drop(t2))


# the masked cross-attention over row chunks (GSPMD's softmax over the
# sharded key axis of mask3d_tpu/ops/pallas_attention.py:102's caller)
def sharded_attention(q, k, v, mask, num_heads: int, group):
    """The masked attention over every sp rank's chunk of the keys: the
    kernel's partial form over this rank's (out, max, sum), one all-gather
    of the ranks' triples ([B, Q, D + 2H] floats) and their combine, the
    same on every rank. Inference only (no gradient)."""
    o, m, lsum = ma.masked_cross_attention_partial(q, k, v, mask, num_heads)
    b, nq, d = o.shape
    hq = num_heads * nq
    packed = torch.cat([o.reshape(b, -1), m.reshape(b, -1),
                        lsum.reshape(b, -1)], dim=1)
    parts = comm.all_gather(packed, group, name="attention_partials")
    return ma.combine_partial_softmax(
        [t[:, :nq * d].reshape(b, nq, d) for t in parts],
        [t[:, nq * d:nq * d + hq].reshape(b, num_heads, nq) for t in parts],
        [t[:, nq * d + hq:].reshape(b, num_heads, nq) for t in parts],
        num_heads)


# from mask3d_tpu/models/mask3d.py:274 _masked_minmax
def _masked_minmax(coords, valid, group=None):
    """Per-item min/max over valid rows; empty items collapse to zeros.
    With `group`, the rows are this sp rank's chunk and the min, max and
    any-valid reduce over it."""
    big = 1e9
    c = coords.float()
    v = valid[..., None]
    mins = torch.where(v, c, big).amin(dim=1)
    maxs = torch.where(v, c, -big).amax(dim=1)
    any_valid = valid.any(dim=1)[:, None]
    if group is not None:  # one max: of -min, max and any
        red = comm.max_over(torch.cat([-mins, maxs, any_valid.float()],
                                      dim=1), group, name="minmax")
        mins, maxs, any_valid = -red[:, :3], red[:, 3:6], red[:, 6:] > 0
    return (torch.where(any_valid, mins, 0.0),
            torch.where(any_valid, maxs, 0.0))


# from mask3d_tpu/models/mask3d.py:693-699 uniform (the sampled rows)
def sample_memory_idx(r, valid, s: int):
    """The rows a sampled memory takes: r f32[B, cap] uniforms in [0, 1),
    valid bool[B, cap] -> i64[B, s], the valid rows in the order of their
    draws, then the invalid rows in row order (r = 2 there; stable
    sort)."""
    r = torch.where(valid, r, 2.0)
    return torch.argsort(r, dim=-1, stable=True)[:, :s]


# from mask3d_tpu/models/mask3d.py:288 Mask3D
class Mask3D(nn.Module):
    def __init__(self, num_classes=1, hidden_dim=128, dim_feedforward=1024,
                 num_queries=25, num_heads=8, num_decoders=3, dropout=0.0,
                 pre_norm=False, use_level_embed=False,
                 normalize_pos_enc=True, positional_encoding_type="fourier",
                 gauss_scale=1.0, hlevels=(0, 1, 2, 3),
                 non_parametric_queries=True, random_query_both=False,
                 random_normal=False, random_queries=False,
                 use_np_features=False,
                 sample_sizes=(200, 800, 3200, 12800, 51200),
                 max_sample_size=False, shared_decoder=True,
                 backbone_name="Res16UNet34C", in_channels=1,
                 conv1_kernel_size=5, backbone_impl="dense",
                 remat_backbone=False, sp_axis=None, **backbone_opts):
        """`backbone_opts`: the backbone's compute dtype, int8 options and
        `fold_small_stages` (`models/backbone.py`). Queries come from FPS
        positions (`non_parametric_queries`, the default; with
        `use_np_features` their features are an MLP of the backbone's rows
        there), else uniform or normal draws (`random_queries`,
        `random_query_both` + `random_normal`, from the forward's
        generator), else learned `query_feat`/`query_pos`. With
        `shared_decoder=False` each of the `num_decoders` rounds has its
        own layers (keys "{round}_{level}"); `use_level_embed` adds a
        learned vector a level to the squeezed memory."""
        super().__init__()
        d = hidden_dim
        self.hidden_dim = d
        self.num_queries = num_queries
        self.num_heads = num_heads
        self.num_decoders = num_decoders
        self.dropout = dropout
        self.normalize_pos_enc = normalize_pos_enc
        self.positional_encoding_type = positional_encoding_type
        self.gauss_scale = gauss_scale
        self.hlevels = tuple(hlevels)
        self.non_parametric_queries = non_parametric_queries
        self.random_queries = random_queries
        self.random_query_both = random_query_both
        self.random_normal = random_normal
        self.use_np_features = use_np_features
        self.shared_decoder = shared_decoder
        self.sample_sizes = tuple(sample_sizes)
        self.max_sample_size = max_sample_size
        self.remat_backbone = remat_backbone
        self.sp_axis = sp_axis
        self.backbone = BACKBONES[backbone_name](
            in_channels=in_channels, conv1_kernel_size=conv1_kernel_size,
            impl=backbone_impl, sp_axis=sp_axis, **backbone_opts)
        e = self.backbone.EXPANSION
        planes = [c * e for c in self.backbone.PLANES]
        # channels of feature_maps[i] (strides 16, 8, 4, 2, 1)
        fm_channels = [planes[3], planes[4], planes[5], planes[6], planes[7]]

        self.mask_features_head = nn.Linear(planes[7], d)
        if self.query_mode == "fps":
            self.query_proj_hidden = nn.Linear(d, d)
            self.query_proj_out = nn.Linear(d, d)
            if use_np_features:
                self.np_proj_hidden = nn.Linear(planes[7], d)
                self.np_proj_out = nn.Linear(d, d)
        elif self.query_mode == "parametric":
            self.query_feat = nn.Parameter(torch.empty(num_queries, d))
            self.query_pos = nn.Parameter(torch.empty(num_queries, d))
        if use_level_embed:
            self.level_embed = nn.Parameter(torch.empty(len(self.hlevels), d))
        # keys "{round}_{level}": the JAX package's names cross_{d}_{i} ...;
        # one round's set (round 0) when the rounds share their layers
        n_sets = 1 if shared_decoder else num_decoders
        keys = [f"{r}_{i}" for r in range(n_sets)
                for i in range(len(self.hlevels))]
        self.cross = nn.ModuleDict(
            {k: CrossAttentionLayer(d, num_heads, dropout, pre_norm)
             for k in keys})
        self.self_attn = nn.ModuleDict(
            {k: SelfAttentionLayer(d, num_heads, dropout, pre_norm)
             for k in keys})
        self.ffn = nn.ModuleDict(
            {k: FFNLayer(d, dim_feedforward, dropout, pre_norm)
             for k in keys})
        self.squeeze = nn.ModuleDict({
            k: nn.Linear(fm_channels[self.hlevels[int(k.split("_")[1])]], d)
            for k in keys})
        self.decoder_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.mask_embed_hidden = nn.Linear(d, d)
        self.mask_embed_out = nn.Linear(d, d)
        self.class_embed_head = nn.Linear(d, num_classes + 1)
        self.register_buffer("gauss_B", torch.zeros(3, d // 2))

    @property
    def query_mode(self) -> str:
        """How the queries start (the JAX package's order of precedence,
        mask3d.py:539-572): "fps", "random" (uniform positions, zero
        features), "random_both" (features and positions drawn) or
        "parametric"."""
        if self.non_parametric_queries:
            return "fps"
        if self.random_queries:
            return "random"
        if self.random_query_both:
            return "random_both"
        return "parametric"

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights: He-normal backbone kernels, Glorot-uniform
        linear kernels, zero biases, unit LayerNorm gains and a gaussian
        Fourier projection."""
        self.backbone.init_weights(generator)
        with torch.no_grad():
            for name, mod in self.named_modules():
                if name.startswith("backbone"):
                    continue
                if isinstance(mod, nn.Linear):
                    fan_out, fan_in = mod.weight.shape
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            self.gauss_B.normal_(0.0, 1.0, generator=generator)
            self.gauss_B.mul_(self.gauss_scale)
            # unit-normal learned queries and level embeddings
            for name in ("query_feat", "query_pos", "level_embed"):
                if hasattr(self, name):
                    getattr(self, name).normal_(0.0, 1.0,
                                                generator=generator)

    def _pos_enc(self, xyz, mins, maxs):
        if self.positional_encoding_type == "fourier":
            return fourier_embeddings(xyz, self.gauss_B, mins, maxs,
                                      normalize=self.normalize_pos_enc)
        if self.positional_encoding_type == "sine":
            return sine_embeddings(xyz, self.hidden_dim, mins, maxs,
                                   normalize=self.normalize_pos_enc)
        raise ValueError(self.positional_encoding_type)

    def _sampled(self, hlevel: int, cap: int) -> int:
        """Rows of a cross-attention's memory at `hlevel`: the whole padded
        level in eval mode or with `max_sample_size`, else at most
        `sample_sizes[hlevel]`."""
        if not self.training or self.max_sample_size:
            return cap
        return min(cap, int(self.sample_sizes[hlevel]))

    def forward(self, sb: SparseBatch, feats, raw_coords, grid_dims,
                aux_masks: bool = True, generator=None,
                phase_mark=None) -> Mask3DOutput:
        """feats [B, N1, in_channels]; raw_coords f32[B, N1, 3] (the voxel
        coordinates, the PE/FPS positions). `aux_masks=False` skips the
        auxiliary full-resolution mask logits; `aux_pred_masks` then holds
        only the final prediction. `generator` (a `torch.Generator` on the
        model's device) draws the sampled memories of train mode and, in
        either mode, the random queries (drawn before the memories).
        `phase_mark(name)` is called at each phase boundary of the JAX
        package's markers (mask3d.py:414-735): "backbone_part1",
        "backbone_part2", "pos_enc", "queries", then "decoder_<d>" after
        each decoder round (`train.loop.measure_model_phases`)."""
        impl = self.backbone.impl
        if self.training and self.sp_axis is not None and impl != "dense":
            raise NotImplementedError(
                f"model.sp_axis in training with backbone_impl={impl!r}: "
                f"the sharded train step runs the dense backbone only (the "
                f"decoder over sharded rows is ported at inference)")
        mark = phase_mark or (lambda name: None)
        b = feats.shape[0]
        n_levels = sb.num_levels
        valid0 = sb.levels[0].valid
        if self.training and self.dropout > 0:
            # The JAX package's train step passes no "dropout" rng
            # (train/loop.py:273), so its flax Dropout raises there.
            raise NotImplementedError(
                "model.dropout > 0 in training: the JAX package's train step "
                "cannot run it either (no dropout rng); set model.dropout=0")

        # int8 convs at eval only: quantization has no useful gradient
        int8 = not self.training
        # this rank's chunk of every level's rows (inference under sp)
        chunks = row_chunks(self.sp_axis) if not self.training else None
        group = chunks.group if chunks is not None else None

        def take(x, li, dim=1):
            return x if chunks is None else chunks.take(
                x, sb.levels[li].capacity, dim)

        if self.training and self.remat_backbone:
            # from mask3d_tpu/models/mask3d.py:389-395 remat_backbone:
            # recompute the backbone in the backward instead of keeping its
            # activations
            bb_out, feature_maps, bb_grid = checkpoint(
                self.backbone, feats, sb, grid_dims, int8,
                use_reentrant=False)
        else:
            # the sharded dense backbone returns this rank's row chunks
            bb_out, feature_maps, bb_grid = self.backbone(
                feats, sb, grid_dims, int8, chunks)
        mark("backbone_part1")
        # feature_maps: [s16, s8, s4, s2, s1]; sparse level of fm[i] = 4-i
        fm_level = [n_levels - 1 - i for i in range(n_levels)]
        whole_rows = chunks is not None and bb_grid is None

        # A bf16 backbone's rows go into the f32 heads as f32 (Flax's Dense
        # promotes bf16 inputs with f32 kernels; nn.Linear would refuse).
        mask_feats = self.mask_features_head(bb_out.float()) * \
            (valid0 if whole_rows else take(valid0, 0))[..., None]
        # The coordinate and pooled mask-feature pyramids only place the
        # positional encodings and threshold the attention masks: no
        # gradient flows through them (the JAX package's stop_gradients,
        # mask3d.py:438, :450, :477-478, :494).
        coords_pyr = [(raw_coords.float() if whole_rows
                       else take(raw_coords.float(), 0)).detach()]
        mask_feats_pyr = [mask_feats.detach()]
        if bb_grid is not None:
            # Pooled pyramid on the dense grids: mean-pool the coordinate
            # grid and the backbone grid, gather rows per level, and apply
            # the (linear) mask head per coarse row.
            # under sp (the backbone's slab plan) bb_grid is this rank's
            # x-slab of level 0 and the pyramid's rows come back whole
            plan = slab_plan(grid_dims, self.sp_axis)
            s0 = plan[0] if plan else None
            dims0, x0, occ0 = grid_dims[0], 0, sb.occ[0]
            if s0 is not None:
                dims0 = (s0.x1 - s0.x0,) + tuple(grid_dims[0][1:])
                x0, occ0 = s0.x0, occ0[:, s0.x0:s0.x1]
            coord_grid = dense_ops.cell_coord_grid(
                dims0, b, device=feats.device, x0=x0) * occ0
            for crow, brow in dense_ops.pooled_row_pyramid(
                    [coord_grid, bb_grid.detach()], sb.occ, sb.levels,
                    grid_dims, plan=plan, chunks=chunks):
                coords_pyr.append(crow)
                mask_feats_pyr.append(
                    self.mask_features_head(brow.float()).detach())
        else:
            # from mask3d_tpu/models/mask3d.py:498-506: one row-space mean
            # pool of [coords | mask_feats] per level, split afterwards
            fused = torch.cat([coords_pyr[0], mask_feats_pyr[0]], dim=-1)
            for i, pool in enumerate(sb.pools):
                fused = avg_pool(fused, pool, sb.levels[i + 1].capacity)
                coords_pyr.append(fused[..., :3])
                mask_feats_pyr.append(fused[..., 3:])
            if whole_rows:  # the whole backbone ran here: take the chunks
                coords_pyr = [take(c, li) for li, c in enumerate(coords_pyr)]
                mask_feats_pyr = [take(m, li)
                                  for li, m in enumerate(mask_feats_pyr)]
                mask_feats = take(mask_feats, 0)
                bb_out = take(bb_out, 0)
                feature_maps = [take(f, fm_level[i])
                                for i, f in enumerate(feature_maps)]
        mark("backbone_part2")

        pe_levels = {fm_level[h] for h in self.hlevels}
        pe_pyr, minmax_pyr = [], []
        for li in range(n_levels):
            mins, maxs = _masked_minmax(coords_pyr[li],
                                        take(sb.levels[li].valid, li), group)
            minmax_pyr.append((mins, maxs))
            pe_pyr.append(self._pos_enc(coords_pyr[li], mins, maxs)
                          if li in pe_levels else None)
        mark("pos_enc")

        # FPS reads the input coordinates, whole on every rank
        queries, query_pos, sampled = self._queries(
            bb_out, raw_coords.float().detach(), valid0, minmax_pyr[0],
            generator, chunks)
        mark("queries")

        def mask_module(qs, num_pooling_steps, ret_attn=True,
                        ret_masks=True):
            qn = self.decoder_norm(qs)
            mask_embed = self.mask_embed_out(
                torch.relu(self.mask_embed_hidden(qn)))
            out_class = self.class_embed_head(qn)
            out_masks = (torch.einsum("bnd,bqd->bnq", mask_feats, mask_embed)
                         if ret_masks else None)
            if not ret_attn:
                return out_class, out_masks, None
            pooled = torch.einsum("bnd,bqd->bnq",
                                  mask_feats_pyr[num_pooling_steps],
                                  mask_embed.detach())
            return out_class, out_masks, torch.sigmoid(pooled) < 0.5

        predictions_class, predictions_masks = [], []
        kv_cache = {}
        for dec in range(self.num_decoders):
            for li, hlevel in enumerate(self.hlevels):
                lvl = fm_level[hlevel]
                out_class, out_masks, attn = mask_module(
                    queries, lvl, ret_masks=aux_masks)
                level = sb.levels[lvl]
                key = f"{0 if self.shared_decoder else dec}_{li}"
                cross = self.cross[key]
                cap = level.capacity
                s = self._sampled(hlevel, cap)
                rows = torch.arange(s, device=attn.device)[None]
                if s == cap:
                    # The full padded level: its squeezed memory and K/V
                    # are the same in every round that shares the layers.
                    if key not in kv_cache:
                        src = self._squeezed(key, li,
                                             feature_maps[hlevel].float())
                        kv_cache[key] = cross.project_kv(src, pe_pyr[lvl])
                    kvp = kv_cache[key]
                    n_rows = level.count
                    rows = take(rows, lvl)  # this rank's rows under sp
                else:
                    # from mask3d_tpu/models/mask3d.py:693-716 uniform: a
                    # fresh sample of the level's valid rows each round
                    if generator is None:
                        raise ValueError("a sampled memory needs a "
                                         "torch.Generator (generator=)")
                    # every dp rank draws the global batch's uniforms and
                    # keeps its items' rows: the one-process step's draws
                    n_dp, dp_rank, _ = dp_coords()
                    r = torch.rand((b * n_dp, cap), generator=generator,
                                   device=attn.device)[
                        dp_rank * b:(dp_rank + 1) * b]
                    idx = sample_memory_idx(r, level.valid, s)

                    def pick(x):
                        return torch.gather(
                            x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

                    src = self._squeezed(key, li,
                                         pick(feature_maps[hlevel].float()))
                    kvp = cross.project_kv(src, pick(pe_pyr[lvl]))
                    attn = pick(attn)  # [B, S, Q]
                    n_rows = torch.clamp(level.count, max=s)
                # Unblock queries whose mask blocks every row, then block
                # the padding rows.
                pad = rows >= n_rows[:, None]
                all_blocked = attn.all(dim=1)  # [B, Q]
                if group is not None:  # every rank's rows blocked
                    all_blocked = comm.max_over(
                        (~all_blocked).to(torch.uint8), group,
                        name="unblock") == 0
                attn = attn & ~all_blocked[:, None, :]
                attn = attn | pad[..., None]
                mem_mask = attn.transpose(1, 2).contiguous()  # [B, Q, S]

                queries = cross(queries, mem_mask, query_pos, kvp, group)
                queries = self.self_attn[key](queries, query_pos)
                queries = self.ffn[key](queries)
                predictions_class.append(out_class)
                if aux_masks:
                    predictions_masks.append(out_masks)
            mark(f"decoder_{dec}")

        out_class, out_masks, _ = mask_module(queries, 0, ret_attn=False)
        predictions_class.append(out_class)
        predictions_masks.append(out_masks)
        masks = torch.stack(predictions_masks)
        if chunks is not None:  # the output masks whole on every rank
            masks = chunks.gather(masks, sb.levels[0].capacity, dim=2,
                                  name="out_masks")
        # under sp at inference `backbone_feats` is this rank's row chunk
        return Mask3DOutput(aux_pred_class=torch.stack(predictions_class),
                            aux_pred_masks=masks, sampled_coords=sampled,
                            backbone_feats=bb_out)

    def _squeezed(self, key, li, feats):
        """A level's memory projected to the hidden width, plus its level
        embedding with `use_level_embed`."""
        src = self.squeeze[key](feats)
        if hasattr(self, "level_embed"):
            src = src + self.level_embed[li]
        return src

    def _draw(self, shape, generator, normal: bool, device):
        """Uniform (or normal) draws of `shape` [B, ...] for this dp rank's
        items: every rank draws the global batch's and keeps its items'
        (the one-process draws, as the sampled memories do)."""
        if generator is None:
            opt = ("random_queries" if self.query_mode == "random"
                   else "random_query_both")
            raise ValueError(f"model.{opt} draws the queries at random: "
                             f"the forward needs a torch.Generator "
                             f"(generator=)")
        n_dp, dp_rank, _ = dp_coords()
        b = shape[0]
        fn = torch.randn if normal else torch.rand
        return fn((b * n_dp,) + tuple(shape[1:]), generator=generator,
                  device=device)[dp_rank * b:(dp_rank + 1) * b]

    # from mask3d_tpu/models/mask3d.py:537-576 Query (initialization)
    def _queries(self, bb_out, coords0, valid0, minmax0, generator,
                 chunks=None):
        """(queries, query_pos, FPS positions or None), each [B, Q, D].
        With `chunks`, `bb_out` is this rank's chunk of the level-0 rows:
        a query's features come from the rank that holds its row, summed
        over `sp`."""
        b, q, d = bb_out.shape[0], self.num_queries, self.hidden_dim
        dev = bb_out.device
        mode = self.query_mode
        if mode == "fps":
            # FPS positions -> PE -> MLP; features zero, or an MLP of the
            # backbone's rows there
            fps_idx = furthest_point_sample(coords0, valid0, q)
            sampled = torch.gather(coords0, 1,
                                   fps_idx[..., None].expand(-1, -1, 3))
            qp = torch.relu(self.query_proj_hidden(
                self._pos_enc(sampled, *minmax0)))
            query_pos = torch.relu(self.query_proj_out(qp))
            if not self.use_np_features:
                return torch.zeros_like(query_pos), query_pos, sampled
            if chunks is None:
                np_feats = torch.gather(
                    bb_out.float(), 1,
                    fps_idx[..., None].expand(-1, -1, bb_out.shape[-1]))
            else:
                lo, hi = chunks.span(valid0.shape[1])
                mine = (fps_idx >= lo) & (fps_idx < hi)
                local = torch.where(mine, fps_idx - lo, 0)
                np_feats = torch.gather(
                    bb_out.float(), 1,
                    local[..., None].expand(-1, -1, bb_out.shape[-1]))
                np_feats = comm.all_reduce(
                    np_feats * mine[..., None], group=chunks.group,
                    name="np_features")
            queries = self.np_proj_out(
                torch.relu(self.np_proj_hidden(np_feats)))
            return queries, query_pos, sampled
        if mode == "random":
            query_pos = self._draw((b, q, d), generator, False, dev) - 0.5
            return torch.zeros_like(query_pos), query_pos, None
        if mode == "random_both":
            qpf = self._draw((b, q, 2 * d), generator, self.random_normal,
                             dev)
            if not self.random_normal:
                qpf = qpf - 0.5
            return qpf[..., :d], qpf[..., d:], None
        queries = self.query_feat[None].expand(b, -1, -1)
        return queries, self.query_pos[None].expand(b, -1, -1), None


# the schedules of the JAX package's TPU sparse-conv kernel, which leave
# its outputs as they are: the port runs its one CUDA kernel for each value
_SUPPORTED_VALUES = {
    "pallas_conv_select": ("onehot", "gather"),
    "pallas_window_mode": ("per_offset", "grouped_dx"),
}
COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def build_model(cfg, device="cuda", seed: int = 0) -> Mask3D:
    """Entry point: the Mask3D of `cfg.model`, with seeded random weights,
    on `device`, in eval mode. Load trained weights with
    `bridge.load_flax` or `train.checkpoint`. `model.train()` puts it in
    train mode (what `train.loop.init_state` does): sampled memories
    (`sample_sizes`, `max_sample_size`), `remat_backbone`, and no int8 convs
    (the JAX package passes `int8_stride1 and is_eval`); `dropout` > 0
    raises there, as the JAX package's train step does. Every backbone impl
    trains in fp32 and in bf16; `bricked` runs one scene a forward, so its
    train step takes micro-batches of one scene (`data.batch_size` equal to
    `trainer.grad_accum_steps`). `model.sp_axis` shards the `dense`
    backbone's grids over that axis of the active mesh (`parallel/mesh.py`;
    a no-op without one), with every backbone and int8 knob; at inference
    it splits the decoder's rows over the axis on every impl, and a train
    forward on another impl than `dense` raises with it. Every backbone of
    `models.backbone.BACKBONES`, every decoder option and every int8 knob
    on `dense` builds. Random queries are drawn from the forward's
    `generator=`."""
    dev = resolve_device(device)
    m = cfg.model
    for opt, supported in _SUPPORTED_VALUES.items():
        if getattr(m, opt) not in supported:
            raise NotImplementedError(
                f"model.{opt}={getattr(m, opt)!r} is not ported yet "
                f"(the port runs {opt} in {supported!r})")
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"model.compute_dtype={m.compute_dtype!r} is not ported (the "
            f"port runs {tuple(COMPUTE_DTYPES)})")
    if m.backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {m.backbone!r} (the backbones "
                         f"are {sorted(BACKBONES)})")
    model = Mask3D(
        num_classes=m.num_classes, hidden_dim=m.hidden_dim,
        dim_feedforward=m.dim_feedforward, num_queries=m.num_queries,
        num_heads=m.num_heads, num_decoders=m.num_decoders,
        dropout=m.dropout, pre_norm=m.pre_norm,
        use_level_embed=m.use_level_embed,
        normalize_pos_enc=m.normalize_pos_enc,
        positional_encoding_type=m.positional_encoding_type,
        gauss_scale=m.gauss_scale, hlevels=m.hlevels,
        non_parametric_queries=m.non_parametric_queries,
        random_query_both=m.random_query_both, random_normal=m.random_normal,
        random_queries=m.random_queries, use_np_features=m.use_np_features,
        sample_sizes=m.sample_sizes, max_sample_size=m.max_sample_size,
        shared_decoder=m.shared_decoder, backbone_name=m.backbone,
        in_channels=cfg.data.in_channels,
        conv1_kernel_size=m.conv1_kernel_size,
        backbone_impl=m.backbone_impl, remat_backbone=m.remat_backbone,
        compute_dtype=COMPUTE_DTYPES[m.compute_dtype],
        int8_stride1=m.int8_stride1, int8_residual=m.int8_residual,
        int8_act_sigma=m.int8_act_sigma, pallas_chain=m.pallas_chain,
        unit_features=m.unit_features, brick_dims=tuple(m.brick_dims),
        brick_capacity=m.brick_capacity, sp_axis=m.sp_axis,
        fold_small_stages=m.fold_small_stages,
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
