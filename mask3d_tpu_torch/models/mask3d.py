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
`ops/masked_attention.py`.
Attention masks come from the pooled mask-feature pyramid: on the dense
grids (pooling commutes with the linear mask head) on the dense backbone,
by row-space average pooling over the PoolMaps on the gather backbones.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.models.backbone import BACKBONES, IMPLS
from mask3d_tpu_torch.models.posenc import fourier_embeddings, \
    sine_embeddings
from mask3d_tpu_torch.ops.fps import furthest_point_sample
from mask3d_tpu_torch.ops.masked_attention import masked_cross_attention
from mask3d_tpu_torch.sparse import dense_ops
from mask3d_tpu_torch.sparse.context import SparseBatch
from mask3d_tpu_torch.sparse.ops import avg_pool

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


# from mask3d_tpu/models/mask3d.py:47 Mask3DOutput
@dataclasses.dataclass
class Mask3DOutput:
    """Every mask-module output in emission order; the last is the final
    prediction."""

    aux_pred_class: torch.Tensor  # f32[L, B, Q, C+1]
    aux_pred_masks: torch.Tensor  # f32[L or 1, B, N1, Q]

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

    def forward(self, q, k=None, v=None, mask=None, kv_proj=None):
        h = self.num_heads
        wq = self.q(q)
        wk, wv = kv_proj if kv_proj is not None else self.project_kv(k, v)
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


# from mask3d_tpu/models/mask3d.py:192 CrossAttentionLayer (post-norm)
class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def project_kv(self, memory, pos):
        """K attends to memory+pos, V to memory; constant across the
        shared-decoder rounds, so the caller hoists them."""
        return self.attn.project_kv(memory + pos, memory)

    def forward(self, tgt, memory_mask, query_pos, kv_proj):
        t2 = self.attn(tgt + query_pos, mask=memory_mask, kv_proj=kv_proj)
        return self.norm(tgt + self.drop(t2))


# from mask3d_tpu/models/mask3d.py:231 SelfAttentionLayer (post-norm)
class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.attn = MultiheadAttention(d_model, num_heads)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, query_pos):
        t2 = self.attn(tgt + query_pos, tgt + query_pos, tgt)
        return self.norm(tgt + self.drop(t2))


# from mask3d_tpu/models/mask3d.py:252 FFNLayer (post-norm)
class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.0):
        super().__init__()
        self.lin1 = nn.Linear(d_model, dim_feedforward)
        self.lin2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt):
        t2 = self.lin2(self.drop(torch.relu(self.lin1(tgt))))
        return self.norm(tgt + self.drop(t2))


# from mask3d_tpu/models/mask3d.py:274 _masked_minmax
def _masked_minmax(coords, valid):
    """Per-item min/max over valid rows; empty items collapse to zeros."""
    big = 1e9
    c = coords.float()
    v = valid[..., None]
    mins = torch.where(v, c, big).amin(dim=1)
    maxs = torch.where(v, c, -big).amax(dim=1)
    any_valid = valid.any(dim=1)[:, None]
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


# from mask3d_tpu/models/mask3d.py:288 Mask3D (one set of decoder layers
# shared by every round, post-norm layers)
class Mask3D(nn.Module):
    def __init__(self, num_classes=1, hidden_dim=128, dim_feedforward=1024,
                 num_queries=25, num_heads=8, num_decoders=3, dropout=0.0,
                 normalize_pos_enc=True, positional_encoding_type="fourier",
                 gauss_scale=1.0, hlevels=(0, 1, 2, 3),
                 sample_sizes=(200, 800, 3200, 12800, 51200),
                 max_sample_size=False, backbone_name="Res16UNet34C",
                 in_channels=1, conv1_kernel_size=5, backbone_impl="dense",
                 remat_backbone=False, **backbone_opts):
        """`backbone_opts`: the backbone's compute dtype and int8 options
        (`Res16UNetBase`)."""
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
        self.sample_sizes = tuple(sample_sizes)
        self.max_sample_size = max_sample_size
        self.remat_backbone = remat_backbone
        self.backbone = BACKBONES[backbone_name](
            in_channels=in_channels, conv1_kernel_size=conv1_kernel_size,
            impl=backbone_impl, **backbone_opts)
        planes = self.backbone.PLANES
        # channels of feature_maps[i] (strides 16, 8, 4, 2, 1)
        fm_channels = [planes[3], planes[4], planes[5], planes[6], planes[7]]

        self.mask_features_head = nn.Linear(planes[7], d)
        self.query_proj_hidden = nn.Linear(d, d)
        self.query_proj_out = nn.Linear(d, d)
        # keys "0_{i}": the JAX package's shared-decoder names cross_0_{i} ...
        keys = [f"0_{i}" for i in range(len(self.hlevels))]
        self.cross = nn.ModuleDict(
            {k: CrossAttentionLayer(d, num_heads, dropout) for k in keys})
        self.self_attn = nn.ModuleDict(
            {k: SelfAttentionLayer(d, num_heads, dropout) for k in keys})
        self.ffn = nn.ModuleDict(
            {k: FFNLayer(d, dim_feedforward, dropout) for k in keys})
        self.squeeze = nn.ModuleDict({
            k: nn.Linear(fm_channels[h], d)
            for k, h in zip(keys, self.hlevels)})
        self.decoder_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.mask_embed_hidden = nn.Linear(d, d)
        self.mask_embed_out = nn.Linear(d, d)
        self.class_embed_head = nn.Linear(d, num_classes + 1)
        self.register_buffer("gauss_B", torch.zeros(3, d // 2))

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
        model's device) draws the sampled memories of train mode.
        `phase_mark(name)` is called at each phase boundary of the JAX
        package's markers (mask3d.py:414-735): "backbone_part1",
        "backbone_part2", "pos_enc", "queries", then "decoder_<d>" after
        each decoder round (`train.loop.measure_model_phases`)."""
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
        if self.training and self.remat_backbone:
            # from mask3d_tpu/models/mask3d.py:389-395 remat_backbone:
            # recompute the backbone in the backward instead of keeping its
            # activations
            bb_out, feature_maps, bb_grid = checkpoint(
                self.backbone, feats, sb, grid_dims, int8,
                use_reentrant=False)
        else:
            bb_out, feature_maps, bb_grid = self.backbone(feats, sb,
                                                          grid_dims, int8)
        mark("backbone_part1")
        # feature_maps: [s16, s8, s4, s2, s1]; sparse level of fm[i] = 4-i
        fm_level = [n_levels - 1 - i for i in range(n_levels)]

        # A bf16 backbone's rows go into the f32 heads as f32 (Flax's Dense
        # promotes bf16 inputs with f32 kernels; nn.Linear would refuse).
        mask_feats = self.mask_features_head(bb_out.float()) * \
            valid0[..., None]
        # The coordinate and pooled mask-feature pyramids only place the
        # positional encodings and threshold the attention masks: no
        # gradient flows through them (the JAX package's stop_gradients,
        # mask3d.py:438, :450, :477-478, :494).
        coords_pyr = [raw_coords.float().detach()]
        mask_feats_pyr = [mask_feats.detach()]
        if bb_grid is not None:
            # Pooled pyramid on the dense grids: mean-pool the coordinate
            # grid and the backbone grid, gather rows per level, and apply
            # the (linear) mask head per coarse row.
            coord_grid = dense_ops.cell_coord_grid(
                grid_dims[0], b, device=feats.device) * sb.occ[0]
            for crow, brow in dense_ops.pooled_row_pyramid(
                    [coord_grid, bb_grid.detach()], sb.occ, sb.levels,
                    grid_dims):
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
        mark("backbone_part2")

        pe_levels = {fm_level[h] for h in self.hlevels}
        pe_pyr, minmax_pyr = [], []
        for li in range(n_levels):
            mins, maxs = _masked_minmax(coords_pyr[li], sb.levels[li].valid)
            minmax_pyr.append((mins, maxs))
            pe_pyr.append(self._pos_enc(coords_pyr[li], mins, maxs)
                          if li in pe_levels else None)
        mark("pos_enc")

        # Query initialization: FPS positions -> PE -> MLP.
        fps_idx = furthest_point_sample(coords_pyr[0], valid0,
                                        self.num_queries)
        sampled = torch.gather(coords_pyr[0], 1,
                               fps_idx[..., None].expand(-1, -1, 3))
        qp = self._pos_enc(sampled, *minmax_pyr[0])
        qp = torch.relu(self.query_proj_hidden(qp))
        query_pos = torch.relu(self.query_proj_out(qp))
        queries = torch.zeros_like(query_pos)
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
                key = f"0_{li}"
                cross = self.cross[key]
                cap = level.capacity
                s = self._sampled(hlevel, cap)
                if s == cap:
                    # The full padded level: its squeezed memory and K/V
                    # are the same in every shared-decoder round.
                    if key not in kv_cache:
                        src = self.squeeze[key](feature_maps[hlevel].float())
                        kv_cache[key] = cross.project_kv(src, pe_pyr[lvl])
                    kvp = kv_cache[key]
                    n_rows = level.count
                else:
                    # from mask3d_tpu/models/mask3d.py:693-716 uniform: a
                    # fresh sample of the level's valid rows each round
                    if generator is None:
                        raise ValueError("a sampled memory needs a "
                                         "torch.Generator (generator=)")
                    r = torch.rand((b, cap), generator=generator,
                                   device=attn.device)
                    idx = sample_memory_idx(r, level.valid, s)

                    def take(x):
                        return torch.gather(
                            x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

                    src = self.squeeze[key](take(feature_maps[hlevel].float()))
                    kvp = cross.project_kv(src, take(pe_pyr[lvl]))
                    attn = take(attn)  # [B, S, Q]
                    n_rows = torch.clamp(level.count, max=s)
                # Unblock queries whose mask blocks every row, then block
                # the padding rows.
                pad = torch.arange(s, device=attn.device)[None] \
                    >= n_rows[:, None]
                all_blocked = attn.sum(dim=1) == s  # [B, Q]
                attn = attn & ~all_blocked[:, None, :]
                attn = attn | pad[..., None]
                mem_mask = attn.transpose(1, 2).contiguous()  # [B, Q, S]

                queries = cross(queries, mem_mask, query_pos, kvp)
                queries = self.self_attn[key](queries, query_pos)
                queries = self.ffn[key](queries)
                predictions_class.append(out_class)
                if aux_masks:
                    predictions_masks.append(out_masks)
            mark(f"decoder_{dec}")

        out_class, out_masks, _ = mask_module(queries, 0, ret_attn=False)
        predictions_class.append(out_class)
        predictions_masks.append(out_masks)
        return Mask3DOutput(aux_pred_class=torch.stack(predictions_class),
                            aux_pred_masks=torch.stack(predictions_masks))


# model options the port has not fully ported -> the values it runs (the
# same in train and eval mode)
_SUPPORTED_VALUES = {
    "non_parametric_queries": (True,), "random_queries": (False,),
    "random_query_both": (False,), "use_np_features": (False,),
    "use_level_embed": (False,), "backbone_impl": IMPLS,
    "compute_dtype": (None, "bfloat16"), "sp_axis": (None,),
    "pre_norm": (False,), "shared_decoder": (True,),
    "fold_small_stages": (False,),
    # schedules of the JAX package's TPU sparse-conv kernel, which leave its
    # outputs as they are; the port runs its one CUDA kernel for each
    "pallas_conv_select": ("onehot", "gather"),
    "pallas_window_mode": ("per_offset", "grouped_dx"),
}


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
    `trainer.grad_accum_steps`)."""
    dev = resolve_device(device)
    m = cfg.model
    for opt, supported in _SUPPORTED_VALUES.items():
        if getattr(m, opt) not in supported:
            raise NotImplementedError(
                f"model.{opt}={getattr(m, opt)!r} is not ported yet "
                f"(the port runs {opt} in {supported!r})")
    if m.backbone not in BACKBONES:
        raise NotImplementedError(f"backbone {m.backbone} is not ported")
    model = Mask3D(
        num_classes=m.num_classes, hidden_dim=m.hidden_dim,
        dim_feedforward=m.dim_feedforward, num_queries=m.num_queries,
        num_heads=m.num_heads, num_decoders=m.num_decoders,
        dropout=m.dropout, normalize_pos_enc=m.normalize_pos_enc,
        positional_encoding_type=m.positional_encoding_type,
        gauss_scale=m.gauss_scale, hlevels=m.hlevels,
        sample_sizes=m.sample_sizes, max_sample_size=m.max_sample_size,
        backbone_name=m.backbone,
        in_channels=cfg.data.in_channels,
        conv1_kernel_size=m.conv1_kernel_size,
        backbone_impl=m.backbone_impl, remat_backbone=m.remat_backbone,
        compute_dtype=(torch.bfloat16 if m.compute_dtype == "bfloat16"
                       else None),
        int8_stride1=m.int8_stride1, int8_residual=m.int8_residual,
        int8_act_sigma=m.int8_act_sigma, pallas_chain=m.pallas_chain,
        unit_features=m.unit_features, brick_dims=tuple(m.brick_dims),
        brick_capacity=m.brick_capacity,
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
