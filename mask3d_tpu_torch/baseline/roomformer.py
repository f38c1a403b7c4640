"""RoomFormer in PyTorch: the JAX package's `baseline/roomformer.py`.

A two-level-query deformable-DETR floorplan model (reference
`RoomFormer/models/roomformer.py:22-186`,
`RoomFormer/models/deformable_transformer.py`): a GroupNorm ResNet over the
density map, a multi-scale deformable-attention encoder, and a decoder over
num_polys x queries-per-poly queries with iterative polygon refinement;
corner-validity logits and normalized corner coordinates per decoder layer.

The port keeps the JAX model's numerics: NHWC density input, Flax's
asymmetric SAME padding at stride 2 (explicit `F.pad`), eps 1e-6 in every
norm, the deformable sampler of `deform_attn.py`, Flax's
`MultiHeadDotProductAttention` written out (query scaled by 1/sqrt(hd),
mask True = attend), and the JAX package's `stop_gradient` on every decoder
layer's reference points but the last. `load_flax` carries the JAX
package's parameters across by name.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mask3d_tpu_torch.baseline.deform_attn import ms_deform_attn_core

_EPS = 1e-6  # Flax GroupNorm / LayerNorm
_D_FFN = 512  # EncoderLayer / DecoderLayer default (roomformer.py:147,166)


# from mask3d_tpu/baseline/roomformer.py:32 inverse_sigmoid
def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


# from mask3d_tpu/baseline/roomformer.py:37 sine_position_2d
def sine_position_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     device=None) -> torch.Tensor:
    """2D sine position embedding [H, W, dim] (DETR-style)."""
    half = dim // 2
    f32 = dict(dtype=torch.float32, device=device)
    ys = (torch.arange(h, **f32) + 0.5) / h * 2 * math.pi
    xs = (torch.arange(w, **f32) + 0.5) / w * 2 * math.pi
    dim_t = temperature ** (
        2 * torch.div(torch.arange(half, **f32), 2, rounding_mode="floor")
        / half)
    py = ys[:, None] / dim_t
    px = xs[:, None] / dim_t
    py = torch.stack([torch.sin(py[:, 0::2]), torch.cos(py[:, 1::2])],
                     -1).reshape(h, -1)
    px = torch.stack([torch.sin(px[:, 0::2]), torch.cos(px[:, 1::2])],
                     -1).reshape(w, -1)
    return torch.cat([py[:, None, :].expand(h, w, py.shape[-1]),
                      px[None, :, :].expand(h, w, px.shape[-1])], dim=-1)


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Flax/XLA "SAME" padding of an NCHW map for a k x k window at stride
    s: per spatial dim, total = max((ceil(n/s) - 1) * s + k - n, 0), with
    total // 2 before and the rest after (asymmetric at stride 2)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad pads the last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class SameConv2d(nn.Conv2d):
    """`nn.Conv(..., padding="SAME")` of Flax, on NCHW maps."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if k == 1:
            # a 1x1 conv at stride s reads every s-th pixel: take them
            # first (oneDNN's CPU backward of a strided 1x1 conv whose
            # input has an unread last row corrupts the heap with several
            # threads)
            return F.conv2d(x[..., ::s, ::s], self.weight, self.bias)
        return super().forward(_same_pad(x, k, s))


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=_EPS)


# from mask3d_tpu/baseline/roomformer.py:62 ResBlock2D
class ResBlock2D(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, ch, 3, stride, bias=False)
        self.norm1 = _group_norm(ch)
        self.conv2 = SameConv2d(ch, ch, 3, bias=False)
        self.norm2 = _group_norm(ch)
        self.has_proj = cin != ch or stride != 1
        if self.has_proj:
            self.proj = SameConv2d(cin, ch, 1, stride, bias=False)
            self.proj_norm = _group_norm(ch)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = self.proj_norm(self.proj(x)) if self.has_proj else x
        return F.relu(y + residual)


# from mask3d_tpu/baseline/roomformer.py:82 Backbone2D
class Backbone2D(nn.Module):
    """Features at strides (4, 8, 16): a 7x7/2 stem, a 3x3/2 max pool and
    one stage of ResBlock2Ds per channel count."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256),
                 blocks_per_stage: int = 2, in_channels: int = 1):
        super().__init__()
        self.stem = SameConv2d(in_channels, channels[0], 7, 2, bias=False)
        self.stem_norm = _group_norm(channels[0])
        self.blocks = nn.ModuleList()
        self.stage_ends = []
        prev = channels[0]
        for si, ch in enumerate(channels):
            self.blocks.append(ResBlock2D(prev, ch, 1 if si == 0 else 2))
            for _ in range(blocks_per_stage - 1):
                self.blocks.append(ResBlock2D(ch, ch))
            prev = ch
            self.stage_ends.append(len(self.blocks) - 1)

    def forward(self, x):  # x: [B, C, H, W]
        y = F.relu(self.stem_norm(self.stem(x)))
        y = F.max_pool2d(_same_pad(y, 3, 2, float("-inf")), 3, 2)
        feats = []
        for i, block in enumerate(self.blocks):
            y = block(y)
            if i in self.stage_ends:
                feats.append(y)
        return feats


# from mask3d_tpu/baseline/roomformer.py:105 MSDeformAttnLayer
class MSDeformAttnLayer(nn.Module):
    """Sampling offsets and attention weights from the query (reference
    `models/ops/modules/ms_deform_attn.py:30-120`)."""

    def __init__(self, d_model: int, n_heads: int = 8, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, \
            n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attn_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, ref_points, value, spatial_shapes):
        """query [B, Q, D]; ref_points [B, Q, 2] in [0, 1] as (x, y);
        value [B, sum(HW), D]."""
        b, q, d = query.shape
        h, lv, p = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).reshape(b, -1, h, d // h)
        offsets = self.sampling_offsets(query).reshape(b, q, h, lv, p, 2)
        weights = F.softmax(
            self.attn_weights(query).reshape(b, q, h, lv * p), dim=-1
        ).reshape(b, q, h, lv, p)
        norm = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                            dtype=torch.float32, device=query.device)
        loc = (ref_points[:, :, None, None, None, :]
               + offsets / norm[None, None, None, :, None, :])
        out = ms_deform_attn_core(v, spatial_shapes, loc, weights)
        return self.output_proj(out)


# from mask3d_tpu/baseline/roomformer.py:142 EncoderLayer
class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_levels: int,
                 n_points: int, d_ffn: int = _D_FFN):
        super().__init__()
        self.attn = MSDeformAttnLayer(d_model, n_heads, n_levels, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=_EPS)
        self.ffn_in = nn.Linear(d_model, d_ffn)
        self.ffn_out = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=_EPS)

    def forward(self, src, pos, ref_points, spatial_shapes):
        a = self.attn(src + pos, ref_points, src, spatial_shapes)
        src = self.norm1(src + a)
        f = self.ffn_out(F.relu(self.ffn_in(src)))
        return self.norm2(src + f)


class SelfAttention(nn.Module):
    """Flax `MultiHeadDotProductAttention(num_heads, qkv_features=D)` as
    four D x D projections: the query scaled by 1/sqrt(hd), blocked scores
    set to the dtype's min, softmax in f32 (flax
    `dot_product_attention_weights`)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, attend: Optional[torch.Tensor]):
        """attend: bool [N, N], True = attend, or None."""
        b, n, d = q_in.shape
        hd = d // self.n_heads

        def heads(x):
            return x.reshape(b, n, self.n_heads, hd).transpose(1, 2)

        q = heads(self.query(q_in)) / math.sqrt(hd)
        k = heads(self.key(k_in))
        v = heads(self.value(v_in))
        scores = q @ k.transpose(-1, -2)  # [B, H, N, N]
        if attend is not None:
            scores = scores.masked_fill(~attend,
                                        torch.finfo(scores.dtype).min)
        o = F.softmax(scores, dim=-1) @ v
        return self.out(o.transpose(1, 2).reshape(b, n, d))


# from mask3d_tpu/baseline/roomformer.py:161 DecoderLayer
class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_levels: int,
                 n_points: int, d_ffn: int = _D_FFN):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=_EPS)
        self.cross_attn = MSDeformAttnLayer(d_model, n_heads, n_levels,
                                            n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=_EPS)
        self.ffn_in = nn.Linear(d_model, d_ffn)
        self.ffn_out = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=_EPS)

    def forward(self, tgt, query_pos, ref_points, memory, spatial_shapes,
                attend=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt, attend))
        t2 = self.cross_attn(tgt + query_pos, ref_points, memory,
                             spatial_shapes)
        tgt = self.norm2(tgt + t2)
        f = self.ffn_out(F.relu(self.ffn_in(tgt)))
        return self.norm3(tgt + f)


# from mask3d_tpu/baseline/roomformer.py:193 RoomFormerOutput
@dataclasses.dataclass
class RoomFormerOutput:
    """aux_* stack the per-decoder-layer outputs; the final layer is index
    -1 (reference out dict + aux_outputs, `roomformer.py:165-186`)."""

    aux_logits: torch.Tensor  # [L, B, P, Qp] corner-validity logits
    aux_coords: torch.Tensor  # [L, B, P, Qp, 2] normalized corner coords
    room_logits: Optional[torch.Tensor] = None  # [B, P, C_sem]

    @property
    def pred_logits(self) -> torch.Tensor:
        return self.aux_logits[-1]

    @property
    def pred_coords(self) -> torch.Tensor:
        return self.aux_coords[-1]


# from mask3d_tpu/baseline/roomformer.py:210 RoomFormer
class RoomFormer(nn.Module):
    """Defaults are the JAX model's (`RoomFormer/main.py`'s args: hidden
    256, 20 polygons x 40 corners = 800 queries). Weights are drawn from
    `generator` (CPU; `torch.Generator().manual_seed(0)` when None): the
    JAX package's initializers, see `init_weights`."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4, enc_layers: int = 6,
                 dec_layers: int = 6, num_polys: int = 20,
                 num_queries: int = 800, with_poly_refine: bool = True,
                 masked_attn: bool = False, semantic_classes: int = -1,
                 backbone_channels: Sequence[int] = (64, 128, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_levels != len(backbone_channels) + 1:
            raise ValueError(f"n_levels {n_levels} must be the backbone's "
                             f"{len(backbone_channels)} levels + 1")
        self.d_model, self.num_polys = d_model, num_polys
        self.num_queries, self.dec_layers = num_queries, dec_layers
        self.with_poly_refine, self.masked_attn = with_poly_refine, \
            masked_attn
        self.backbone = Backbone2D(tuple(backbone_channels))
        self.extra_level = SameConv2d(backbone_channels[-1], d_model, 3, 2)
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model))
        self.input_proj = nn.ModuleList(
            nn.Conv2d(c, d_model, 1)
            for c in list(backbone_channels) + [d_model])
        self.input_norm = nn.ModuleList(_group_norm(d_model)
                                        for _ in range(n_levels))
        self.encoder = nn.ModuleList(
            EncoderLayer(d_model, n_heads, n_levels, n_points)
            for _ in range(enc_layers))
        self.query_embed = nn.Parameter(torch.empty(num_queries, 2))
        self.tgt_embed = nn.Parameter(torch.empty(num_queries, d_model))
        self.query_pos_proj = nn.Linear(2, d_model)
        self.decoder = nn.ModuleList(
            DecoderLayer(d_model, n_heads, n_levels, n_points)
            for _ in range(dec_layers))
        # without poly refinement every layer shares one set of heads
        n_sets = dec_layers if with_poly_refine else 1
        self.coords_mlp0 = nn.ModuleList(nn.Linear(d_model, d_model)
                                         for _ in range(n_sets))
        self.coords_mlp1 = nn.ModuleList(nn.Linear(d_model, d_model)
                                         for _ in range(n_sets))
        self.coords_embed = nn.ModuleList(nn.Linear(d_model, 2)
                                          for _ in range(n_sets))
        self.class_embed = nn.ModuleList(nn.Linear(d_model, 1)
                                         for _ in range(n_sets))
        self.room_class_embed = (nn.Linear(d_model, semantic_classes)
                                 if semantic_classes > 0 else None)
        self.init_weights(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX model's initializers: zero kernels for the sampling
        offsets, attention weights and coordinate deltas; the class bias
        -log(0.99 / 0.01); Xavier-uniform FFNs and self-attention;
        normal(1.0) embeddings; LeCun-normal (truncated at 2 std) every
        other kernel; zero biases, unit norm gains."""
        xavier, zeros = set(), {id(m.weight) for m in self.coords_embed}
        for mod in self.modules():
            if isinstance(mod, (EncoderLayer, DecoderLayer)):
                xavier |= {id(mod.ffn_in.weight), id(mod.ffn_out.weight)}
            elif isinstance(mod, SelfAttention):
                xavier |= {id(m.weight) for m in (mod.query, mod.key,
                                                  mod.value, mod.out)}
            elif isinstance(mod, MSDeformAttnLayer):
                zeros |= {id(mod.sampling_offsets.weight),
                          id(mod.attn_weights.weight)}
        for name, p in self.named_parameters():
            if name in ("level_embed", "query_embed", "tgt_embed"):
                p.normal_(0.0, 1.0, generator=generator)
            elif p.dim() == 1:  # biases; norm gains are set below
                p.zero_()
            elif id(p) in zeros:
                p.zero_()
            elif id(p) in xavier:
                nn.init.xavier_uniform_(p, generator=generator)
            else:  # flax lecun_normal: truncated normal, fan-in variance
                std = math.sqrt(1.0 / p[0].numel()) / .87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
        for mod in self.modules():
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
        for head in self.class_embed:
            head.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, density: torch.Tensor) -> RoomFormerOutput:
        """density: [B, H, W, 1] (NHWC, as the dataset gives it)."""
        b = density.shape[0]
        d, dev = self.d_model, density.device
        qp = self.num_queries // self.num_polys
        feats = self.backbone(density.permute(0, 3, 1, 2))
        feats.append(self.extra_level(feats[-1]))

        srcs, poss, shapes, refs = [], [], [], []
        for li, f in enumerate(feats):
            s = self.input_norm[li](self.input_proj[li](f))
            h, w = s.shape[-2:]
            shapes.append((h, w))
            pos = sine_position_2d(h, w, d, device=dev) + self.level_embed[li]
            srcs.append(s.flatten(2).transpose(1, 2))
            poss.append(pos.reshape(1, h * w, d).expand(b, -1, -1))
            ys, xs = torch.meshgrid(
                (torch.arange(h, device=dev) + 0.5) / h,
                (torch.arange(w, device=dev) + 0.5) / w, indexing="ij")
            refs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat(poss, dim=1)
        enc_ref = torch.cat(refs, 0)[None].expand(b, -1, -1).float()

        for layer in self.encoder:
            src = layer(src, pos, enc_ref, shapes)

        tgt = self.tgt_embed[None].expand(b, -1, -1)
        ref = torch.sigmoid(self.query_embed)[None].expand(b, -1, -1)
        query_pos = self.query_pos_proj(
            self.query_embed[None].expand(b, -1, -1))
        attend = None
        if self.masked_attn:
            # attention only within a polygon (reference roomformer.py:108-115)
            qids = torch.arange(self.num_queries, device=dev) // qp
            attend = qids[:, None] == qids[None, :]

        logits_layers, coords_layers = [], []
        for i, layer in enumerate(self.decoder):
            tgt = layer(tgt, query_pos, ref, src, shapes, attend)
            k = i if self.with_poly_refine else 0
            delta = self.coords_embed[k](F.relu(self.coords_mlp1[k](
                F.relu(self.coords_mlp0[k](tgt)))))
            ref = torch.sigmoid(inverse_sigmoid(ref) + delta)
            if i < self.dec_layers - 1:
                ref = ref.detach()
            logit = self.class_embed[k](tgt)[..., 0]
            logits_layers.append(logit.reshape(b, self.num_polys, qp))
            coords_layers.append(ref.reshape(b, self.num_polys, qp, 2))

        room_logits = None
        if self.room_class_embed is not None:
            pooled = tgt.reshape(b, self.num_polys, qp, d).mean(2)
            room_logits = self.room_class_embed(pooled)
        return RoomFormerOutput(torch.stack(logits_layers),
                                torch.stack(coords_layers), room_logits)


# --- the JAX package's parameters -> the port's state_dict -----------------

_BLOCK_CHILDREN = {"Conv_0": "conv1", "GroupNorm_0": "norm1",
                   "Conv_1": "conv2", "GroupNorm_1": "norm2",
                   "Conv_2": "proj", "GroupNorm_2": "proj_norm"}
# Flax names a module when it is constructed: the outer Dense of each FFN
# (d_ffn -> D) is built first, so it is Dense_0
_ENC_CHILDREN = {"MSDeformAttnLayer_0": "attn", "LayerNorm_0": "norm1",
                 "LayerNorm_1": "norm2", "Dense_0": "ffn_out",
                 "Dense_1": "ffn_in"}
_DEC_CHILDREN = {"MultiHeadDotProductAttention_0": "self_attn",
                 "LayerNorm_0": "norm1", "MSDeformAttnLayer_0": "cross_attn",
                 "LayerNorm_1": "norm2", "LayerNorm_2": "norm3",
                 "Dense_0": "ffn_out", "Dense_1": "ffn_in"}
_DEFORM_CHILDREN = ("value_proj", "sampling_offsets", "attn_weights",
                    "output_proj")
_MHA_CHILDREN = ("query", "key", "value", "out")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(path: Tuple[str, ...]) -> str:
    """Port module path of the Flax module path `path` (leaf excluded)."""
    top, rest = path[0], path[1:]
    m = re.fullmatch(r"(enc|dec|input_proj|GroupNorm|coords_mlp0|"
                     r"coords_mlp1|coords_embed|class_embed)_(\d+)", top)
    if top == "Backbone2D_0":
        if rest == ("Conv_0",):
            return "backbone.stem"
        if rest == ("GroupNorm_0",):
            return "backbone.stem_norm"
        b = re.fullmatch(r"ResBlock2D_(\d+)", rest[0])
        if b and len(rest) == 2 and rest[1] in _BLOCK_CHILDREN:
            return f"backbone.blocks.{b[1]}.{_BLOCK_CHILDREN[rest[1]]}"
    elif m and m[1] in ("enc", "dec"):
        table = _ENC_CHILDREN if m[1] == "enc" else _DEC_CHILDREN
        layer = ("encoder" if m[1] == "enc" else "decoder") + f".{m[2]}"
        if rest and rest[0] in table:
            child = f"{layer}.{table[rest[0]]}"
            inner = (_MHA_CHILDREN if rest[0].startswith("MultiHead")
                     else _DEFORM_CHILDREN if rest[0].startswith("MSDeform")
                     else ())
            if len(rest) == 1 and not inner:
                return child
            if len(rest) == 2 and rest[1] in inner:
                return f"{child}.{rest[1]}"
    elif m and not rest:
        name = "input_norm" if m[1] == "GroupNorm" else m[1]
        return f"{name}.{m[2]}"
    elif top in ("extra_level", "query_pos_proj", "room_class_embed",
                 "level_embed", "query_embed", "tgt_embed") and not rest:
        return top
    raise KeyError(f"unmapped RoomFormer leaf {'/'.join(path)}")


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if not mods:  # a bare parameter: level_embed, query_embed, tgt_embed
        return _module_name((leaf,)), arr
    mod = _module_name(tuple(mods))
    mha = mods[-1] in _MHA_CHILDREN
    if leaf == "scale":
        return f"{mod}.weight", arr
    if leaf == "bias":
        return f"{mod}.bias", arr.reshape(-1) if mha else arr
    if leaf != "kernel":
        raise KeyError(f"unmapped RoomFormer leaf {'/'.join(path)}")
    if arr.ndim == 4:  # Conv [kh, kw, cin, cout] -> [cout, cin, kh, kw]
        return f"{mod}.weight", arr.transpose(3, 2, 0, 1)
    if mha and mods[-1] == "out":  # [H, hd, D]
        return f"{mod}.weight", arr.reshape(-1, arr.shape[-1]).T
    if mha:  # [D, H, hd]
        return f"{mod}.weight", arr.reshape(arr.shape[0], -1).T
    return f"{mod}.weight", arr.T  # Dense [in, out] -> [out, in]


def flax_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The port's state_dict entries of a Flax `params` tree of the JAX
    RoomFormer (or any tree of its structure: optax's Adam moments),
    mapped by name; raises on a leaf it cannot map."""
    out = {}
    for path, arr in _flatten(params):
        key, val = _leaf(path, arr)
        if key in out:
            raise KeyError(f"two leaves map to {key}")
        out[key] = torch.tensor(np.ascontiguousarray(val, np.float32))
    return out


def load_flax(model: RoomFormer, variables: dict) -> RoomFormer:
    """Load the JAX RoomFormer's Flax variables `{"params": ...}` (numpy
    leaves) into `model`: strict, every port key filled and every shape
    equal."""
    sd = flax_to_state_dict(variables["params"])
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    excess = sorted(set(sd) - set(own))
    if missing or excess:
        raise KeyError(f"RoomFormer weights: missing {missing}, "
                       f"excess {excess}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: flax {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model

