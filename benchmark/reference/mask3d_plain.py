"""Plain reference of Mask3D on a Res16UNet backbone, at inference.

Straight PyTorch over one scene at a time, in float32 (TF32 off) or, for
the control, with every matmul operand rounded to float8 (e4m3, one scale
per tensor). It imports nothing of the measured program: it voxelizes the
raw points, builds the sparse pyramid, the kernel maps and the pooled
pyramids itself, from the architecture in a configuration file
(`benchmark/configs/*.json`, key "architecture") and the weights that
`benchmark/weights.py` draws (named as the program's parameters).

What it computes, per scene, with `cap` the padded row capacity of each
level (the program attends over its padded levels, so the fully blocked
query's uniform average runs over them too):

- voxels: points truncated toward zero, shifted to the origin, unique,
  sorted by (x, y, z); level l+1 = unique(level l >> 1);
- a same-stride k^3 conv: out[p] = sum_d x[p + d] @ W[:, :, d + r]^T over
  the present neighbours; a stride-2 conv: out[c] = sum over the children
  j of c of x[j] @ W[:, :, (x&1, y&1, z&1) of j]^T; the transposed conv:
  out[j] = x[parent(j)] @ W[:, :, child position of j];
- InstanceNorm over a scene's rows (eps 1e-5), relu, the UNet's skips;
- the decoder: FPS query positions (first row first, ties to the first
  maximum), Fourier positional encodings normalized by each level's
  min/max, masked cross-attention over levels 4, 3, 2, 1 (a row is blocked
  where the sigmoid of its pooled mask logit is under 0.5, the padding
  rows always; a query blocked on every row of a level with no padding
  rows is unblocked), self-attention, FFN, post-norm LayerNorms (eps 1e-6).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

F8_MAX = 448.0  # largest finite float8 e4m3fn


class Numerics:
    """How a matmul's operands are rounded: "fp32" (none), "tf32" (to the
    10-bit mantissa of TF32, to nearest, as the tensor cores read float32
    with TF32 on) or "fp8"."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def _q(self, t):
        if self.precision == "fp32" or t.numel() == 0:
            return t
        if self.precision == "tf32":
            bits = t.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        s = t.abs().amax().clamp_min(1e-30) / F8_MAX
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def mm(self, x, w):
        return self._q(x) @ self._q(w)

    def linear(self, x, p, name):
        y = self.mm(x, p[f"{name}.weight"].t())
        return y + p[f"{name}.bias"]


# -- the sparse pyramid -----------------------------------------------------

def voxelize(points: np.ndarray):
    """(coords i64[n, 3] unique and sorted by (x, y, z), dims i64[3])."""
    ci = points.astype(np.int32).astype(np.int64)
    ci = ci - ci.min(axis=0)
    uniq = np.unique(ci, axis=0)
    return uniq, uniq.max(axis=0) + 1


def cube(radius: int) -> np.ndarray:
    """Offsets of a (2r+1)^3 kernel, x slowest, z fastest."""
    r = np.arange(-radius, radius + 1)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], 1)


class Level:
    """One level of one scene: its sorted coords and its lookups."""

    def __init__(self, coords: np.ndarray, dims: np.ndarray, device):
        self.coords = coords
        self.dims = dims
        self.n = len(coords)
        self.device = device
        self._c = torch.as_tensor(coords, device=device)
        self._d = torch.as_tensor(dims, device=device)
        self.key = self._key(self._c)
        self._maps = {}

    def _key(self, c):
        return (c[..., 0] * self._d[1] + c[..., 1]) * self._d[2] + c[..., 2]

    def neighbours(self, radius: int) -> torch.Tensor:
        """i64[n, (2r+1)^3]: the row at coords + offset, -1 where none."""
        if radius not in self._maps:
            offs = torch.as_tensor(cube(radius), device=self.device)
            cols = []
            for d in offs:
                c = self._c + d
                inside = ((c >= 0) & (c < self._d)).all(dim=1)
                key = self._key(torch.where(inside[:, None], c, 0))
                pos = torch.searchsorted(self.key, key).clamp(max=self.n - 1)
                hit = inside & (self.key[pos] == key)
                cols.append(torch.where(hit, pos, -1))
            self._maps[radius] = torch.stack(cols, dim=1)
        return self._maps[radius]


def pyramid(coords: np.ndarray, dims: np.ndarray, caps: Sequence[int],
            device):
    """(levels, parent maps): levels[0] is the scene; parents[l] holds,
    for each row of levels[l], its row in levels[l + 1] and its child
    position (x&1)*4 + (y&1)*2 + (z&1). Raises where a level exceeds its
    capacity: the program drops such rows, which no traffic here asks
    for."""
    levels = [Level(coords, dims, device)]
    parents = []
    for cap in caps:
        fine = levels[-1]
        half = fine.coords >> 1
        uniq, inv = np.unique(half, axis=0, return_inverse=True)
        if len(uniq) > cap:
            raise ValueError(f"a level of {len(uniq)} rows exceeds its "
                             f"capacity {cap}")
        kidx = ((fine.coords[:, 0] & 1) * 4 + (fine.coords[:, 1] & 1) * 2
                + (fine.coords[:, 2] & 1))
        child = np.full((len(uniq), 8), -1, np.int64)
        child[inv.ravel(), kidx] = np.arange(fine.n)
        parents.append(dict(
            parent=torch.as_tensor(inv.ravel(), device=device),
            kidx=torch.as_tensor(kidx, device=device),
            child=torch.as_tensor(child, device=device)))
        levels.append(Level(uniq, ((fine.dims - 1) >> 1) + 1, device))
    return levels, parents


def level_capacities(n_cap: int, ratios: Sequence[float]) -> List[int]:
    return [max(8, int(n_cap * r)) for r in ratios]


# -- the backbone -----------------------------------------------------------

class Backbone:
    """Res16UNet (basic or bottleneck blocks) over one scene's levels."""

    def __init__(self, arch: dict, params: Dict[str, torch.Tensor],
                 num: Numerics, prefix: str = "backbone."):
        self.a = arch
        self.p = params
        self.num = num
        self.pre = prefix

    def w(self, name):
        return self.p[f"{self.pre}convs.{name}.weight"]

    def has(self, name):
        return f"{self.pre}convs.{name}.weight" in self.p

    def conv(self, x, name, level: Level):
        """Same-stride conv, k^3 with k from the weight."""
        w = self.w(name)
        k = w.shape[-1]
        if k == 1:
            return self.num.mm(x, w[:, :, 0, 0, 0].t())
        nbr = level.neighbours(k // 2)
        taps = w.permute(2, 3, 4, 1, 0).reshape(k ** 3, w.shape[1],
                                                w.shape[0])
        out = x.new_zeros((x.shape[0], w.shape[0]))
        zero = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        for d in range(k ** 3):
            idx = nbr[:, d]
            g = zero[torch.where(idx >= 0, idx, x.shape[0])]
            out = out + self.num.mm(g, taps[d])
        return out

    def conv_down(self, x, name, pmap):
        w = self.w(name)  # [Cout, Cin, 2, 2, 2]
        taps = w.permute(2, 3, 4, 1, 0).reshape(8, w.shape[1], w.shape[0])
        zero = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        child = pmap["child"]
        out = None
        for k in range(8):
            idx = torch.where(child[:, k] >= 0, child[:, k], x.shape[0])
            y = self.num.mm(zero[idx], taps[k])
            out = y if out is None else out + y
        return out

    def conv_tr(self, x, name, pmap, n_fine: int):
        w = self.w(name)  # [Cin, Cout, 2, 2, 2]
        taps = w.permute(2, 3, 4, 0, 1).reshape(8, w.shape[0], w.shape[1])
        out = x.new_zeros((n_fine, w.shape[1]))
        g = x[pmap["parent"]]
        for k in range(8):
            sel = pmap["kidx"] == k
            out[sel] = self.num.mm(g[sel], taps[k])
        return out

    def norm(self, x, name):
        g = self.p[f"{self.pre}norms.{name}.weight"]
        b = self.p[f"{self.pre}norms.{name}.bias"]
        mean = x.mean(dim=0, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * g + b

    def block(self, x, name, level):
        if self.a["block"] == "bottleneck":
            out = torch.relu(self.norm(self.conv(x, f"{name}_conv1", level),
                                       f"{name}_norm1"))
            out = torch.relu(self.norm(self.conv(out, f"{name}_conv2",
                                                 level), f"{name}_norm2"))
            out = self.norm(self.conv(out, f"{name}_conv3", level),
                            f"{name}_norm3")
        else:
            out = torch.relu(self.norm(self.conv(x, f"{name}_conv1", level),
                                       f"{name}_norm1"))
            out = self.norm(self.conv(out, f"{name}_conv2", level),
                            f"{name}_norm2")
        res = x
        if self.has(f"{name}_downsample"):
            res = self.norm(self.conv(x, f"{name}_downsample", level),
                            f"{name}_downsample_norm")
        return torch.relu(out + res)

    def stage(self, x, stage, level):
        for i in range(self.a["layers"][stage - 1]):
            x = self.block(x, f"block{stage}_{i}", level)
        return x

    def __call__(self, feats, levels, parents):
        """Returns the feature maps as rows at strides 16, 8, 4, 2, 1."""
        out = self.conv(feats, "conv0p1s1", levels[0])
        out = torch.relu(self.norm(out, "bn0"))
        skips = {0: out}
        for i in range(4):
            name = f"conv{i + 1}p{2 ** i}s2"
            out = self.conv_down(out, name, parents[i])
            out = torch.relu(self.norm(out, name.replace("conv", "bn")))
            out = self.stage(out, i + 1, levels[i + 1])
            skips[i + 1] = out
        maps = [out]
        for i in range(4):
            coarse = 4 - i
            name = f"convtr{i + 4}p{2 ** coarse}s2"
            out = self.conv_tr(out, name, parents[coarse - 1],
                               levels[coarse - 1].n)
            out = torch.relu(self.norm(out, name.replace("convtr", "bntr")))
            out = torch.cat([out, skips[coarse - 1]], dim=1)
            out = self.stage(out, i + 5, levels[coarse - 1])
            maps.append(out)
        return maps


# -- the decoder ------------------------------------------------------------

def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps=1e-6)


def fourier(xyz, gauss_b, mins, maxs):
    rng = maxs - mins
    rng = torch.where(rng == 0, torch.ones_like(rng), rng)
    x = (xyz - mins) / rng * (2.0 * math.pi)
    proj = x @ gauss_b
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def fps(coords, q: int):
    """Furthest-point sampling from row 0; ties to the first maximum."""
    n = coords.shape[0]
    idx = torch.zeros(q, dtype=torch.long, device=coords.device)
    dist = torch.full((n,), 1e10, device=coords.device)
    for i in range(q):
        if i > 0:
            idx[i] = torch.argmax(dist)
        d = ((coords - coords[idx[i]]) ** 2).sum(dim=-1)
        dist = torch.minimum(dist, d)
    return idx


def mean_pool(x, pmap):
    zero = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    child = pmap["child"]
    n_fine = x.shape[0]
    idx = torch.where(child >= 0, child, n_fine)
    s = zero[idx].sum(dim=1)
    cnt = (child >= 0).sum(dim=1, keepdim=True).clamp_min(1)
    return s / cnt


class Decoder:
    def __init__(self, arch: dict, params, num: Numerics):
        self.a = arch
        self.p = params
        self.num = num

    def lin(self, x, name):
        return self.num.linear(x, self.p, name)

    def mha(self, q, k, v, name, blocked=None, n_pad=0, v_pad=None):
        """Multi-head attention of one scene: q [Q, D], k/v [S, D];
        `blocked` bool[Q, S] (True: not attended); `n_pad` padding rows
        with value `v_pad` [D], always blocked."""
        h = self.a["num_heads"]
        d = q.shape[-1]
        hd = d // h
        wq = self.lin(q, f"{name}.q").reshape(-1, h, hd).transpose(0, 1)
        if k is None:
            wk, wv = self.kv
        else:
            wk = self.lin(k, f"{name}.k")
            wv = self.lin(v, f"{name}.v")
        wk = wk.reshape(-1, h, hd).transpose(0, 1)
        wv_h = wv.reshape(-1, h, hd).transpose(0, 1)
        logits = torch.einsum("hqd,hkd->hqk", self.num._q(wq),
                              self.num._q(wk)) / math.sqrt(hd)
        if blocked is None:
            att = torch.softmax(logits, dim=-1)
            out = torch.einsum("hqk,hkd->hqd", att, self.num._q(wv_h))
        else:
            logits = logits.masked_fill(blocked[None], -1e9)
            # padding rows: logit -1e9, value v_pad
            pad = torch.full(logits.shape[:2] + (1,), -1e9,
                             device=logits.device)
            mx = torch.maximum(logits.amax(dim=-1, keepdim=True), pad)
            e = torch.exp(logits - mx)
            e_pad = torch.exp(pad - mx) * n_pad
            den = e.sum(dim=-1, keepdim=True) + e_pad
            vp = v_pad.reshape(h, 1, hd)
            out = (torch.einsum("hqk,hkd->hqd", e, self.num._q(wv_h))
                   + e_pad * vp) / den
        out = out.transpose(0, 1).reshape(-1, d)
        return self.lin(out, f"{name}.out")

    def __call__(self, maps, levels, parents, caps_all):
        """maps: rows at strides 16..1; returns (the class logits of
        every mask-module call [L, Q, C+1], the last the prediction;
        pred_masks [n0, Q]). Keeps the FPS positions in `query_xyz` and
        each call's normalized queries in `embeds`."""
        a, p = self.a, self.p
        nl = len(levels)
        coords0 = torch.as_tensor(levels[0].coords, dtype=torch.float32,
                                  device=maps[-1].device)
        mask_feats = self.lin(maps[-1], "mask_features_head")
        coords_pyr, mf_pyr = [coords0], [mask_feats]
        for li in range(nl - 1):
            coords_pyr.append(mean_pool(coords_pyr[-1], parents[li]))
            mf_pyr.append(mean_pool(mf_pyr[-1], parents[li]))
        gb = p["gauss_B"]
        minmax = [(c.amin(dim=0), c.amax(dim=0)) for c in coords_pyr]
        fm_level = [nl - 1 - i for i in range(nl)]
        idx = fps(coords0, a["num_queries"])
        self.query_xyz = coords0[idx]
        qpe = fourier(coords0[idx], gb, *minmax[0])
        query_pos = torch.relu(self.lin(torch.relu(
            self.lin(qpe, "query_proj_hidden")), "query_proj_out"))
        queries = torch.zeros_like(query_pos)
        d = a["hidden_dim"]
        dev = queries.device

        self.mask_feats = mask_feats

        self.embeds = []

        def mask_module(qs, lvl, want_attn=True):
            qn = layer_norm(qs, p, "decoder_norm")
            self.embeds.append(qn)
            me = self.lin(torch.relu(self.lin(qn, "mask_embed_hidden")),
                          "mask_embed_out")
            cls = self.lin(qn, "class_embed_head")
            if not want_attn:
                return cls, self.num.mm(mask_feats, me.t())
            logit = self.num.mm(mf_pyr[lvl], me.t())  # [S, Q]
            return cls, torch.sigmoid(logit) < 0.5

        kv = {}
        rounds = []
        for _ in range(a["num_decoders"]):
            for li, h in enumerate(a["hlevels"]):
                lvl = fm_level[h]
                cls, blocked = mask_module(queries, lvl)
                rounds.append(cls)
                key = f"0_{li}"
                n, cap = levels[lvl].n, caps_all[lvl]
                if key not in kv:
                    src = self.lin(maps[h], f"squeeze.{key}")
                    pe = fourier(coords_pyr[lvl], gb, *minmax[lvl])
                    src0 = self.lin(torch.zeros(1, maps[h].shape[1],
                                                device=dev), f"squeeze.{key}")
                    kv[key] = (
                        self.lin(src + pe, f"cross.{key}.attn.k"),
                        self.lin(src, f"cross.{key}.attn.v"),
                        self.lin(src0, f"cross.{key}.attn.v")[0])
                wk, wv, vpad = kv[key]
                blocked = blocked.t()  # [Q, S]
                if n == cap:  # no padding row: unblock fully blocked
                    blocked = blocked & ~blocked.all(dim=1, keepdim=True)
                self.kv = (wk, wv)
                t2 = self.mha(queries + query_pos, None, None,
                              f"cross.{key}.attn", blocked, cap - n, vpad)
                queries = layer_norm(queries + t2, p, f"cross.{key}.norm")
                qp = queries + query_pos
                t2 = self.mha(qp, qp, queries, f"self_attn.{key}.attn")
                queries = layer_norm(queries + t2, p,
                                     f"self_attn.{key}.norm")
                t2 = self.lin(torch.relu(self.lin(queries,
                                                  f"ffn.{key}.lin1")),
                              f"ffn.{key}.lin2")
                queries = layer_norm(queries + t2, p, f"ffn.{key}.norm")
        cls, masks = mask_module(queries, 0, want_attn=False)
        return torch.stack(rounds + [cls]), masks


class SceneOut(NamedTuple):
    """The plain model's outputs of one scene."""

    class_rounds: torch.Tensor  # [L, Q, C+1]: every mask-module call's
    masks: torch.Tensor  # [n, Q] over the voxels in (x, y, z) order
    n: int  # voxels
    mask_feats: torch.Tensor  # [n, D]: what `masks` is the product of
    query_xyz: torch.Tensor  # [Q, 3]: the FPS query positions
    embeds: torch.Tensor  # [L, Q, D]: every call's normalized queries

    @property
    def pred_class(self):
        return self.class_rounds[-1]


def forward_scene(points: np.ndarray, n_cap: int, arch: dict, params,
                  precision: str = "fp32", device="cpu") -> SceneOut:
    """One scene through the plain model."""
    num = Numerics(precision)
    coords, dims = voxelize(points)
    caps = level_capacities(n_cap, arch["level_cap_ratios"])
    if len(coords) > n_cap:
        raise ValueError(f"{len(coords)} voxels exceed the capacity {n_cap}")
    levels, parents = pyramid(coords, dims, caps, device)
    feats = torch.ones((len(coords), arch["backbone"]["in_channels"]),
                       device=device)
    maps = Backbone(arch["backbone"], params, num)(feats, levels, parents)
    dec = Decoder(arch["decoder"], params, num)
    rounds, masks = dec(maps, levels, parents, [n_cap] + caps)
    return SceneOut(rounds, masks, len(coords), dec.mask_feats,
                    dec.query_xyz, torch.stack(dec.embeds))
