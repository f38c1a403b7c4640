"""RoomFormer matcher and criterion in PyTorch (the JAX package's
`baseline/criterion2d.py`).

Polygon-level matching and losses of the reference
(`RoomFormer/models/matcher.py:13-107`, `roomformer.py:187-330`,
`losses.py:13-160`):

- matching cost = 5 * cyclic-order-min L1 over the target's valid corner
  coords + 2 * L1 between corner-validity probabilities and labels; padding
  targets cost 1e4
- loss_ce: BCE over ALL corner logits with the matched labels scattered in
- loss_coords: cyclic-min L1 over matched polygons / valid coord count
- loss_raster: dice between the soft-rasterized predicted polygon and the
  hard-rasterized target at 64 x 64
- the aux decoder layers reuse the FINAL layer's assignment

The costs are computed on the model's device and solved by `ops/lsap.py`:
with `lsap_method="device"` (the default, as in the JAX package) its
Jonker-Volgenant kernel on the card, JAX's assignment exactly; with
`"host"` scipy, one copy down and one up.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from mask3d_tpu_torch.baseline.raster import soft_polygon_batch
from mask3d_tpu_torch.ops.lsap import linear_sum_assignment

# from mask3d_tpu/baseline/criterion2d.py:30 _INVALID
_INVALID = 1e4


# from mask3d_tpu/baseline/criterion2d.py:33 cyclic_min_l1
def cyclic_min_l1(src: torch.Tensor, tgt: torch.Tensor,
                  length: torch.Tensor) -> torch.Tensor:
    """Min over the target's cyclic orders of the L1 distance (reference
    `get_all_order_corners` + cdist(p=1).min, `matcher.py:90-96`).

    src: [..., 2Qp]; tgt: [..., 2Qp]; length: int [...] (2 * corners);
    the leading dims broadcast. The rolls stay within the valid window:
    roll i of the target is tgt[(j - 2i) % length]. Returns [...].
    """
    two_qp = tgt.shape[-1]
    qp = two_qp // 2
    dev = tgt.device
    j = torch.arange(two_qp, device=dev)
    i2 = 2 * torch.arange(qp, device=dev)[:, None]
    length = length.to(torch.int64)
    safe_len = length.clamp(min=1)[..., None, None]
    src_idx = torch.remainder(j - i2, safe_len)  # [..., Qp, 2Qp]
    batch = torch.broadcast_shapes(tgt.shape[:-1], length.shape)
    tgt = tgt.expand(*batch, two_qp)
    rolls = torch.gather(tgt[..., None, :].expand(*batch, qp, two_qp), -1,
                         src_idx.expand(*batch, qp, two_qp))
    posmask = (j < length[..., None]).to(src.dtype)  # [..., 2Qp]
    diff = (src[..., None, :] - rolls).abs() * posmask[..., None, :]
    sums = diff.sum(-1)  # [..., Qp]
    rollmask = torch.arange(qp, device=dev) < (length // 2)[..., None]
    return torch.amin(torch.where(rollmask, sums,
                                  torch.full_like(sums, float("inf"))),
                      dim=-1)


def _take(x: torch.Tensor, col4row: torch.Tensor) -> torch.Tensor:
    """x[b, col4row[b, p], ...] for x [B, Pt, ...], col4row [B, P]."""
    idx = col4row.reshape(*col4row.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*col4row.shape, *x.shape[2:]))


# from mask3d_tpu/baseline/criterion2d.py:56 RoomFormerCriterion
class RoomFormerCriterion:
    def __init__(self, cost_class=2.0, cost_coords=5.0, cls_coef=2.0,
                 coords_coef=5.0, raster_coef=1.0, room_cls_coef=0.2,
                 raster_res=64, use_raster=True, lsap_method="device"):
        self.cost_class = cost_class
        self.cost_coords = cost_coords
        self.cls_coef = cls_coef
        self.coords_coef = coords_coef
        self.raster_coef = raster_coef
        self.room_cls_coef = room_cls_coef
        self.raster_res = raster_res
        self.use_raster = use_raster
        self.lsap_method = lsap_method

    # from mask3d_tpu/baseline/criterion2d.py:70 match
    @torch.no_grad()
    def match(self, logits, coords, targets):
        """logits [B, P, Qp]; coords [B, P, Qp, 2]; targets: coords
        [B, Pt, 2Qp], labels [B, Pt, Qp], lengths [B, Pt], poly_valid
        [B, Pt]. Returns (col4row int64 [B, P], matched bool [B, P])."""
        b, p, qp = logits.shape
        prob = torch.sigmoid(logits)
        cost_class = (prob[:, :, None, :]
                      - targets["labels"][:, None, :, :]).abs().sum(-1)
        cost_coords = cyclic_min_l1(coords.reshape(b, p, 1, qp * 2),
                                    targets["coords"][:, None],
                                    targets["lengths"][:, None])
        cost = self.cost_coords * cost_coords + self.cost_class * cost_class
        cost = torch.where(targets["poly_valid"][:, None, :], cost,
                           torch.full_like(cost, _INVALID))
        col4row = linear_sum_assignment(cost, self.lsap_method).long()
        pt = targets["poly_valid"].shape[-1]
        in_range = col4row < pt
        safe = torch.where(in_range, col4row, torch.zeros_like(col4row))
        matched = in_range & torch.gather(targets["poly_valid"], 1, safe)
        return safe, matched

    # from mask3d_tpu/baseline/criterion2d.py:105 level_losses
    def level_losses(self, logits, coords, targets, col4row, matched
                     ) -> Dict[str, torch.Tensor]:
        b, p, qp = logits.shape
        tgt_labels = _take(targets["labels"], col4row)  # [B, P, Qp]
        tgt_labels = torch.where(matched[..., None], tgt_labels,
                                 torch.zeros_like(tgt_labels))
        bce = F.softplus(logits) - logits * tgt_labels
        losses = {"loss_ce": bce.mean()}

        src_flat = coords.reshape(b, p, qp * 2)
        tgt_coords = _take(targets["coords"], col4row)  # [B, P, 2Qp]
        tgt_lens = _take(targets["lengths"], col4row)  # [B, P]
        per_pair = cyclic_min_l1(src_flat, tgt_coords, tgt_lens)
        m = matched.to(torch.float32)
        denom = torch.clamp((tgt_lens * m).sum(), min=1.0)
        losses["loss_coords"] = torch.where(
            matched, per_pair, torch.zeros_like(per_pair)).sum() / denom

        if self.use_raster:
            res = self.raster_res
            vert_valid = (torch.arange(qp, device=logits.device)[None, None]
                          < (tgt_lens // 2)[..., None])
            vv = vert_valid.reshape(b * p, qp)
            pred_masks = soft_polygon_batch(
                coords.reshape(b * p, qp, 2) * res, vv, res,
                inv_smoothness=0.1, mode="mask")
            tgt_masks = soft_polygon_batch(
                tgt_coords.reshape(b * p, qp, 2) * res, vv, res,
                mode="hard_mask")
            pm = pred_masks.reshape(b * p, -1)
            tm = tgt_masks.reshape(b * p, -1)
            num = 2.0 * (pm * tm).sum(-1) + 1.0
            den = pm.sum(-1) + tm.sum(-1) + 1.0
            dice = 1.0 - num / den
            mflat = m.reshape(-1)
            losses["loss_raster"] = (dice * mflat).sum() / torch.clamp(
                mflat.sum(), min=1.0)
        return losses

    def _weighted(self, losses):
        total = (self.cls_coef * losses["loss_ce"]
                 + self.coords_coef * losses["loss_coords"])
        if "loss_raster" in losses:
            total = total + self.raster_coef * losses["loss_raster"]
        return total

    # from mask3d_tpu/baseline/criterion2d.py:160 __call__
    def __call__(self, output, targets, room_labels=None
                 ) -> Dict[str, torch.Tensor]:
        """output: RoomFormerOutput; targets: the padded dict of `match`;
        room_labels: {"labels": int [B, Pt]} where the model classifies
        rooms."""
        col4row, matched = self.match(output.pred_logits,
                                      output.pred_coords, targets)
        losses = dict(self.level_losses(output.pred_logits,
                                        output.pred_coords, targets,
                                        col4row, matched))
        total = self._weighted(losses)
        for i in range(output.aux_logits.shape[0] - 1):
            aux = self.level_losses(output.aux_logits[i],
                                    output.aux_coords[i], targets, col4row,
                                    matched)
            for k, v in aux.items():
                losses[f"{k}_{i}"] = v
            total = total + self._weighted(aux)
        if output.room_logits is not None and room_labels is not None:
            logp = F.log_softmax(output.room_logits, dim=-1)
            tgt = torch.gather(room_labels["labels"].to(torch.int64), 1,
                               col4row)
            tgt = torch.where(matched, tgt, torch.full_like(
                tgt, output.room_logits.shape[-1] - 1))
            nll = -torch.gather(logp, -1, tgt[..., None])
            losses["loss_ce_room"] = nll.mean()
            total = total + self.room_cls_coef * losses["loss_ce_room"]
        losses["loss"] = total
        return losses
