"""Hungarian matching + set criterion (CE / sigmoid-BCE / dice), batched:
the forward of the JAX package's `SetCriterion`
(mask3d_tpu/train/criterion.py).

- matcher costs: C = cost_mask * BCE + cost_class * (-prob) +
  cost_dice * dice (defaults 5/2/2);
- losses: weighted CE with `eos_coef` down-weighting the no-object class;
  per-item mask BCE + dice over matched pairs, normalized by the item's
  instance count (the reference shadows its global `num_masks` with the
  per-item count, which the JAX package reproduces);
- deep supervision: one (matcher + losses) evaluation per mask-module
  output, L = 13 at the flagship;
- under data parallelism (an active mesh with `dp` ranks) each rank's
  batch is its slice of the global one: the mask and dice losses are sums
  over items and need nothing, and the CE divides by the GLOBAL weight sum
  (`ce_denominators`), so the ranks' losses and gradients sum to the
  global batch's;
- under sequence parallelism the train-mode model's masks are this sp
  rank's chunk of the points (`Mask3DOutput.chunks`): the targets' masks
  and the point validity are sliced to it, and every sum over points is
  summed over `sp` before it is used: the matching costs' (no gradient:
  every rank solves the same problems and gets the same assignment), and
  the losses' in one `comm.sum_partials` (the sum forward, the gradient as
  it is backward), so each rank's loss is the one-process loss and its
  gradient of its mask logits is theirs.

The costs of all L levels are computed on the device, and one call of
`ops/lsap.py` solves every (level x item) problem: with
`matcher.lsap_method=device` (the default) the Jonker-Volgenant kernel on
the card, with no host round trip; with `host` scipy, one copy down and one
up. Everything
is masked for padding: invalid points contribute nothing, invalid (padded)
instances get a constant matching cost and are dropped from the losses. The
losses are plain tensor code, so autograd can differentiate them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mask3d_tpu_torch.data.batch import Targets
from mask3d_tpu_torch.models.mask3d import Mask3DOutput
from mask3d_tpu_torch.ops.lsap import linear_sum_assignment
from mask3d_tpu_torch.parallel import comm
from mask3d_tpu_torch.parallel.mesh import dp_coords

_INVALID_COST = 1e4  # column-constant cost for padded instances (fp32-safe)


# from mask3d_tpu/train/criterion.py:37 batch_sigmoid_ce_cost, as its sums
# over points and the mean formed from them
def _bce_cost_sums(logits, tgt, point_valid):
    """Pairwise BCE summed over points [B, Q, I] and the point count [B].
    logits: [B, N, Q]; tgt: bool[B, I, N]; point_valid: bool[B, N]."""
    x = logits.float()
    pv = point_valid.float()[..., None]  # [B, N, 1]
    # BCE(x, 1) = softplus(-x); BCE(x, 0) = softplus(x)
    pos = F.softplus(-x) * pv
    neg = F.softplus(x) * pv
    t = tgt.float()
    ce = torch.einsum("bnq,bin->bqi", pos, t) + torch.einsum(
        "bnq,bin->bqi", neg * pv, (1.0 - t) * point_valid.float()[:, None])
    return ce, pv.sum(dim=(1, 2))


def _bce_cost(ce, n):
    """The pairwise mean-BCE cost over the item's true point count."""
    return ce / n.clamp(min=1.0)[:, None, None]


# from mask3d_tpu/train/criterion.py:57 batch_dice_cost, likewise
def _dice_cost_sums(logits, tgt, point_valid):
    """(sum of p * t [B, Q, I], of p [B, Q], of t [B, I]) over points."""
    pv = point_valid.float()
    p = torch.sigmoid(logits.float()) * pv[..., None]
    t = tgt.float() * pv[:, None]
    return torch.einsum("bnq,bin->bqi", p, t), p.sum(dim=1), t.sum(dim=-1)


def _dice_cost(pt, psum, tsum):
    """The pairwise dice cost [B, Q, I]."""
    num = 2.0 * pt
    den = psum[:, :, None] + tsum[:, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def _invert(col4row, matched, n_inst: int):
    """(the query serving each target instance [B, I], whether one does):
    columns are assigned at most once; unmatched queries write to the
    dropped extra column."""
    b, q = col4row.shape
    dev = col4row.device
    rows = torch.arange(q, device=dev)[None].expand(b, q)
    write_col = torch.where(matched, col4row,
                            torch.full_like(col4row, n_inst))
    inv = torch.zeros(b, n_inst + 1, dtype=torch.long, device=dev
                      ).scatter(1, write_col, rows)[:, :n_inst]
    has = torch.zeros(b, n_inst + 1, dtype=torch.bool, device=dev
                      ).scatter(1, write_col, True)[:, :n_inst]
    return inv, has


# from mask3d_tpu/train/criterion.py:67 SetCriterion
class SetCriterion:
    """Matcher + criterion over every mask-module output."""

    def __init__(
        self,
        num_classes: int = 1,
        cost_class: float = 2.0,
        cost_mask: float = 5.0,
        cost_dice: float = 2.0,
        eos_coef: float = 0.1,
        class_weights: Optional[Sequence[float]] = None,
        ignore_mask_idx: Sequence[int] = (),
        lsap_method: str = "device",
    ):
        self.num_classes = num_classes
        self.cost_class = cost_class
        self.cost_mask = cost_mask
        self.cost_dice = cost_dice
        self.eos_coef = eos_coef
        self.ignore_mask_idx = tuple(ignore_mask_idx)
        self.lsap_method = lsap_method
        w = np.ones(num_classes + 1, np.float32)
        w[-1] = eos_coef
        if class_weights is not None and class_weights != -1:
            assert len(class_weights) == num_classes
            w[:-1] = class_weights
        self.empty_weight = torch.from_numpy(w)

    # ---- matching ----

    def match_costs(self, pred_class, targets: Targets, sums):
        """One level's matching cost [B, Q, I]. pred_class [B, Q, C+1];
        `sums`: the level's sums over points of its mask costs
        (`mask_cost_sums`), over every rank that holds points."""
        ce, n, pt, psum, tsum = sums
        prob = torch.softmax(pred_class.float(), dim=-1)
        b, q = prob.shape[:2]
        safe_labels = targets.labels.long().clamp(0, self.num_classes)
        # cost_class[b, q, i] = -prob[b, q, label_i]
        cost_class = -torch.gather(
            prob, -1, safe_labels[:, None, :].expand(b, q, -1))
        cost = (
            self.cost_mask * _bce_cost(ce, n)
            + self.cost_class * cost_class
            + self.cost_dice * _dice_cost(pt, psum, tsum)
        )
        return torch.where(targets.valid[:, None, :], cost,
                           torch.full_like(cost, _INVALID_COST))

    @staticmethod
    def mask_cost_sums(pred_masks, targets: Targets, point_valid):
        """A level's sums over points of the mask costs, without gradient:
        [BCE sums [B, Q, I], point count [B], sum of p * t [B, Q, I], of p
        [B, Q], of t [B, I]]."""
        with torch.no_grad():
            return [*_bce_cost_sums(pred_masks, targets.masks, point_valid),
                    *_dice_cost_sums(pred_masks, targets.masks,
                                     point_valid)]

    # from mask3d_tpu/train/criterion.py:99 match
    def match(self, costs, targets: Targets):
        """All levels at once: costs f32[L, B, Q, I] -> (col4row i64[L, B,
        Q], matched bool[L, B, Q]): the target instance assigned to each
        query, dropped where it points at padding. One solve for every
        problem, on the costs' device with `lsap_method="device"`."""
        col4row = linear_sum_assignment(costs, self.lsap_method).long()
        n_inst = targets.valid.shape[-1]
        in_range = col4row < n_inst
        safe_col = torch.where(in_range, col4row, torch.zeros_like(col4row))
        valid = targets.valid[None].expand(col4row.shape[0], -1, -1)
        matched = in_range & torch.gather(valid, -1, safe_col)
        return safe_col, matched

    # ---- losses ----

    def ce_weights(self, targets: Targets, col4row, matched):
        """The matched class of every query ([..., B, Q]) and its CE
        weight."""
        labels = targets.labels.long().expand(col4row.shape[:-1] + (-1,))
        tgt_cls = torch.where(
            matched, torch.gather(labels, -1, col4row),
            torch.full_like(col4row, self.num_classes))
        return tgt_cls, self.empty_weight.to(col4row.device)[tgt_cls]

    def ce_denominators(self, w):
        """The CE normaliser of each level, w [L, B, Q] -> [L]: the weight
        sum over the GLOBAL batch, summed over the active mesh's `dp` ranks
        (one all-reduce, outside autograd: the weights come from the
        assignment). Each rank's CE is then its part of the global
        weighted mean, and the summed gradients are the global batch's,
        as JAX's SPMD step computes them."""
        den = w.sum(dim=(1, 2)).detach()
        _, _, group = dp_coords()
        if group is not None:
            den = comm.all_reduce(den.clone(), group=group, name="ce_norm")
        return den

    # from mask3d_tpu/train/criterion.py:140 loss_labels
    def loss_labels(self, pred_class, tgt_cls, w, den):
        """Weighted CE, normalized by the weight sum `den` as torch's
        `F.cross_entropy(weight=w)` is (`ce_denominators`)."""
        logp = torch.log_softmax(pred_class.float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt_cls[..., None])[..., 0]
        return (nll * w).sum() / den.clamp(min=1e-8)

    # from mask3d_tpu/train/criterion.py:154 loss_masks, as its sums over
    # points and the losses formed from them
    @staticmethod
    def mask_loss_sums(pred_masks, targets: Targets, col4row, matched,
                       point_valid):
        """A level's sums over points of the matched pairs' losses: [B, I,
        4] (BCE, p * t, p, t) and the point count [B, 1]."""
        inv, _ = _invert(col4row, matched, targets.labels.shape[-1])
        # each matched query's mask logits: [B, I, N]
        pm = pred_masks.float().transpose(1, 2)  # [B, Q, N]
        pred_m = torch.gather(pm, 1, inv[..., None].expand(-1, -1,
                                                           pm.shape[-1]))
        tgt_m = targets.masks.float()
        pv = point_valid.float()[:, None, :]  # [B, 1, N]
        bce = F.softplus(pred_m) - pred_m * tgt_m  # elementwise BCE
        p = torch.sigmoid(pred_m) * pv
        t = tgt_m * pv
        sums = torch.stack([(bce * pv).sum(dim=-1), (p * t).sum(dim=-1),
                            p.sum(dim=-1), t.sum(dim=-1)], dim=-1)
        return sums, pv.sum(dim=-1)

    @staticmethod
    def mask_losses(sums, npts, targets: Targets, col4row, matched):
        """(loss_mask, loss_dice) of a level from `mask_loss_sums`: per-item
        matched BCE + dice."""
        _, has = _invert(col4row, matched, targets.labels.shape[-1])
        pair_ok = (has & targets.valid).float()  # [B, I]
        bce = sums[..., 0] / npts.clamp(min=1.0)  # [B, I] mean over points
        num = 2.0 * sums[..., 1]
        den = sums[..., 2] + sums[..., 3]
        dice = 1.0 - (num + 1.0) / (den + 1.0)  # [B, I]

        # the normalizer is the item's ground-truth instance count
        n_gt = targets.valid.sum(dim=-1).clamp(min=1)[..., None]
        loss_mask = (bce * pair_ok / n_gt).sum()
        loss_dice = (dice * pair_ok / n_gt).sum()
        return loss_mask, loss_dice

    # from mask3d_tpu/train/criterion.py:210 __call__
    def __call__(self, output: Mask3DOutput, targets: Targets,
                 point_valid, ce_scale: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
        """All-level losses: loss_ce/loss_mask/loss_dice for the final
        output, *_mask_module_{i} for the auxiliary outputs, and the total
        "loss" weighted by the matcher costs (levels in `ignore_mask_idx`
        weigh 0). `ce_scale` multiplies the CE terms in the total only:
        gradient accumulation over K micro-batches passes 1/K, since the
        mask and dice losses are sums over items and CE is a batch mean.
        Only the matching costs are detached; the losses keep their
        graph. With `output.chunks` (train mode under sp) the masks are this
        rank's chunk of the points: see the module docstring."""
        n_levels = output.aux_pred_class.shape[0]
        if output.aux_pred_masks.shape[0] != n_levels:
            raise ValueError(
                f"{n_levels} class outputs but "
                f"{output.aux_pred_masks.shape[0]} mask outputs: run the "
                "model with aux_masks=True")
        chunks = output.chunks
        if chunks is not None:  # this rank's chunk of the points
            n = point_valid.shape[1]
            point_valid = chunks.take(point_valid, n)
            targets = dataclasses.replace(
                targets, masks=chunks.take(targets.masks, n, dim=2))
        cost_sums = [self.mask_cost_sums(pm, targets, point_valid)
                     for pm in output.aux_pred_masks]
        if chunks is not None:
            comm.flat_all_reduce([t for s in cost_sums for t in s],
                                 chunks.group, "criterion_costs")
        costs = torch.stack([
            self.match_costs(pc, targets, s)
            for pc, s in zip(output.aux_pred_class, cost_sums)])
        col4row, matched = self.match(costs, targets)
        tgt_cls, w = self.ce_weights(targets, col4row, matched)
        den = self.ce_denominators(w)
        parts = [self.mask_loss_sums(pm, targets, c4r, m, point_valid)
                 for pm, c4r, m in zip(output.aux_pred_masks, col4row,
                                       matched)]
        sums = torch.stack([p[0] for p in parts])  # [L, B, I, 4]
        npts = parts[0][1]  # [B, 1], the same at every level
        if chunks is not None:
            flat = comm.sum_partials(
                torch.cat([sums.reshape(-1), npts.reshape(-1)]),
                chunks.group, "criterion_losses")
            sums = flat[:sums.numel()].view_as(sums)
            npts = flat[sums.numel():].view_as(npts)
        per_level = torch.stack([
            torch.stack([
                self.loss_labels(pc, tc, wl, dl),
                *self.mask_losses(sl, npts, targets, c4r, m)])
            for pc, sl, c4r, m, tc, wl, dl in zip(
                output.aux_pred_class, sums, col4row, matched, tgt_cls, w,
                den)])  # [L, 3]

        losses: Dict[str, torch.Tensor] = {
            "loss_ce": per_level[-1, 0],
            "loss_mask": per_level[-1, 1],
            "loss_dice": per_level[-1, 2],
        }
        w = torch.tensor(
            [self.cost_class * ce_scale, self.cost_mask, self.cost_dice],
            dtype=torch.float32, device=per_level.device)
        ignored = {i % n_levels for i in self.ignore_mask_idx}
        level_w = torch.tensor(
            [0.0 if i in ignored else 1.0 for i in range(n_levels)],
            dtype=torch.float32, device=per_level.device)
        total = (per_level * w[None, :] * level_w[:, None]).sum()
        for i in range(n_levels - 1):
            losses[f"loss_ce_mask_module_{i}"] = per_level[i, 0]
            losses[f"loss_mask_mask_module_{i}"] = per_level[i, 1]
            losses[f"loss_dice_mask_module_{i}"] = per_level[i, 2]
        losses["loss"] = total
        return losses


# from mask3d_tpu/train/loop.py:89 make_criterion
def make_criterion(cfg) -> SetCriterion:
    """The criterion of `cfg.matcher` and `cfg.loss`."""
    cw = cfg.loss.class_weights
    return SetCriterion(
        num_classes=cfg.general.num_targets,
        cost_class=cfg.matcher.cost_class,
        cost_mask=cfg.matcher.cost_mask,
        cost_dice=cfg.matcher.cost_dice,
        eos_coef=cfg.loss.eos_coef,
        class_weights=None if cw == -1 else cw,
        ignore_mask_idx=cfg.general.ignore_mask_idx,
        lsap_method=cfg.matcher.lsap_method,
    )
