"""Whether what the timed path produced is correct: the plain reference
(`benchmark/reference/`) recomputes the sampled batches' outputs from the
same raw scenes and weights, once the window has closed, and each number
compared is held to its limit in the cell's file (`"limits"`).

The program's outputs judged are those of the sampled batches' forwards
in the window: `pred_class` and `pred_masks`, and, kept by forward hooks
on the model, the class logits of every mask-module call
(`aux_pred_class`, one a decoder round, the last `pred_class` itself),
the FPS query positions (`sampled_coords`) and the normalized queries of
every mask-module call (the outputs of `decoder_norm`).

Numbers (the worst scene of the sampled batches):

- `voxels`: |the program's voxel count - the reference's| (exact, 0);
- `pad`: the largest |mask logit| the program wrote on a padding row
  (exact, 0);
- `fps`: query positions that differ from the reference's (exact, 0);
- `embed_r<k>`: the normalized queries after decoder round k (one masked
  cross-attention, self-attention and FFN each), |queries - reference| /
  |reference| (Frobenius norms); round 0 is the zero queries' and reads 0;
- `class_r<k>`: the class logits after round k, mean |logit - reference|
  / max(1, std of the reference's);
- `class_err`: the same of the final `pred_class`;
- `mask_fit`: the share (residual norm over norm) of the program's mask
  logits that the reference's mask features do not span after a
  least-squares fit of the query embeddings: the sparse batch, decode,
  backbone and mask head, whatever the decoder's queries did;
- `mask_err`: mean |mask logit - reference| / std of the reference's;
- `mask_flip`: the share of (voxel, query) mask logits whose sign differs
  from the reference's;
- `mask_max`: max |mask logit - reference| / std of the reference's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.reference import mask3d_plain


class Outputs(NamedTuple):
    """One batch's outputs, in the program's layout, on the host."""

    rounds: np.ndarray  # [L, B, Q, C+1]: the last is pred_class
    masks: np.ndarray  # [B, N, Q]
    xyz: np.ndarray  # [B, Q, 3]
    counts: np.ndarray  # [B]
    embeds: np.ndarray  # [L, B, Q, D]


def reference_batch(run, items, n_cap: int, precision: str = "fp32"
                    ) -> List[mask3d_plain.SceneOut]:
    """Each scene through the plain model, on the host in float64."""
    out = []
    with torch.no_grad():
        for it in items:
            s = mask3d_plain.forward_scene(
                it["coordinates"], n_cap, run.arch, run.weights(),
                precision=precision, device=run.device)
            out.append(mask3d_plain.SceneOut(
                *(t.cpu().double().numpy() if torch.is_tensor(t) else t
                  for t in s)))
    return out


def as_program(refs: List[mask3d_plain.SceneOut], n_cap: int) -> Outputs:
    """Reference outputs laid out as the program's: the control in the
    program's place."""
    masks = np.zeros((len(refs), n_cap, refs[0].masks.shape[1]))
    for i, s in enumerate(refs):
        masks[i, :s.n] = s.masks
    return Outputs(np.stack([s.class_rounds for s in refs], axis=1), masks,
                   np.stack([s.query_xyz for s in refs]),
                   np.asarray([s.n for s in refs]),
                   np.stack([s.embeds for s in refs], axis=1))


def class_gap(got, ref) -> float:
    return float(np.abs(got - ref).mean() / max(1.0, ref.std()))


def rel_gap(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref)
                 if np.any(ref) else np.linalg.norm(got))


def numbers(got: Outputs, refs: List[mask3d_plain.SceneOut]
            ) -> Dict[str, float]:
    """The compared numbers of one batch."""
    n_rounds = len(got.rounds)
    worst = {"voxels": 0.0, "pad": 0.0, "fps": 0.0, "class_err": 0.0,
             "mask_fit": 0.0, "mask_err": 0.0, "mask_flip": 0.0,
             "mask_max": 0.0}
    for k in range(n_rounds):
        worst[f"embed_r{k}"] = worst[f"class_r{k}"] = 0.0
    per_scene = []
    for i, ref in enumerate(refs):
        c = int(got.counts[i])
        worst["voxels"] = max(worst["voxels"], float(abs(c - ref.n)))
        if c != ref.n:
            continue
        pm = np.asarray(got.masks[i], np.float64)
        worst["pad"] = max(worst["pad"], float(np.abs(pm[c:]).max())
                           if len(pm) > c else 0.0)
        pm = pm[:c]
        worst["fps"] = max(worst["fps"], float(
            np.any(got.xyz[i] != ref.query_xyz, axis=-1).sum()))
        gaps = [class_gap(got.rounds[k, i], ref.class_rounds[k])
                for k in range(n_rounds)]
        embeds = [rel_gap(got.embeds[k, i], ref.embeds[k])
                  for k in range(n_rounds)]
        for k in range(n_rounds):
            worst[f"class_r{k}"] = max(worst[f"class_r{k}"], gaps[k])
            worst[f"embed_r{k}"] = max(worst[f"embed_r{k}"], embeds[k])
        worst["class_err"] = max(worst["class_err"], gaps[-1])
        sd = float(ref.masks.std()) or 1.0
        dm = np.abs(pm - ref.masks)
        worst["mask_err"] = max(worst["mask_err"], float(dm.mean() / sd))
        worst["mask_max"] = max(worst["mask_max"], float(dm.max() / sd))
        worst["mask_flip"] = max(worst["mask_flip"], float(
            np.mean(np.sign(pm) != np.sign(ref.masks))))
        e, *_ = np.linalg.lstsq(ref.mask_feats, pm, rcond=None)
        fit = float(np.linalg.norm(pm - ref.mask_feats @ e)
                    / np.linalg.norm(pm))
        worst["mask_fit"] = max(worst["mask_fit"], fit)
        per_scene.append((round(embeds[1], 6), round(embeds[2], 6),
                          round(gaps[1], 6), round(gaps[-1], 4),
                          round(fit, 6)))
    worst["per_scene"] = per_scene
    return worst


def merge(per_batch: List[Dict]) -> Dict:
    out = {}
    for nums in per_batch:
        for k, v in nums.items():
            if k == "per_scene":
                out.setdefault(k, []).extend(v)
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def judge(limits: Dict[str, float], nums: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers with a
    limit; a run with no sampled batch is not correct."""
    checks = {k: {"value": nums.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = bool(nums) and bool(limits) and all(
        k in nums and nums[k] <= lim for k, lim in limits.items())
    return ok, checks
