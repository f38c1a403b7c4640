"""The ResUNet (MinkUNet) backbone family: a 4-stage encoder at strides
1 -> 2 -> 4 -> 8 and a 3-stage transposed-conv decoder back to stride 1
with skip concatenations, closed by a [1x1 conv -> norm -> relu -> 1x1 conv
+ bias] head that gives `out_channels` logits a voxel. InstanceNorm
everywhere, as in the Res16UNet family, whose blocks, gate and execution
contexts it shares (`models/backbone.py`): `dense`, `gather` and
`gather_pallas`, in `compute_dtype`. `SEResUNet14`/`SEResUNet50` add the
squeeze-excitation gate to each block; `ResUNet50`/`101` and
`SEResUNet50` run bottleneck blocks. No Mask3D configuration selects these
backbones: they stand alone, as in the JAX package (`RESUNETS`,
`models.load_model`).

Returns `(logits, feature_maps)`: logits [B, N, out_channels] on the
level-0 rows and the maps at strides [8, 4, 2, 1], the last the logits
(on `gather*` every row, padding rows holding the head's bias; on `dense`
the padding rows are 0).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from mask3d_tpu_torch.models.backbone import Norm, _Backbone
from mask3d_tpu_torch.sparse.context import SparseBatch

IMPLS = ("dense", "gather", "gather_pallas")
HEAD_WIDTH = 512


# from mask3d_tpu/models/resunet.py:47 MinkUNetBase
class MinkUNetBase(_Backbone):
    PLANES = (64, 128, 256, 512, 256, 128, 128)
    LAYERS = (2, 2, 2, 2, 2, 2)
    INIT_DIM = 64

    def __init__(self, in_channels: int = 1, out_channels: int = 20,
                 conv1_kernel_size: int = 5, impl: str = "dense",
                 compute_dtype=None):
        if impl not in IMPLS:
            raise ValueError(f"ResUNet impl {impl!r} is not one of {IMPLS}")
        super().__init__(in_channels, conv1_kernel_size, impl,
                         compute_dtype)
        self.out_channels = out_channels
        p, c0, e = self.PLANES, self.INIT_DIM, self.EXPANSION
        self._conv("conv1p1s1", conv1_kernel_size, in_channels, c0)
        self.norms["bn1"] = Norm(c0)
        self._stage(1, c0, p[0], self.LAYERS[0])
        for i in range(3):  # conv2p1s2 .. conv4p4s2, stages 2-4
            name = f"conv{i + 2}p{2 ** i}s2"
            self._conv(name, 2, p[i] * e, p[i] * e)
            self.norms[name.replace("conv", "bn")] = Norm(p[i] * e)
            self._stage(i + 2, p[i] * e, p[i + 1], self.LAYERS[i + 1])
        skips = [p[2] * e, p[1] * e]
        for i in range(3):  # convtr4p8s2 .. convtr6p2s2, stages 5-6
            name = f"convtr{i + 4}p{2 ** (3 - i)}s2"
            self._conv(name, 2, p[3 + i] * e, p[4 + i], transpose=True)
            self.norms[name.replace("convtr", "bntr")] = Norm(p[4 + i])
            if i < 2:
                self._stage(i + 5, p[4 + i] + skips[i], p[4 + i],
                            self.LAYERS[4 + i])
        self._conv("final_conv1", 1, p[6] + p[0] * e, HEAD_WIDTH)
        self.norms["final_norm"] = Norm(HEAD_WIDTH)
        self._conv("final_conv2", 1, HEAD_WIDTH, out_channels, bias=True)

    # from mask3d_tpu/models/resunet.py:64 __call__ of MinkUNetBase
    def forward(self, feats, sb: SparseBatch, grid_dims=None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        ctx, x = self._context(feats, sb, grid_dims, int8=False)
        convs, norms = self.convs, self.norms

        def down(name, x_in, fine_idx):
            out = ctx.conv_down(x_in, convs[name], fine_idx)
            return torch.relu(ctx.norm(out, norms[name.replace("conv", "bn")],
                                       fine_idx + 1))

        def up(name, x_in, coarse_idx):
            out = ctx.conv_tr(x_in, convs[name], coarse_idx)
            return torch.relu(ctx.norm(
                out, norms[name.replace("convtr", "bntr")], coarse_idx - 1))

        # encoder: stage 1 at stride 1, stages 2-4 after each down conv
        out = ctx.conv_in(x, convs["conv1p1s1"])
        out = torch.relu(ctx.norm(out, norms["bn1"], 0))
        skips = []
        for i in range(4):
            if i:
                out = down(f"conv{i + 1}p{2 ** (i - 1)}s2", out, i - 1)
            out, _ = self._blocks(ctx, i + 1, out, i)
            skips.append(out)
        feature_maps = [ctx.rows(out, 3)]  # stride 8

        # decoder: stages 5-6, then the last transposed conv and the head
        for i in range(3):
            coarse = 3 - i
            out = up(f"convtr{i + 4}p{2 ** coarse}s2", out, coarse)
            out = torch.cat([out, skips[coarse - 1]], dim=-1)
            if i < 2:
                out, _ = self._blocks(ctx, i + 5, out, coarse - 1)
                feature_maps.append(ctx.rows(out, coarse - 1))
        out = ctx.conv1x1(out, convs["final_conv1"], 0)
        out = torch.relu(ctx.norm(out, norms["final_norm"], 0))
        # an f32 bias promotes a bf16 head's logits to f32, as in JAX
        out = ctx.conv1x1(out, convs["final_conv2"], 0) + \
            convs["final_conv2"].bias
        out_rows = ctx.rows(out, 0)
        feature_maps.append(out_rows)  # stride 1
        return out_rows, feature_maps


# from mask3d_tpu/models/resunet.py:142-203 ResUNet14 .. SEResUNet50 (name ->
# (base, attributes))
_VARIANTS = {
    "ResUNet14": (MinkUNetBase, dict(LAYERS=(1, 1, 1, 1, 1, 1))),
    "ResUNet18": (MinkUNetBase, dict(LAYERS=(2, 2, 2, 2, 2, 2))),
    # the reference's instance/batch-norm mix, instance norm throughout
    "ResUNet18INBN": ("ResUNet18", {}),
    "ResUNet34": (MinkUNetBase, dict(LAYERS=(3, 4, 6, 3, 2, 2))),
    "ResUNet50": (MinkUNetBase, dict(LAYERS=(3, 4, 6, 3, 2, 2),
                                     BLOCK="bottleneck", EXPANSION=4)),
    "ResUNet101": (MinkUNetBase, dict(LAYERS=(3, 4, 23, 3, 2, 2),
                                      BLOCK="bottleneck", EXPANSION=4)),
    "ResUNet14D": ("ResUNet14", dict(PLANES=(64, 128, 256, 512, 512, 512,
                                             512))),
    "ResUNet18D": ("ResUNet18", dict(PLANES=(64, 128, 256, 512, 512, 512,
                                             512))),
    "ResUNet34D": ("ResUNet34", dict(PLANES=(64, 128, 256, 512, 512, 512,
                                             512))),
    "ResUNet34E": ("ResUNet34", dict(INIT_DIM=32,
                                     PLANES=(32, 64, 128, 256, 128, 64, 64))),
    "ResUNet34F": ("ResUNet34", dict(INIT_DIM=32,
                                     PLANES=(32, 64, 128, 256, 128, 64, 32))),
    "SEResUNet14": ("ResUNet14", dict(SE=True)),
    "SEResUNet50": ("ResUNet50", dict(SE=True)),
}

RESUNETS = {}
for _name, (_base, _attrs) in _VARIANTS.items():
    _base = RESUNETS.get(_base, _base)
    RESUNETS[_name] = type(_name, (_base,), dict(_attrs))
