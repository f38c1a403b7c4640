"""The model zoo: the Res16UNet backbones (`backbone`), the ResUNet
(MinkUNet) family with its squeeze-excitation variants (`resunet`), the
Mask3D decoder (`mask3d`) and the positional encodings (`posenc`).
`MODELS` maps every backbone class name of both families to its class."""

from mask3d_tpu_torch.models.backbone import BACKBONES  # noqa: F401
from mask3d_tpu_torch.models.mask3d import Mask3D, Mask3DOutput  # noqa: F401
from mask3d_tpu_torch.models.resunet import RESUNETS, \
    MinkUNetBase  # noqa: F401

# from mask3d_tpu/models/__init__.py:35 MODELS
MODELS = dict(BACKBONES)
MODELS.update(RESUNETS)


# from mask3d_tpu/models/__init__.py:39 load_model
def load_model(name):
    """The class of model `name`, or None after printing the names there
    are."""
    if name not in MODELS:
        print("Invalid model index. Options are:")
        for key in MODELS:
            print(f"\t* {key}")
        return None
    return MODELS[name]


# from mask3d_tpu/models/__init__.py:50 get_models
def get_models():
    """Every registered model class, as a tuple."""
    return tuple(MODELS.values())
