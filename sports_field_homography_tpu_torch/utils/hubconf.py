"""Model-hub style entry points (port of ``utils/hubconf.py``): named
constructors of this package's models.

    python -m sports_field_homography_tpu_torch.utils.hubconf

prints each constructor's model and its parameter count.
"""
from __future__ import annotations

__all__ = ["unet", "reconstructor"]


def unet(mask_classes: int = 4, bilinear: bool = False):
    """The segmentation-only UNet of the legacy family."""
    from ..models.legacy import UNet

    return UNet(n_classes=mask_classes, bilinear=bilinear)


def reconstructor(**kwargs):
    """The Reconstructor from ``ReconstructorConfig`` keywords."""
    from ..models import Reconstructor, ReconstructorConfig

    return Reconstructor(ReconstructorConfig(**kwargs))


if __name__ == "__main__":
    for name, make in (("unet", unet), ("reconstructor", reconstructor)):
        model = make()
        print(f"{name}: {type(model).__name__}, "
              f"{sum(p.numel() for p in model.parameters())} parameters")
