"""Reconstructor: UNet segmentation + ResNet STN + court-template warp
(port of ``models/reconstructor.py``): ``forward`` is the training and
validation forward, ``predict`` the inference one.

Conventions as in the JAX package: images NHWC in [0, 1]; theta
(B, 1, 3, 3) maps frame -> court in normalized [-1, 1] coordinates; the
court template is a (Ht, Wt) uint8 label map.  Sizes are (W, H).

PyTorch runs eagerly, so nothing is pruned after the fact: ``predict``
computes only what it is asked for.  Without the ``warp_mask`` output the
consistency labels come from K1 evaluated at the logits grid only
(``sample_hw``); with it, K1 runs once on the full ``warp_size`` grid and
the consistency labels are the nearest downsample of those labels, equal
to the sampled ones bit for bit (the JAX ``score_from_warp_mask``).
``forward`` warps bilinearly (training), or, with ``warp_with_nearest``
(the checkpoint test CLI), with K1 on the full ``warp_size`` grid, as the
JAX ``warp`` does.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.homography import transform_poi
from ..geometry.warp import warp_bilinear
from ..ops.resize import resize_nearest
from ..ops.warp import warp_nearest
from ..utils import trace
from .layers import nchw, nhwc
from .losses import cross_entropy_map
from .resnet import ResNetSTN, resnet_models
from .unet import unet_forward, unet_layers

__all__ = ["Input", "ReconstructorConfig", "Reconstructor"]


class Input(enum.Enum):
    """STN input selector."""

    IMG = 1
    MASK = 2
    IMG_AND_MASK = 3
    IMG_AND_MASK_AND_UV = 4

    @classmethod
    def parse(cls, value):
        if value is None or isinstance(value, cls):
            return value
        mapping = {"img": cls.IMG, "mask": cls.MASK,
                   "img+mask": cls.IMG_AND_MASK,
                   "img+mask+uv": cls.IMG_AND_MASK_AND_UV}
        if value not in mapping:
            raise NotImplementedError(value)
        return mapping[value]


@dataclasses.dataclass(frozen=True)
class ReconstructorConfig:
    """Static model configuration; sizes are (W, H)."""

    target_size: Tuple[int, int] = (640, 360)
    mask_classes: int = 4
    use_unet: bool = True
    unet_bilinear: bool = False
    unet_size: Tuple[int, int] = (640, 360)
    unet_uv: bool = False
    use_resnet: bool = True
    resnet_name: str = "resnet34"
    resnet_input: str = "img+mask"
    use_warper: bool = True
    warp_size: Tuple[int, int] = (640, 360)
    warp_with_nearest: bool = False

    def __post_init__(self):
        if not (self.use_unet or self.use_resnet):
            raise ValueError("need the UNet, the ResNet or both")
        if self.use_resnet and self.resnet_name not in resnet_models:
            raise ValueError(f"{self.resnet_name}: not one of {sorted(resnet_models)}")
        mode = Input.parse(self.resnet_input)
        if self.use_resnet:
            if mode is None:
                raise ValueError("use_resnet needs resnet_input")
            if mode != Input.IMG and not self.use_unet:
                raise ValueError(f"resnet_input {self.resnet_input} needs the UNet")
            if mode == Input.IMG_AND_MASK_AND_UV and not self.unet_uv:
                raise ValueError("resnet_input img+mask+uv needs unet_uv")

    @property
    def stn_in_channels(self) -> int:
        mode = Input.parse(self.resnet_input)
        return {Input.IMG: 3, Input.MASK: self.mask_classes,
                Input.IMG_AND_MASK: self.mask_classes + 3,
                Input.IMG_AND_MASK_AND_UV: self.mask_classes + 5}[mode]


class Reconstructor(nn.Module):
    """The UNet's layers sit directly on this module and the ResNet under
    ``resnet_reg``, which gives the reference's ``state_dict`` keys."""

    def __init__(self, config: ReconstructorConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        if config.use_unet:
            for name, layer in unet_layers(config.mask_classes, config.unet_uv,
                                           config.unet_bilinear).items():
                self.add_module(name, layer)
        if config.use_resnet:
            self.resnet_reg = ResNetSTN(in_channels=config.stn_in_channels,
                                        **resnet_models[config.resnet_name])

    def forward_unet(self, x: torch.Tensor):
        """UNet with input/output resolution fitting.  x: NHWC f32."""
        cfg = self.config
        uw, uh = cfg.unet_size
        if x.shape[1] != uh or x.shape[2] != uw:
            x = nhwc(F.interpolate(nchw(x), size=(uh, uw), mode="bilinear",
                                   align_corners=False))
        logits, x_top, uv = unet_forward(self, x.to(self.dtype).contiguous())
        tw, th = cfg.target_size

        def fit(t):
            if t is None or (t.shape[1] == th and t.shape[2] == tw):
                return t
            return nhwc(F.interpolate(nchw(t), size=(th, tw), mode="nearest"))

        return fit(logits), x_top, fit(uv)

    def _stn_input(self, x, logits, uv):
        mode = Input.parse(self.config.resnet_input)
        parts = {Input.IMG: [x], Input.MASK: [logits],
                 Input.IMG_AND_MASK: [logits, x],
                 Input.IMG_AND_MASK_AND_UV: [logits, x, uv]}[mode]
        return torch.cat([p.to(self.dtype) for p in parts], dim=-1)

    def warp(self, theta: torch.Tensor, court_labels: torch.Tensor,
             values: torch.Tensor, sample_hw=None) -> torch.Tensor:
        """Nearest warp of the court template (K1) at ``warp_size``, or at
        its ``sample_hw`` subgrid; returns each label's value in ``values``
        (f32, ``ops/warp.template_value_table``)."""
        w, h = self.config.warp_size
        return warp_nearest(court_labels, theta, (h, w), values, sample_hw=sample_hw)

    def forward(self, x: torch.Tensor, court_template: torch.Tensor,
                court_poi: torch.Tensor, court_labels=None) -> dict:
        """Training / validation forward (the JAX ``Reconstructor.__call__``):
        BatchNorm uses batch statistics and updates its running stats when
        the module is in training mode; after ``models/layers.set_bn_sync``
        (data parallel, the JAX ``bn_axis_name``) those of every rank's
        batch.

        Args:
          x: (B, H, W, 3) float32 frames in [0, 1].
          court_template: (Ht, Wt) float32 court labels / mask_classes.
          court_poi: (N, 2) court points of interest in [-1, 1].
          court_labels: (uint8 (Ht, Wt) labels, (256,) f32 label values) of
            the same template; the nearest warp (``warp_with_nearest``)
            reads them.
        Returns:
          dict with ``logits`` (NHWC, compute dtype), ``theta`` (B, 1, 3, 3)
          f32, ``poi`` (B, N, 2) in [0, 1] and ``warp_mask`` (B, h, w) f32,
          the warp of the template at ``warp_size``: bilinear (the
          reference trains with bilinear), or nearest (K1) with
          ``warp_with_nearest``.
        """
        cfg = self.config
        ret = {}
        logits = uv = None
        if cfg.use_unet:
            with trace.span("model.unet"):
                logits, _, uv = self.forward_unet(x)
            ret["logits"] = logits
            if uv is not None:
                ret["uv"] = uv
        if cfg.use_resnet:
            with trace.span("model.stn"):
                theta = self.resnet_reg(self._stn_input(x, logits, uv))
            ret["theta"] = theta
            ret["poi"] = transform_poi(theta, court_poi)
            if cfg.use_warper and cfg.warp_with_nearest:
                if court_labels is None:
                    raise ValueError("warp_with_nearest needs court_labels")
                with trace.span("model.warp"):
                    ret["warp_mask"] = self.warp(theta, *court_labels)
            elif cfg.use_warper:
                w, h = cfg.warp_size
                with trace.span("model.warp"):
                    ret["warp_mask"] = warp_bilinear(court_template, theta, (h, w))
        return ret

    def predict(self, x: torch.Tensor, court_labels: Optional[torch.Tensor] = None,
                values: Optional[torch.Tensor] = None, consistency: bool = True,
                warp_mask: bool = False,
                court_poi: Optional[torch.Tensor] = None) -> dict:
        """Inference forward (the JAX ``Reconstructor.predict``).

        Args:
          x: (B, H, W, 3) float32 frames in [0, 1].
          court_labels, values: the court template and its per-label values
            (``ops/warp.template_value_table``); needed for the warp.
          consistency: return ``consist_score``, the per-frame mean
            per-pixel cross entropy of the logits against the warped labels.
          warp_mask: return ``warp_mask``, the (B, h, w) f32 class labels
            (warp value * mask_classes) of K1 on the full ``warp_size``
            grid; the consistency labels are then its nearest downsample.
          court_poi: (N, 2) court points of interest in [-1, 1]; when given,
            return ``poi`` (B, N, 2), their projection into the frame in
            [0, 1] (the JAX ``project_poi``).
        Returns:
          dict with ``logits`` (NHWC), ``theta`` (B, 1, 3, 3) f32 and the
          outputs asked for.
        """
        cfg = self.config
        ret = {}
        logits = uv = None
        if cfg.use_unet:
            with trace.span("model.unet"):
                logits, _, uv = self.forward_unet(x)
            ret["logits"] = logits
        if not cfg.use_resnet:
            return ret
        with trace.span("model.stn"):
            theta = self.resnet_reg(self._stn_input(x, logits, uv))
        ret["theta"] = theta
        if court_poi is not None:
            ret["poi"] = transform_poi(theta, court_poi)
        if not cfg.use_warper:
            return ret
        score = consistency and cfg.use_unet
        grid = tuple(logits.shape[1:3]) if score else None
        with trace.span("model.warp"):
            if warp_mask:
                # one full-grid K1 serves both outputs
                labels = self.warp(theta, court_labels, values) * cfg.mask_classes
                ret["warp_mask"] = labels
                wm = resize_nearest(labels, grid) if score else None
            elif score:
                w, h = cfg.warp_size
                sample = None if grid == (h, w) else grid
                wm = self.warp(theta, court_labels, values, sample_hw=sample) * cfg.mask_classes
            if score:
                ret["consist_score"] = cross_entropy_map(
                    logits, wm.to(torch.int32)).mean(dim=(1, 2))
        return ret
