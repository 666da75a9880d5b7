"""Training augmentation on the host, in numpy (port of
``data/augmentation.py``).

The appearance stream (colour jitter in a random order, gaussian blur with
reflect padding) and the geometric one (a fixed-aspect RandomResizedCrop,
``scale``, and a horizontal flip) act on the float image in [0, 1]; the
geometric stream moves the label mask, the UV map (whose u is inverted on
court pixels by a flip) and the points of interest (permuted by the court's
left/right symmetry map) with it.  One ``np.random.default_rng(seed)``
draws every parameter of a sample once, in the JAX package's order, so a
seed gives the same sample as there.

Jitter, blur and hflip need numpy only.  ``scale`` resizes through Pillow,
as the JAX package does; ``AugmentationPipeline`` refuses it where Pillow
is not installed.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from .image import have_pillow

__all__ = ["AugmentationPipeline", "ncaa_poi_flip_mapping", "load_poi_flip_mapping",
           "flip_poi"]


def ncaa_poi_flip_mapping() -> np.ndarray:
    """The NCAA court's left/right PoI pairs: ``mapping[i]`` is the index of
    the mirror of point ``i``, for the first 28 points."""
    mapping = np.zeros(28, dtype=np.int64)
    mapping[0:4] = np.arange(4)
    mapping[4:8] = 51 - np.arange(4)
    mapping[8:22] = 45 - np.arange(14)
    mapping[22:24] = 47 - np.arange(2)
    mapping[24:28] = 31 - np.arange(4)
    return mapping


def load_poi_flip_mapping(path: str) -> np.ndarray:
    """The ``hflip`` list of a ``poi_flip_map`` JSON file."""
    with open(path, "r") as f:
        return np.asarray(json.load(f)["hflip"], dtype=np.int64)


def flip_poi(poi: np.ndarray, nonzeros: np.ndarray,
             mapping: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror the points horizontally (x -> 1 - x) and swap each pair of
    the symmetry map, in the map's order."""
    t_poi, t_nonzeros = poi.copy(), nonzeros.copy()
    for idx1 in range(mapping.shape[0]):
        idx2 = int(mapping[idx1])
        t_poi[idx1, 0] = 1.0 - poi[idx2, 0]
        t_poi[idx1, 1] = poi[idx2, 1]
        t_poi[idx2, 0] = 1.0 - poi[idx1, 0]
        t_poi[idx2, 1] = poi[idx1, 1]
        t_nonzeros[idx1] = nonzeros[idx2]
        t_nonzeros[idx2] = nonzeros[idx1]
    return t_poi, t_nonzeros


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma, as torchvision's ``rgb_to_grayscale``."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def _adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift the hue by ``factor`` turns (|factor| <= 0.5) through HSV."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc, minc = np.max(img, axis=-1), np.min(img, axis=-1)
    v, delta = maxc, maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)

    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.stack([np.choose(i, [v, q, p, p, t, v]),
                    np.choose(i, [t, v, v, q, p, p]),
                    np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return np.clip(out, 0.0, 1.0)


def _gaussian_blur(img: np.ndarray, kernel_size: int, sigma: float) -> np.ndarray:
    """Separable gaussian blur with reflect padding (torchvision's)."""
    half = kernel_size // 2
    xs = np.arange(kernel_size, dtype=np.float32) - half
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    out = np.pad(img, [(half, half), (0, 0), (0, 0)], mode="reflect")
    out = sum(k[i] * out[i:i + img.shape[0]] for i in range(kernel_size))
    out = np.pad(out, [(0, 0), (half, half), (0, 0)], mode="reflect")
    out = sum(k[i] * out[:, i:i + img.shape[1]] for i in range(kernel_size))
    return out.astype(img.dtype)


class AugmentationPipeline:
    """The conf's ``aug`` dict as a callable:
    ``{'apperance': {'jitter': {...}, 'blur': k},
    'geometric': {'scale': [lo, hi], 'hflip': p, 'poi_flip_map': path}}``
    (the reference's spelling of ``apperance``)."""

    def __init__(self, aug: Dict, target_size: Tuple[int, int], use_uv: bool = False):
        self.target_size = tuple(target_size)      # (W, H)
        self.use_uv = use_uv
        self.jitter = self.blur = self.scale = self.hflip = self.poi_mapping = None

        app = aug.get("apperance") if aug else None
        if app:
            if "jitter" in app:
                j = app["jitter"]
                self.jitter = dict(brightness=j.get("brightness", 0.35),
                                   contrast=j.get("contrast", 0.35),
                                   saturation=j.get("saturation", 0.25),
                                   hue=j.get("hue", 0.25))
            if "blur" in app:
                self.blur = int(app["blur"])
            if self.jitter is None and self.blur is None:
                raise ValueError("aug['apperance'] lists no transformation; set it "
                                 "to None for none")

        geo = aug.get("geometric") if aug else None
        if geo:
            if "scale" in geo:
                if not have_pillow():
                    raise RuntimeError("aug: the 'scale' crop resizes with Pillow, "
                                       "which is not installed")
                self.scale = tuple(geo["scale"])
            if "hflip" in geo:
                self.hflip = float(geo["hflip"])
            if self.scale is None and self.hflip is None:
                raise ValueError("aug['geometric'] lists no transformation; set it "
                                 "to None for none")
            self.poi_mapping = (load_poi_flip_mapping(geo["poi_flip_map"])
                                if "poi_flip_map" in geo else ncaa_poi_flip_mapping())

    def _apply_appearance(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.jitter is not None:
            j = self.jitter
            for op in rng.permutation(4):
                if op == 0 and j["brightness"] > 0:
                    f = rng.uniform(max(0.0, 1 - j["brightness"]), 1 + j["brightness"])
                    img = np.clip(img * f, 0, 1)
                elif op == 1 and j["contrast"] > 0:
                    f = rng.uniform(max(0.0, 1 - j["contrast"]), 1 + j["contrast"])
                    img = _blend(img, _grayscale(img).mean(), f)
                elif op == 2 and j["saturation"] > 0:
                    f = rng.uniform(max(0.0, 1 - j["saturation"]), 1 + j["saturation"])
                    img = _blend(img, _grayscale(img), f)
                elif op == 3 and j["hue"] > 0:
                    img = _adjust_hue(img, rng.uniform(-j["hue"], j["hue"]))
        if self.blur is not None:
            sigma = rng.uniform(0.1, 2.0)     # torchvision GaussianBlur's default range
            img = _gaussian_blur(img, self.blur, sigma)
        return img

    def _draw_crop(self, rng: np.random.Generator, w: int, h: int):
        """RandomResizedCrop's box at the target's aspect ratio (torchvision
        ``get_params`` with ``ratio=(r, r)``): (top, left, height, width)."""
        area = w * h
        ratio = self.target_size[0] / float(self.target_size[1])
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            cw = int(round(np.sqrt(target_area * ratio)))
            ch = int(round(np.sqrt(target_area / ratio)))
            if 0 < cw <= w and 0 < ch <= h:
                return rng.integers(0, h - ch + 1), rng.integers(0, w - cw + 1), ch, cw
        cw = min(w, int(round(h * ratio)))       # fall back to a centre crop
        ch = min(h, int(round(cw / ratio)))
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    @staticmethod
    def _crop_resize(arr: np.ndarray, box, out_size, resample) -> np.ndarray:
        from PIL import Image

        top, left, ch, cw = box
        crop = arr[top:top + ch, left:left + cw]
        if crop.ndim == 3 and crop.shape[-1] in (1, 2):
            return np.stack([np.array(Image.fromarray(crop[..., c]).resize(out_size, resample))
                             for c in range(crop.shape[-1])], axis=-1)
        float_img = crop.dtype in (np.float32, np.float64) and crop.ndim == 3
        out = np.array(Image.fromarray((crop * 255).astype(np.uint8) if float_img else crop)
                       .resize(out_size, resample))
        return out.astype(np.float32) / 255.0 if float_img else out

    def __call__(self, img: np.ndarray, mask: Optional[np.ndarray], uv: Optional[np.ndarray],
                 poi: Optional[np.ndarray], nonzeros: Optional[np.ndarray], seed: int):
        """Augment one sample: ``img`` (H, W, 3) float in [0, 1], ``mask``
        (H, W) labels, ``uv`` (H, W, 2), ``poi`` (N, 2) in [0, 1] with
        ``nonzeros`` (N,); each may be None but the image.  Returns them in
        that order."""
        rng = np.random.default_rng(seed)
        if self.jitter is not None or self.blur is not None:
            img = self._apply_appearance(img, rng)

        if self.scale is not None:
            if poi is not None:
                raise NotImplementedError("the 'scale' crop does not move points of "
                                          "interest (as in the reference)")
            from PIL import Image

            h, w = img.shape[:2]
            box = self._draw_crop(rng, w, h)
            img = self._crop_resize(img, box, self.target_size, Image.BILINEAR)
            if mask is not None:
                mask = self._crop_resize(mask.astype(np.uint8), box, self.target_size,
                                         Image.NEAREST).astype(np.int64)
            if uv is not None:
                uv = self._crop_resize(uv, box, self.target_size, Image.NEAREST)

        if self.hflip is not None and rng.random() < self.hflip:
            img = img[:, ::-1].copy()
            if mask is not None:
                mask = mask[:, ::-1].copy()
            if uv is not None:
                uv = uv[:, ::-1].copy()
                uv[..., 0] = (uv[..., 0] > 0).astype(uv.dtype) - uv[..., 0]
            if poi is not None:
                poi, nonzeros = flip_poi(poi, nonzeros, self.poi_mapping)
        return img, mask, uv, poi, nonzeros
