"""Everything a run feeds the system under test and the reference, made
from ``--seed``: the weights as a reference-keyed state dict, the court
template and points, and seeded court renders with their labels and
points.  Both sides get the same tensors; neither makes its own.

Weights and renders are made on the run's device by a ``torch.Generator``
seeded from ``--seed``, in a few large calls.  The court template is the
NCAA label map (``data/court_ncaa_v4_nc4.npz``, the repository's
``assets/mask_ncaa_v4_nc4_m_onehot.png`` decoded) resized the way Pillow's
NEAREST does; its points of interest are ``data/court_ncaa_v4_points.json``.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

import numpy as np
import torch

from reference.model import Reconstructor

__all__ = ["seed_streams", "reference_model", "seeded_state_dict", "court",
           "render", "BASE_THETA"]

DATA = Path(__file__).resolve().parent / "data"

# a broadcast camera's frame -> court homography; renders scatter around it
BASE_THETA = np.array([[1.4, 0.1, 0.05], [0.02, 2.2, 0.6], [0.01, 0.9, 1.0]])
_THETA_NOISE = np.array([[.15, .05, .1], [.05, .3, .15], [.005, .1, .05]])
# render colours of background, floor, lines, paint
_PALETTE = [[20, 30, 20], [200, 160, 110], [250, 250, 250], [150, 50, 40]]


def seed_streams(seed: int, n: int):
    """``n`` independent 63-bit seeds derived from ``--seed`` (any
    non-negative integer)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> np.uint64(1)]


def reference_model(model_cfg: dict, device="meta") -> Reconstructor:
    with torch.device(device):
        return Reconstructor(model_cfg["mask_classes"], model_cfg["unet_bilinear"],
                             model_cfg["resnet_name"])


def _residual_last(model) -> set:
    """The last BatchNorm of each residual branch: the highest-numbered
    ``bn<k>`` of each ``resnet_reg.layer<s>.<b>``."""
    last = {}
    for name, _ in model.named_modules():
        m = re.fullmatch(r"(resnet_reg\.layer\d+\.\d+)\.bn(\d+)", name)
        if m:
            last[m.group(1)] = max(last.get(m.group(1), 0), int(m.group(2)))
    return {f"{block}.bn{k}" for block, k in last.items()}


def _fan_in(shape, transposed):
    if transposed:              # ConvTranspose2d (Cin, Cout, kh, kw): one tap per output
        return shape[0]
    return int(np.prod(shape[1:]))


def seeded_state_dict(model_cfg: dict, seed: int, device) -> dict:
    """Seeded weights for every key of the reference's state dict.

    Convolutions and linears are He-normal over their fan-in, biases
    U(-0.1, 0.1).  BatchNorm: scale U(0.5, 1.5), shift U(-0.2, 0.2), running
    mean U(-0.2, 0.2) and running variance U(0.5, 2), so folding them is no
    identity; the last BatchNorm of each residual branch has its scale in
    U(0.1, 0.4), which keeps the eval-mode residual sum from doubling at
    every block.  The homography head is a small random map around the
    identity bias (zero weight would make theta blind to its input).
    """
    skeleton = reference_model(model_cfg)
    shapes = {k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    transposed = {f"{n}.weight" for n, m in skeleton.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    n_total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed_streams(seed, 1)[0])
    normal = torch.randn(n_total, generator=gen, device=device)
    uniform = torch.rand(n_total, generator=gen, device=device)
    out, pos = {}, 0
    residual_last = _residual_last(skeleton)
    for key, shape in shapes.items():
        n = math.prod(shape)
        nrm, uni = normal[pos:pos + n].view(shape), uniform[pos:pos + n].view(shape)
        pos += n

        def u(lo, hi):
            return lo + (hi - lo) * uni

        module, leaf = key.rsplit(".", 1)
        is_bn = len(shape) == 1 and f"{module}.running_var" in shapes
        if leaf == "num_batches_tracked":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        elif key == "resnet_reg.reg.weight":
            t = nrm * (0.02 / math.sqrt(shape[1]))
        elif key == "resnet_reg.reg.bias":
            t = torch.eye(3, device=device).reshape(9) + 0.01 * nrm
        elif is_bn and leaf == "weight":
            t = u(0.1, 0.4) if module in residual_last else u(0.5, 1.5)
        elif is_bn and leaf == "bias":
            t = u(-0.2, 0.2)
        elif leaf == "running_mean":
            t = u(-0.2, 0.2)
        elif leaf == "running_var":
            t = u(0.5, 2.0)
        elif leaf == "weight":
            t = nrm * math.sqrt(2.0 / _fan_in(shape, key in transposed))
        else:
            t = u(-0.1, 0.1)
        out[key] = t.clone()
    return out


def court(size, classes: int = 4):
    """The NCAA court's (H, W) uint8 labels at ``size`` = (W, H), and its
    (N, 2) float32 points of interest in [-1, 1]."""
    labels = np.load(DATA / "court_ncaa_v4_nc4.npz")["labels"]
    w, h = int(size[0]), int(size[1])

    def idx(src, dst):       # Pillow's NEAREST: int(0.5 * step + i * step)
        step = src / dst
        pos = np.cumsum(np.concatenate([[step * 0.5], np.full(dst - 1, step)]))
        return np.minimum(pos.astype(np.int64), src - 1)

    labels = labels[idx(labels.shape[0], h)[:, None], idx(labels.shape[1], w)[None, :]]
    if labels.max() >= classes:
        raise ValueError(f"court label {labels.max()} >= {classes} classes")
    with open(DATA / "court_ncaa_v4_points.json") as f:
        pts = json.load(f)["points"]
    poi = np.array([[(p["coords"][0] - 0.5) * 2, (p["coords"][1] - 0.5) * 2] for p in pts],
                   np.float32)
    return np.ascontiguousarray(labels, dtype=np.uint8), poi


def render(n: int, size, court_labels: np.ndarray, court_poi: np.ndarray, seed: int,
           device, gain=(1.0, 1.0), offset=(0.0, 0.0)):
    """``n`` seeded renders of the court under broadcast-like homographies
    at ``size`` = (W, H): uint8 frames (n, H, W, 3), their labels
    (n, H, W) uint8 (the template warped nearest), the points of interest
    (n, N, 2) in [0, 1] clipped, with a visibility flag (n, N), all on
    ``device``.  The colours follow the labels, with a vertical ramp and
    Gaussian noise; each frame's lighting scales them by a gain drawn from
    U(``gain``) and shifts them by U(``offset``), from a stream of their
    own (the default, no change, draws nothing)."""
    from reference.ops import project_poi, warp_labels_nearest

    w, h = int(size[0]), int(size[1])
    gen = torch.Generator(device=device).manual_seed(seed_streams(seed, 2)[1])
    noise = torch.randn((n, 3, 3), generator=gen, device=device, dtype=torch.float64)
    theta = (torch.as_tensor(BASE_THETA, device=device)
             + noise * torch.as_tensor(_THETA_NOISE, device=device)).float()
    tmpl = torch.as_tensor(court_labels, device=device)
    poi_court = torch.as_tensor(court_poi, device=device)
    labels = torch.cat([warp_labels_nearest(tmpl, theta[i:i + 16], (h, w))
                        for i in range(0, n, 16)]).to(torch.uint8)
    palette = torch.tensor(_PALETTE, dtype=torch.float32, device=device)
    ramp = torch.linspace(0, 40, h, device=device)[None, :, None, None]
    pix = torch.randn((n, h, w, 3), generator=gen, device=device)
    frames = palette[labels.long()] * 0.7 + 40 + ramp + pix * 12
    if tuple(gain) != (1.0, 1.0) or tuple(offset) != (0.0, 0.0):
        light = torch.Generator(device=device).manual_seed(seed_streams(seed, 5)[4])
        u = torch.rand((2, n, 1, 1, 1), generator=light, device=device)
        frames = (frames * (gain[0] + (gain[1] - gain[0]) * u[0])
                  + offset[0] + (offset[1] - offset[0]) * u[1])
    frames = frames.clamp_(0, 255)
    pts = project_poi(theta, poi_court)
    visible = ((pts > 0) & (pts < 1)).all(-1).float()
    return frames.to(torch.uint8), labels, pts.clamp(0, 1), visible
