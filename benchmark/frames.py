"""The general frame generator: level-1 EUV-like frames from a seed.

A configuration's ``frames`` object gives the parameters, and its
``dtype`` the type the frames are stored and served in; every frame is
made on the target device from ``torch.Generator(device).manual_seed(seed)``
in a few batched calls, so one seed gives the same frames on every run.

A frame is a solar disk of radius ``disk_radius`` (a share of the frame's
side) whose brightness is ``mean_counts · exp(log_sigma · f)``, ``f`` a
multi-scale random field of unit variance (octaves of bilinearly
upsampled white noise from ``4 × 4`` cells up to ``2 × 2`` pixels, the
octave of cell size ``L`` weighted ``L**slope``), with a corona that falls
off as ``corona_level · exp(-(r - R) / (corona_scale · side))`` off the
limb, a floor of ``dark`` counts, and photon noise: each pixel a Poisson
draw of that rate.  The values are non-negative counts, drawn in float32
and stored in the configuration's ``dtype``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

#: the frame types a configuration may state
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(config: Dict) -> torch.dtype:
    """The configuration's ``dtype``; raises on one no frame is made in."""
    name = config["dtype"]
    if name not in DTYPES:
        raise ValueError(f"frames are made in {', '.join(DTYPES)}, "
                         f"not {name!r}")
    return DTYPES[name]


def _field(n: int, h: int, w: int, slope: float, gen: torch.Generator,
           device) -> torch.Tensor:
    """``n`` random fields ``(n, h, w)`` of zero mean and unit variance
    with structure on every scale from the frame down to two pixels."""
    side = max(h, w)
    out = torch.zeros((n, 1, h, w), device=device)
    cells = 4
    while side // cells >= 2:
        gh, gw = max(2, math.ceil(h * cells / side)), max(2, math.ceil(w * cells / side))
        noise = torch.randn((n, 1, gh, gw), generator=gen, device=device)
        up = F.interpolate(noise, size=(h, w), mode="bilinear",
                           align_corners=False)
        out += up * (side / cells) ** slope
        cells *= 2
    out = out[:, 0]
    out -= out.mean(dim=(1, 2), keepdim=True)
    out /= out.std(dim=(1, 2), keepdim=True)
    return out


def make_frames(config: Dict, count: int, seed: int,
                device) -> torch.Tensor:
    """``count`` frames ``(count, height, width)`` of the configuration,
    in its ``dtype``, on ``device``."""
    dtype = dtype_of(config)
    params = config["frames"]
    height, width = int(config["height"]), int(config["width"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f = _field(count, height, width, float(params["slope"]), gen, device)
    side = max(height, width)
    yy = torch.arange(height, device=device, dtype=torch.float32) - (height - 1) / 2
    xx = torch.arange(width, device=device, dtype=torch.float32) - (width - 1) / 2
    r = torch.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    radius = float(params["disk_radius"]) * side
    corona = float(params["corona_level"]) * torch.exp(
        -(r - radius) / (float(params["corona_scale"]) * side))
    profile = torch.where(r <= radius, torch.ones_like(r), corona)
    rate = (float(params["mean_counts"]) * profile
            * torch.exp(float(params["log_sigma"]) * f)
            + float(params["dark"]))
    return torch.poisson(rate, generator=gen).to(dtype).contiguous()
