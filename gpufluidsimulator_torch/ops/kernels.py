"""SPH smoothing kernels (poly6 / spiky / viscosity), 2D and 3D.

Counterpart: ``gpufluidsimulator_tpu/ops/kernels.py``.  The normalisation
coefficients are Python float64; the CUDA kernels receive them (pre-folded
with the particle mass) as float32 launch arguments.

Normalisations (unit integral over R^d):
  3D poly6:      315/(64 pi h^9) (h^2-r^2)^3
  2D poly6:        4/(pi h^8)    (h^2-r^2)^3
  3D spiky grad: -45/(pi h^6)    (h-r)^2  rhat
  2D spiky grad: -30/(pi h^5)    (h-r)^2  rhat
  3D visc lap:    45/(pi h^6)    (h-r)
  2D visc lap:    40/(pi h^5)    (h-r)
"""

from __future__ import annotations

import math

import torch


def poly6_coef(h: float, dim: int) -> float:
    if dim == 3:
        return 315.0 / (64.0 * math.pi * h**9)
    return 4.0 / (math.pi * h**8)


def spiky_grad_coef(h: float, dim: int) -> float:
    if dim == 3:
        return -45.0 / (math.pi * h**6)
    return -30.0 / (math.pi * h**5)


def visc_lap_coef(h: float, dim: int) -> float:
    if dim == 3:
        return 45.0 / (math.pi * h**6)
    return 40.0 / (math.pi * h**5)


def poly6(r2: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """W_poly6 from the squared distance; 0 outside the support."""
    d = torch.clamp_min(h * h - r2, 0.0)
    return poly6_coef(h, dim) * d * d * d


def spiky_grad_mag(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """g(r) with grad W_spiky = g(r) (x_i - x_j) / r; 0 outside the support."""
    d = torch.clamp_min(h - r, 0.0)
    return spiky_grad_coef(h, dim) * d * d


def visc_lap(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """Laplacian of the viscosity kernel; 0 outside the support."""
    return visc_lap_coef(h, dim) * torch.clamp_min(h - r, 0.0)
