"""Numerics shared across the port: ``unit_phasor`` (the port's copy
from ``mamimo_tpu/utils/numerics.py``; the complex transfer shims of
that module are not needed by PyTorch) and ``full_f32_matmul``."""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 products on the card in full float32, not TF32, for
    the duration; the caller's settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def unit_phasor(cycles: torch.Tensor) -> torch.Tensor:
    """exp(+j·2π·cycles) with argument reduction to [0, 1) cycles.

    ``cycles`` (float32) may be arbitrarily large; pass negative values
    for exp(−j·...). The reduction and the angle are float32, in the JAX
    package's order. Returns complex64.
    """
    c = cycles - torch.floor(cycles)
    ang = (2.0 * math.pi) * c
    return torch.complex(torch.cos(ang), torch.sin(ang))
