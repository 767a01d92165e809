"""Shared helpers of the port's kernel wrappers."""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (tile padding)."""
    return ((x + m - 1) // m) * m


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every
    tensor lies on the CPU. A wrapper launches its kernel for the first
    and runs the kernel's plain version for the second; any other mix
    raises, so a CUDA tensor never reaches the plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on cuda or all on cpu, got {kinds}")


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous tensor whose data starts on a 16-byte boundary,
    as a TMA tensor map needs (a copy only when t is not one already)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kmajor_weight(prepared, key: str, shape: tuple, who: str) -> torch.Tensor:
    """prepared[key], a K-major bf16 weight a tail kernel reads by TMA:
    raises ValueError naming the key when it is missing or ill-shaped."""
    t = prepared.get(key)
    if t is None or tuple(t.shape) != shape or t.dtype != torch.bfloat16:
        got = "missing" if t is None else f"{tuple(t.shape)} {t.dtype}"
        raise ValueError(f"{who} needs prepared['{key}'] {shape} bf16 on "
                         f"CUDA (from the weight-preparing function), got "
                         f"{got}")
    return tma_operand(t)
