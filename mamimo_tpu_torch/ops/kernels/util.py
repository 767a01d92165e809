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


def count_launch(fn, f32: bool) -> None:
    """One launch of wrapper fn's kernel: its ``launches`` count, and
    ``launches_f32`` for a launch of the float32 mode."""
    fn.launches += 1
    fn.launches_f32 += bool(f32)


def kmajor_weight(prepared, key: str, shape: tuple, who: str,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """prepared[key], a K-major weight of the given dtype (bfloat16, or
    float32 for the float32 mode) that a kernel reads by TMA: raises
    ValueError naming the key and the dtype when it is missing,
    ill-shaped or of another dtype."""
    t = prepared.get(key)
    if t is None or tuple(t.shape) != shape or t.dtype != dtype:
        got = "missing" if t is None else f"{tuple(t.shape)} {t.dtype}"
        raise ValueError(f"{who} needs prepared['{key}'] {shape} "
                         f"{str(dtype)[6:]} on CUDA (from the "
                         f"weight-preparing function), got {got}")
    return tma_operand(t)


def tf32_split(t: torch.Tensor) -> torch.Tensor:
    """float32 t as (hi, lo) stacked on a new first axis, both TF32
    values (the low 13 bits zero): hi = t rounded to TF32 (to nearest,
    ties away, as ``cvt.rna.tf32.f32``), lo = t − hi (exact) rounded the
    same way; hi + lo holds 22 of t's 24 bits. The kernels' float32
    mode (csrc/gemm_sm90.cuh, ``split_tf32``) takes a·b as hi·hi + hi·lo
    + lo·hi."""
    def rna(x):
        u = x.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t.float())
    return torch.stack([hi, rna(t.float() - hi)])
