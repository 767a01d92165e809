"""Shared helpers of the port's kernel wrappers."""

from __future__ import annotations

import ctypes
import math

import torch

from mamimo_tpu_torch.ops.kernels import _build


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


def tf32_split(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """float32 t as (hi, lo) stacked on a new axis at ``dim`` (default
    the first), both TF32 values (the low 13 bits zero): hi = t rounded
    to TF32 (to nearest, ties away from zero, as ``cvt.rna.tf32.f32``),
    lo = t − hi (exact) rounded the same way; hi + lo holds 22 of t's 24
    bits. The kernels' float32 mode (csrc/gemm_sm90.cuh, ``split_tf32``)
    takes a·b as hi·hi + hi·lo + lo·hi; the float32 weight trees carry
    their K-major weights split so (``<key>_tf32``, parts at dim 1 of the
    plane-leading tensors).

    CUDA: the split kernel (``csrc/tf32_split.cu``), counted in
    ``tf32_split.launches``. CPU: its plain version, the same bits by
    integer operations on the float32 bit patterns."""
    t = t.float()
    dim = dim % (t.dim() + 1)
    if not on_cuda(t):
        return _tf32_split_plain(t, dim)
    t = t.contiguous()
    out = torch.empty(t.shape[:dim] + (2,) + t.shape[dim:],
                      dtype=torch.float32, device=t.device)
    if t.numel() == 0:
        return out
    outer = math.prod(t.shape[:dim])
    lib = _split_lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tf32_split_launch(t.data_ptr(), out.data_ptr(), outer,
                                   t.numel() // outer, stream)
    _build.check(rc, lib, "tf32_split_error_string", "tf32_split")
    tf32_split.launches += 1
    return out


tf32_split.launches = 0


def _tf32_split_plain(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The split kernel's plain version on float32 t (either device):
    TF32 rounding as integer operations on the bit patterns (add half of
    the dropped 13 bits' range to the magnitude, clear them)."""
    def rna(x):
        u = x.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return torch.stack([hi, rna(t - hi)], dim)


def _split_lib() -> ctypes.CDLL:
    lib = _build.library("tf32_split")
    fn = lib.tf32_split_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    return lib
