"""int8 GEMM with int32 accumulation: wrapper of the hand-written CUDA
kernel ``csrc/int8_mm.cu`` (the counterpart of
``mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas``, int8 mode; TMA and
s8 wgmma, a resident slab of B for K <= 1024, a ring of both operands
above).

``matmul_int8(a, bt)`` takes B transposed, (N, K), which is the kernel's
operand layout (wgmma reads 8-bit operands only K-major); the int8
serving weights carry that copy
(``models/quant.py::prepare_int8_serving``). ``matmul_pallas(a, b)``
keeps the JAX signature, B (K, N), and transposes per call.

The plain version multiplies in float64 and converts to int32. That is
exact: every product is at most 2^14 in magnitude, a sum over K < 2^17
terms stays inside int32, and float64 holds every integer below 2^53.
(``torch.matmul`` of two int8 tensors returns int8 on the CPU and wraps
silently; CUDA has no integer matmul.) It runs on either device.
"""

from __future__ import annotations

import ctypes

import torch

from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import on_cuda

_MAX_K = 1 << 17


def _check_int8(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("only the int8 mode is ported: int8 operands, int32 "
                        f"result; got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"2-D operands expected, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")


def _matmul_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 → (M, N) int32, exact (float64)."""
    return (a.double() @ b.double()).to(torch.int32)


def matmul_int8(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """C = A @ Bt.T: a (M, K) int8, bt (N, K) int8 → (M, N) int32.

    CUDA: the hand-written kernel (K a multiple of 16); CPU: the plain
    version."""
    _check_int8(a, bt)
    m, k = a.shape
    n = bt.shape[0]
    if bt.shape[1] != k:
        raise ValueError(f"inner sizes differ: a {tuple(a.shape)}, "
                         f"bt {tuple(bt.shape)}")
    if not on_cuda(a, bt):
        return _matmul_int8_plain(a, bt.T)
    if k % 16 or k >= _MAX_K:
        raise ValueError(f"the int8 kernel needs K % 16 == 0 and K < "
                         f"{_MAX_K}, got K = {k}")
    a, bt = a.contiguous(), bt.contiguous()
    if a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("the int8 kernel needs 16-byte aligned operands")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _int8_lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int8_mm_launch(a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                                m, n, k, stream)
    _build.check(rc, lib, "int8_mm_error_string", "matmul_int8")
    matmul_int8.launches += 1
    return out


matmul_int8.launches = 0


def matmul_pallas(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A (M, K) and B (K, N) int8 → int32 (the JAX
    ``matmul_pallas`` in int8 mode; its row block is the TPU's tiling
    and has no counterpart here). Its bf16 and f32 modes are not ported:
    other dtypes raise TypeError."""
    _check_int8(a, b)
    return matmul_int8(a, b.T.contiguous())


def _int8_lib() -> ctypes.CDLL:
    lib = _build.library("int8_mm")
    fn = lib.int8_mm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return lib
