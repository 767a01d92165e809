"""The GEMM ``matmul_pallas`` (the counterpart of
``mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas``) in its three
modes, on hand-written CUDA kernels:

- int8 → int32: ``csrc/int8_mm.cu`` (TMA and s8 wgmma, a resident slab
  of B for K <= 1024, a ring of both operands above), through
  ``matmul_int8(a, bt)``, which takes B transposed, (N, K), the
  kernel's operand layout (wgmma reads 8-bit operands only K-major); the
  int8 serving weights carry that copy
  (``models/quant.py::prepare_int8_serving``);
- bf16 → f32: ``csrc/matmul_bf16.cu`` (``mm_sm90.cuh``'s gemm_coop
  wgmma walk), reading B (K, N) as it is given (MN-major, wgmma's
  transpose bit) or Bt (N, K) (K-major);
- f32 → f32: ``csrc/matmul.cu`` at float32 accuracy from three TF32
  products a k-slice (3xTF32, ``gemm_sm90.cuh::gemm_tf32x3``), B's TF32
  parts split per call (``tf32_split``).

``matmul_pallas(a, b)`` keeps the JAX signature, B (K, N): the bf16
kernel reads that B as it lies (``b_operand``: no copy when B is
row-major with N % 8 == 0, or a transposed view of a K-major Bt); the
int8 and float32 kernels read B transposed, copied per call (wgmma
reads 8-bit and TF32 B operands only K-major). ``out_dtype`` rounds the
result as JAX's ``.astype(o_ref.dtype)`` does.

The plain versions: for int8 a float64 product converted to int32. That
is exact: every product is at most 2^14 in magnitude, a sum over K <
2^17 terms stays inside int32, and float64 holds every integer below
2^53. (``torch.matmul`` of two int8 tensors returns int8 on the CPU and
wraps silently; CUDA has no integer matmul.) For bf16 and f32 a float32
product of the float32 operands with TF32 off. Both run on either
device.
"""

from __future__ import annotations

import ctypes

import torch

from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import (
    on_cuda,
    tf32_split,
    tma_operand,
)
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

_MAX_K = 1 << 17


def _check_int8(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("the int8 mode takes int8 operands (int32 result); "
                        f"got {a.dtype} and {b.dtype}")
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


def _matmul_float_plain(a: torch.Tensor, b: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N), bf16 or float32 operands: the float32 product
    (TF32 off on the card), stored in ``out_dtype`` (default float32)."""
    with full_f32_matmul():
        return (a.float() @ b.float()).to(out_dtype or torch.float32)


def matmul_float(a: torch.Tensor, bt: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """C = A @ Bt.T: a (M, K), bt (N, K), both bfloat16 or both float32,
    float32 accumulation → (M, N) in ``out_dtype`` (float32 default, or
    bfloat16: the float32 result rounded to nearest even).

    CUDA: the hand-written kernels of ``csrc/matmul_bf16.cu`` (bf16: K %
    8 == 0) and ``csrc/matmul.cu`` (float32: K % 4 == 0, float32
    accuracy, bt split into its TF32 parts first by the split kernel,
    ``tf32_split``, within the call);
    CPU: the plain version."""
    if a.dtype not in (torch.bfloat16, torch.float32) or bt.dtype != a.dtype:
        raise TypeError(f"matmul_float takes two bfloat16 or two float32 "
                        f"operands, got {a.dtype} and {bt.dtype}")
    if a.dim() != 2 or bt.dim() != 2 or bt.shape[1] != a.shape[1]:
        raise ValueError(f"a (M, K) and bt (N, K) expected, got "
                         f"{tuple(a.shape)} and {tuple(bt.shape)}")
    return _matmul_float(a, bt, False, out_dtype)


def b_operand(b: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """How the bf16 kernel reads B (K, N): (B itself, True) where it is
    row-major with N % 8 == 0 (the TMA map's 16-byte row pitch; MN-major,
    no copy); (B.T, False) where B is the transposed view of a row-major
    Bt (N, K) (K-major, no copy); else a row-major copy of B (N % 8 ==
    0) or of B.T."""
    k, n = b.shape
    if b.stride() == (n, 1) and n % 8 == 0:
        return b, True
    if b.stride() == (1, k):
        return b.T, False
    if n % 8 == 0:
        return b.contiguous(), True
    return b.T.contiguous(), False


def staged_epilogue(out_dtype, n: int) -> bool:
    """Whether the bf16 kernel stores C (M, n) in ``out_dtype`` through
    its STAGED epilogue (TMA stores running beside the next tile's
    products, a 3-stage ring; the kernel's mode bit 3) rather than its
    DIRECT one (row pieces from registers, a 4-stage ring): for a bf16 C
    with 16-byte rows (n % 8 == 0). An f32 C always takes DIRECT: staged,
    it needed two rounds a tile and ran slower on an H100 (PERF.md)."""
    return out_dtype == torch.bfloat16 and n % 8 == 0


def _matmul_float(a: torch.Tensor, b: torch.Tensor, bmn: bool,
                  out_dtype=None) -> torch.Tensor:
    """matmul_float with B as ``b``: Bt (N, K), or with bmn (bf16 only) B
    (K, N) itself (the kernel's mode bit 2)."""
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    m, k = a.shape
    n = b.shape[1] if bmn else b.shape[0]
    if not on_cuda(a, b):
        return _matmul_float_plain(a, b if bmn else b.T, out_dtype)
    f32 = a.dtype == torch.float32
    if k % (4 if f32 else 8):
        raise ValueError(f"the {str(a.dtype)[6:]} kernel needs K % "
                         f"{4 if f32 else 8} == 0 (16-byte rows), got "
                         f"K = {k}")
    a, b = tma_operand(a), tma_operand(b)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    mode = int(out_dtype == torch.bfloat16)
    if f32:
        b, lib, fn, err = tf32_split(b), _float_lib(), "mm_float_launch", \
            "mm_float_error_string"
        mode |= 2
    else:
        lib, fn, err = _bf16_lib(), "mm_bf16_launch", "mm_bf16_error_string"
        mode |= 4 * int(bmn) | 8 * int(staged_epilogue(out_dtype, n))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                              n, k, mode, stream)
    _build.check(rc, lib, err, "matmul_float")
    matmul_float.launches += 1
    matmul_float.launches_f32 += f32
    return out


# launches of the kernels, and of those the float32 kernel's
matmul_float.launches = matmul_float.launches_f32 = 0


def matmul_pallas(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 512,
                  out_dtype=None, interpret=None) -> torch.Tensor:
    """C = A @ B with A (M, K) and B (K, N) (the JAX ``matmul_pallas``):
    int8 operands accumulate in int32 (``matmul_int8``), bf16 or float32
    operands in float32 (``matmul_float``); the result is stored in
    ``out_dtype``, by default the accumulator's type.

    Args:
      block_m, interpret: accepted for the JAX signature and ignored (the
        TPU's row block and interpret mode have no counterpart here).
    """
    del block_m, interpret
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"2-D operands expected, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype == torch.int8:
        _check_int8(a, b)
        out = matmul_int8(a, b.T.contiguous())
        return out if out_dtype in (None, torch.int32) else out.to(out_dtype)
    if a.dtype == b.dtype == torch.bfloat16 and b.shape[0] == a.shape[1] \
            and on_cuda(a, b):
        return _matmul_float(a, *b_operand(b), out_dtype)
    return matmul_float(a, b.T.contiguous(), out_dtype)


def _float_lib() -> ctypes.CDLL:
    lib = _build.library("matmul")
    fn = lib.mm_float_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def _bf16_lib() -> ctypes.CDLL:
    lib = _build.library("matmul_bf16")
    fn = lib.mm_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def _int8_lib() -> ctypes.CDLL:
    lib = _build.library("int8_mm")
    fn = lib.int8_mm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return lib
