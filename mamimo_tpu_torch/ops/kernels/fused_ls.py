"""LS estimate from the canonical flat planes: wrapper of the hand-written
CUDA kernel ``csrc/ls_v2.cu`` (the counterpart of
``mamimo_tpu/ops/pallas/fused_ls.py``, v2 flat-planes kernel).

On a CUDA tensor ``ls_planes_v2`` launches the kernel; on a CPU tensor it
runs the kernel's plain version, ``ops/estimate.py::ls_estimate_planes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.estimate import dft_selected_padded_np, ls_estimate_planes
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import _round_up, on_cuda
from mamimo_tpu_torch.ops.ltf import _hadamard_np


def ls_planes_pallas_v2_constants(cfg: SimConfig, block_samples: int = 8,
                                  dtype=torch.float32, device=None):
    """The TPU kernel's constants (B, K): B = [At_r | At_i] of shape
    (sym_len, 2·Cp) with the CP drop as zero rows and the carriers padded
    to Cp = round_up(num_carriers, 128); K = I_block ⊗ P. The CUDA
    kernel's DFT matrix is derived from B (``ls_kernel_constants``)."""
    at = dft_selected_padded_np(cfg).T                 # (sym_len, C)
    cp_ = _round_up(cfg.num_carriers, 128)
    b = np.zeros((cfg.sym_len, 2 * cp_), np.float32)
    b[:, :cfg.num_carriers] = np.real(at)
    b[:, cp_:cp_ + cfg.num_carriers] = np.imag(at)
    k = np.kron(np.eye(block_samples, dtype=np.float32),
                _hadamard_np(cfg.num_tx).astype(np.float32))
    return (torch.as_tensor(b, device=device).to(dtype),
            torch.as_tensor(k, device=device).to(dtype))


def ls_v2_to_complex(cfg: SimConfig, h: torch.Tensor, s: int) -> torch.Tensor:
    """Densify the TPU kernel's (rows, 2·Cp) output to (S, num_tx,
    num_carriers) complex64 rx-major."""
    cp_ = h.shape[1] // 2
    nsym, c = cfg.num_tx, cfg.num_carriers
    hr = h[: s * nsym, :c].reshape(s, nsym, c).float()
    hi = h[: s * nsym, cp_:cp_ + c].reshape(s, nsym, c).float()
    return torch.complex(hr, hi)


def ls_kernel_constants(cfg: SimConfig, device=None) -> torch.Tensor:
    """The CUDA kernel's DFT-select matrix, (2·fft, 2·Cp) bf16: the real
    form [[Ar, Ai], [-Ai, Ar]] of the complex product, rows over the fft
    samples only (the kernel skips the CP by address), so that
    [xr | xi] @ it = [zr | zi]."""
    b, _ = ls_planes_pallas_v2_constants(cfg, 1)
    cp_ = b.shape[1] // 2
    top = b[cfg.cp_length:]                            # xr rows: [Ar | Ai]
    bot = torch.cat([-top[:, cp_:], top[:, :cp_]], 1)  # xi rows: [-Ai | Ar]
    return torch.cat([top, bot]).to(device=device, dtype=torch.bfloat16)


def _check_kernel_shapes(cfg: SimConfig, planes: torch.Tensor,
                         bmat: torch.Tensor) -> None:
    nt = cfg.num_tx
    if planes.dtype != torch.bfloat16 or bmat.dtype != torch.bfloat16:
        raise TypeError("the LS kernel takes bfloat16 planes and constants")
    if planes.dim() != 3 or planes.shape[0] != 2 \
            or planes.shape[2] != cfg.len_ltf:
        raise ValueError(f"planes must be (2, S, {cfg.len_ltf}), "
                         f"got {tuple(planes.shape)}")
    cp_ = _round_up(cfg.num_carriers, 128)
    if tuple(bmat.shape) != (2 * cfg.fft_length, 2 * cp_):
        raise ValueError(f"kernel constants must be ({2 * cfg.fft_length}, "
                         f"{2 * cp_}), got {tuple(bmat.shape)}")
    if nt > 128 or nt & (nt - 1) or cfg.fft_length % 32 \
            or cfg.cp_length % 8:
        raise ValueError("the LS kernel needs num_tx a power of 2 <= 128, "
                         "fft_length % 32 == 0 and cp_length % 8 == 0")


def ls_planes_v2(cfg: SimConfig, planes: torch.Tensor,
                 consts: torch.Tensor | None = None) -> torch.Tensor:
    """LS estimate of every (sample, tx, carrier) from flat planes.

    Args:
      planes: (2, S, len_ltf) — bfloat16 on CUDA (the kernel's input);
        float32 or bfloat16 on the CPU.
      consts: CUDA only, ``ls_kernel_constants(cfg, device)``; built per
        call when omitted.

    Returns:
      (2, S, num_tx, num_carriers) float32 planes ([0]=real, [1]=imag),
      dense (no padding), rx-major.
    """
    if not on_cuda(planes):
        h = ls_estimate_planes(cfg, planes.float())
        return torch.stack([h.real, h.imag])
    if consts is None:
        consts = ls_kernel_constants(cfg, planes.device)
    planes = planes.contiguous()
    _check_kernel_shapes(cfg, planes, consts)
    s = planes.shape[1]
    out = torch.empty((2, s, cfg.num_tx, cfg.num_carriers),
                      dtype=torch.float32, device=planes.device)
    lib = _ls_lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ls_planes_v2_launch(
            planes.data_ptr(), consts.data_ptr(), out.data_ptr(), s,
            cfg.num_tx, cfg.num_carriers, cfg.sym_len, cfg.cp_length,
            cfg.fft_length, consts.shape[1] // 2, stream)
    _build.check(rc, lib, "ls_planes_v2_error_string", "ls_planes_v2")
    ls_planes_v2.launches += 1
    return out


ls_planes_v2.launches = 0


def _ls_lib() -> ctypes.CDLL:
    lib = _build.library("ls_v2")
    fn = lib.ls_planes_v2_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib
