"""Least-squares channel estimation (the port's copy of the planes and
matmul forms of ``mamimo_tpu/ops/estimate.py``).

``ls_estimate_planes`` (flat rx-major planes) is the plain PyTorch
version of the flat-planes LS kernels, ``ls_estimate_matmul``
(time-major complex preambles) that of the per-pair LS kernel
(``ops/kernels/fused_ls.py``): the CPU paths, and the references the
kernels are held to on the card.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.ltf import _hadamard_np, _ltf_np
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def dft_selected_np(cfg: SimConfig) -> np.ndarray:
    """Scaled selected-bin DFT matrix A[c, t] = exp(-2πj·b_c·t/N) /
    (nltf·ltf_c), with b_c the signed bin of data carrier c (fftshift
    folded in). (num_carriers, fft_length) complex64."""
    n = cfg.fft_length
    bins = np.asarray(cfg.carrier_locations, np.float64) - n // 2
    t = np.arange(n)
    a = np.exp(-2j * np.pi * bins[:, None] * t[None, :] / n)
    ltf = _ltf_np(n)[np.asarray(cfg.carrier_locations)].astype(np.float64)
    return (a / (cfg.num_tx * ltf)[:, None]).astype(np.complex64)


def dft_selected_padded_np(cfg: SimConfig) -> np.ndarray:
    """dft_selected_np extended to the full CP+FFT symbol length with
    zero columns over the CP samples: (num_carriers, sym_len)."""
    a = dft_selected_np(cfg)
    out = np.zeros((a.shape[0], cfg.sym_len), np.complex64)
    out[:, cfg.cp_length:] = a
    return out


def ls_matmul_constants(cfg: SimConfig, device=None):
    """Constants of ls_estimate_matmul: (A, P) with A =
    dft_selected_np(cfg), (num_carriers, fft_length) complex64, and P the
    float32 ±1 Hadamard matrix."""
    return (torch.as_tensor(dft_selected_np(cfg), device=device),
            torch.as_tensor(_hadamard_np(cfg.num_tx), device=device))


def ls_estimate_matmul(cfg: SimConfig, rx: torch.Tensor,
                       consts=None) -> torch.Tensor:
    """LS estimation from time-major received preambles as two batched
    products: the despread over the symbols (CP dropped), then the
    DFT-select over time. The plain version of the per-pair LS kernel
    (``ops/kernels/fused_ls.py::ls_estimate_pallas``).

    Args:
      rx: (B, len_ltf, num_rx) complex64.
      consts: optional (A, P) from ls_matmul_constants.

    Returns:
      (B, num_carriers, num_tx, num_rx) complex64.
    """
    if consts is None:
        consts = ls_matmul_constants(cfg, device=rx.device)
    a, p = consts
    b, _, nrx = rx.shape
    x = rx.reshape(b, cfg.num_tx, cfg.sym_len, nrx)[:, :, cfg.cp_length:, :]
    y = torch.einsum("jn,bntr->bjtr", p.to(rx.dtype), x)
    return torch.einsum("ct,bjtr->bcjr", a.to(rx.dtype), y)


def ls_planes_constants(cfg: SimConfig, dtype=torch.float32, device=None):
    """Constants of ls_estimate_planes: (At_r, At_i, P) with
    At = dft_selected_padded_np(cfg).T as separate real planes
    (sym_len, C) in ``dtype`` and P the float32 ±1 Hadamard matrix."""
    at = dft_selected_padded_np(cfg).T                 # (sym_len, C)
    return (torch.as_tensor(np.real(at).copy(), device=device).to(dtype),
            torch.as_tensor(np.imag(at).copy(), device=device).to(dtype),
            torch.as_tensor(_hadamard_np(cfg.num_tx), device=device))


def ls_estimate_planes(cfg: SimConfig, planes: torch.Tensor,
                       consts=None, dtype=None) -> torch.Tensor:
    """LS estimation from canonical rx-major real planes.

    * input is (2, S, len_ltf) ([0]=real, [1]=imag, S = B·num_rx in
      rx-major order);
    * the CP drop is zero rows folded into the DFT matrix;
    * the complex DFT-select is 4 real matmuls over the free
      (S·num_tx, sym_len) reshape; the despread contracts the symbol
      axis with P.

    Args:
      planes: (2, S, nsym·sym_len) float32 or bfloat16: the whole
        preamble (nsym = num_tx), or one rank's nsym contiguous symbols
        of a sequence-sharded preamble.
      consts: optional (At_r, At_i, P) from ls_planes_constants; the
        products and sums are float32 whatever their dtype. For a
        rank's symbols P is their columns (num_tx, nsym) of the full P,
        and the result is the rank's partial despread.
      dtype: optional operand dtype of the DFT products (e.g. bfloat16,
        the JAX function's bf16 matrix-unit path): the planes and the DFT
        planes are rounded to it, and the products still accumulate and
        return float32 (in full float32 on the card, not TF32), as JAX's
        ``preferred_element_type=float32`` does.

    Returns:
      (S, num_tx, num_carriers) complex64, rx-major.
    """
    if consts is None:
        consts = ls_planes_constants(cfg, device=planes.device)
    at_r, at_i, p = consts
    _, s, L = planes.shape
    nsym, c = L // cfg.sym_len, cfg.num_carriers
    x = planes.reshape(2, s * nsym, cfg.sym_len)
    if dtype is not None:
        x, at_r, at_i = (t.to(dtype) for t in (x, at_r, at_i))
    x, at_r, at_i = x.float(), at_r.float(), at_i.float()
    with full_f32_matmul() if dtype is not None else nullcontext():
        zr = x[0] @ at_r - x[1] @ at_i                 # (S·nsym, C)
        zi = x[0] @ at_i + x[1] @ at_r
        pp = p.to(zr)
        hr = torch.einsum("jn,snc->sjc", pp, zr.reshape(s, nsym, c))
        hi = torch.einsum("jn,snc->sjc", pp, zi.reshape(s, nsym, c))
    return torch.complex(hr, hi)
