"""LTF frequency sequence, orthogonal pilot-mapping matrix P and the
sounding preamble (the port's copy of ``mamimo_tpu/ops/ltf.py``).

* the 256-bin LTF tone sequence is spelled out verbatim at
  ``helperMIMOChannelEstimate.m:16-23``;
* P is the Sylvester/Hadamard ±1 matrix (P Pᵀ = numSTS·I), so that
  ``hD(:,j,i) = rxsym*P(:,j)'/(nltf*ltf)`` recovers the channel;
* on LTF symbol n, Tx stream j transmits ``ltf[k] * P[j, n]`` on every
  non-null carrier.

The preamble is normalized to unit total radiated time-domain power
(amplitude scale ``fft/sqrt(used_sc)/sqrt(num_sts)``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

# helperMIMOChannelEstimate.m:16-19
_LTF_LEFT = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1,
             1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
_LTF_RIGHT = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1,
              -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]


@lru_cache(maxsize=None)
def _ltf_np(fft_length: int = 256) -> np.ndarray:
    """256-bin LTF sequence on the fftshifted grid
    (helperMIMOChannelEstimate.m:20-23)."""
    if fft_length != 256:
        raise ValueError("the reference LTF sequence is defined for FFT 256, "
                         f"got {fft_length}")
    L, R = _LTF_LEFT, _LTF_RIGHT
    seq = (
        [0] * 7
        + L + [1] + R
        + [-1, -1, -1, 1, 1, -1, 1, -1, 1, 1, -1]
        + L + [1] + R
        + [1, -1, 1, -1]
        + [0]
        + [1, -1, -1, 1]
        + L + [1] + R
        + [-1, -1, -1, 1, 1, -1, 1, -1, 1, 1, -1]
        + L + [1] + R
        + [0] * 6
    )
    out = np.asarray(seq, np.float32)
    assert out.shape == (fft_length,)
    return out


def ltf_sequence(cfg: SimConfig, device=None) -> torch.Tensor:
    """Full fftshifted-grid LTF sequence, shape (fft_length,)."""
    return torch.as_tensor(_ltf_np(cfg.fft_length), device=device)


def ltf_data_carriers(cfg: SimConfig, device=None) -> torch.Tensor:
    """LTF values restricted to data carriers, shape (num_carriers,). ±1."""
    return torch.as_tensor(
        _ltf_np(cfg.fft_length)[np.asarray(cfg.carrier_locations)],
        device=device,
    )


@lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    if n < 1 or n & (n - 1):
        raise ValueError(f"numSTS must be a power of 2, got {n}")
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix H with H Hᵀ = n·I, entries ±1."""
    return _hadamard_np(n)


def pilot_p_matrix(num_sts: int, device=None) -> torch.Tensor:
    """Orthogonal pilot-mapping matrix P (helperGetP equivalent).

    Row j is the ±1 signature with which Tx stream j is spread across the
    nltf = num_sts LTF symbols; column ``P[:, iTx]`` is the per-link DNN
    pilot input (massiveMIMO_dataGenerator.py:311).
    """
    return torch.as_tensor(_hadamard_np(num_sts), device=device)


def preamble_scale(cfg: SimConfig, num_sts: int) -> float:
    """Amplitude scale giving ~unit total radiated power."""
    return cfg.fft_length / math.sqrt(cfg.used_sc) / math.sqrt(num_sts)


def gen_preamble(cfg: SimConfig, num_sts: int | None = None, v=None):
    """The sounding or data preamble (helperGenPreamble).

    Args:
      num_sts: number of streams to sound (default cfg.num_tx: the
        generator sets ``prm.numSTS = numTx`` to sound all channels,
        generate_maMIMO_LTF.m:201).
      v: optional per-carrier baseband precoding, (..., num_carriers,
        num_sts, nout) complex tensor: the feedback-weights path
        (``helperGenPreamble(prm, v)``, generate_maMIMO_LTF.m:505). Each
        carrier's stream vector is precoded with the Frobenius-normalized
        ``v`` (unit norm: deliberately without the sqrt(numTx) of the
        data symbols, generate_maMIMO_LTF.m:487-491, since the receiver
        divides the equalized data by sqrt(numTx), :590).

    Returns:
      without v: (num_sts*(fft+cp), num_sts) complex64 numpy time signal,
      column j what Tx antenna j radiates; with v: (..., num_sts*(fft+cp),
      nout) complex64 tensor on v's device.
    """
    if num_sts is None:
        num_sts = cfg.num_tx
    ltf = _ltf_np(cfg.fft_length)
    P = _hadamard_np(num_sts)
    scale = preamble_scale(cfg, num_sts)
    # grid[k, n, j] = ltf[k] * P[j, n] * scale
    grid = (ltf[:, None, None] * P.T[None, :, :] * scale).astype(np.complex64)
    if v is None:
        t = np.fft.ifft(np.fft.ifftshift(grid, axes=0), axis=0)
        sym = np.concatenate([t[-cfg.cp_length:], t], axis=0)
        sym = np.moveaxis(sym, 1, 0)                  # (nsym, F+cp, nsts)
        return sym.reshape(sym.shape[0] * sym.shape[1],
                           sym.shape[2]).astype(np.complex64)

    v = torch.as_tensor(v).to(torch.complex64)        # (..., C, nsts, nout)
    fro = torch.linalg.vector_norm(v, dim=(-2, -1), keepdim=True)
    norm_v = v / torch.clamp(fro, min=1e-30)
    full_v = v.new_zeros(v.shape[:-3] + (cfg.fft_length,) + v.shape[-2:])
    carr = torch.as_tensor(np.asarray(cfg.carrier_locations, np.int64),
                           device=v.device)
    full_v[..., carr, :, :] = norm_v
    with full_f32_matmul():
        g = torch.einsum("fsj,...fjo->...fso",
                         torch.as_tensor(grid, device=v.device), full_v)
    t = torch.fft.ifft(torch.fft.ifftshift(g, dim=-3), dim=-3)
    sym = torch.cat([t[..., -cfg.cp_length:, :, :], t], dim=-3)
    sym = sym.movedim(-2, -3)                         # (..., S, F+cp, nout)
    return sym.reshape(sym.shape[:-3] + (sym.shape[-3] * sym.shape[-2],
                                         sym.shape[-1]))
