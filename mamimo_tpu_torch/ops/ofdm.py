"""OFDM modulation and demodulation with MATLAB ``ofdmmod``/``ofdmdemod``
semantics (the port's copy of ``mamimo_tpu/ops/ofdm.py``; used as at
``generate_maMIMO_LTF.m:336,498``).

Grid convention: a full fft-length grid laid out fftshifted: grid
position ``fft/2`` is DC and position p carries signed DFT bin
``p - fft/2``. Modulation is ``ifft(ifftshift(grid))`` with MATLAB's 1/N
ifft normalization, plus a cyclic prefix; demodulation is the exact
inverse (drop the CP, plain ``fft``, ``fftshift``), so
``demod(mod(x)) == x``.

Every function is polymorphic over leading batch dims. The transforms
are ``torch.fft`` (cuFFT on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig


def _index(locs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(locs, np.int64), device=device)


def build_grid(cfg: SimConfig, data, pilots=None) -> torch.Tensor:
    """Scatter data (and optional pilot) carriers into a full fftshifted
    grid.

    Args:
      data:   (..., num_carriers, nsym, nsts) complex
      pilots: (..., num_pilots, nsym, nsts) complex, or None (zeros)

    Returns:
      (..., fft_length, nsym, nsts) complex grid on data's device.
    """
    data = torch.as_tensor(data)
    grid = data.new_zeros(data.shape[:-3] + (cfg.fft_length,)
                          + data.shape[-2:])
    grid[..., _index(cfg.carrier_locations, data.device), :, :] = data
    if pilots is not None:
        grid[..., _index(cfg.pilot_indices, data.device), :, :] = \
            torch.as_tensor(pilots, device=data.device).to(data.dtype)
    return grid


def ofdm_modulate(cfg: SimConfig, data, pilots=None) -> torch.Tensor:
    """OFDM-modulate a data grid into time samples (MATLAB
    ``ofdmmod(data, fft, cp, nullIdx, pilotIdx, pilots)``).

    Args:
      data:   (..., num_carriers, nsym, nsts)
      pilots: optional (..., num_pilots, nsym, nsts)

    Returns:
      (..., nsym * (fft + cp), nsts) complex time signal, the symbols
      one after another along time.
    """
    grid = build_grid(cfg, data, pilots)                     # (..., F, S, T)
    grid = torch.fft.ifftshift(grid, dim=-3)
    t = torch.fft.ifft(grid, dim=-3)
    sym = torch.cat([t[..., -cfg.cp_length:, :, :], t], dim=-3)
    sym = sym.movedim(-2, -3)                                # (..., S, F+cp, T)
    return sym.reshape(sym.shape[:-3] + (sym.shape[-3] * sym.shape[-2],
                                         sym.shape[-1]))


def ofdm_demodulate(cfg: SimConfig, sig, nsym: int | None = None):
    """OFDM-demodulate time samples into data and pilot grids (MATLAB
    ``ofdmdemod(sig, fft, cp, symOffset=cp, nullIdx, pilotIdx)``): per
    symbol the samples [cp : cp + fft], fft, fftshift, then the data and
    pilot carriers.

    Args:
      sig:  (..., nsamp, nrx) with nsamp >= nsym * (fft + cp)
      nsym: number of OFDM symbols (nsamp // sym_len if None)

    Returns:
      (data, pilots): (..., num_carriers, nsym, nrx) and
      (..., num_pilots, nsym, nrx).
    """
    sig = torch.as_tensor(sig)
    sym_len = cfg.sym_len
    if nsym is None:
        nsym = sig.shape[-2] // sym_len
    x = sig[..., :nsym * sym_len, :].reshape(
        sig.shape[:-2] + (nsym, sym_len, sig.shape[-1]))
    x = x[..., cfg.cp_length:, :]                            # CP removal
    X = torch.fft.fftshift(torch.fft.fft(x, dim=-2), dim=-2)  # (..., S, F, R)
    X = X.movedim(-3, -2)                                    # (..., F, S, R)
    return (X[..., _index(cfg.carrier_locations, X.device), :, :],
            X[..., _index(cfg.pilot_indices, X.device), :, :])
