"""Receiver front end: gain and AWGN at a target SNR, power scaling, sync
(the port's copy of ``mamimo_tpu/channel/noise.py``).

Replicates the ``useNoiseFig=false`` power accounting of
``generate_maMIMO_LTF.m:239-332``:

* per-antenna signal power  sig_dB = 10·log10(mean|x|²)
* noise power  noise_dB = mean_antennas(sig_dB − SNR_target + gain_dB)
* realized per-antenna SNR  snr_CS = sig_dB − noise_dB + gain_dB
* preamp output  y = 10^(gain/20)·x + n,  n ~ CN(0, 10^(noise_dB/10))
* used-subcarrier power scaling  y *= sqrt(used_sc)/fft
  (generate_maMIMO_LTF.m:303)
* sync: slice [chan_delay : chan_delay + (nsamp − num_pad_zeros)]
  (generate_maMIMO_LTF.m:326-327)

Every chain works on a leading packet axis, or none: rx_sig (..., nsamp,
num_rx) with per-packet chan_delay (...). Each takes its standard-normal
draws as an argument, ``z`` of shape rx_sig.shape + (2,) with [..., 0]
the real and [..., 1] the imaginary part (JAX's layout, so the tests
feed JAX's own draws); ``draw_normal`` makes one from a generator.
"""

from __future__ import annotations

import math

import torch

from mamimo_tpu_torch.config import SimConfig


def draw_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard-normal draws of ``shape`` + (2,) from ``gen`` on its
    device: one receiver chain's noise for a signal of ``shape``."""
    return torch.randn(tuple(shape) + (2,), generator=gen, device=gen.device)


def sync_slice(cfg: SimConfig, y: torch.Tensor, chan_delay) -> torch.Tensor:
    """Remove the channel delay and the tail padding: y (..., nsamp, R) →
    (..., nsamp − num_pad_zeros, R), each packet from its own chan_delay
    (...), as one gather. The start is clamped into the signal as JAX's
    dynamic_slice clamps it."""
    nsamp, out_len = y.shape[-2], y.shape[-2] - cfg.num_pad_zeros
    start = torch.as_tensor(chan_delay, device=y.device).to(torch.int64)
    start = torch.clamp(start, 0, nsamp - out_len)
    idx = start[..., None] + torch.arange(out_len, device=y.device)
    idx = idx[..., None].expand(idx.shape + (y.shape[-1],))
    return torch.gather(y, -2, idx)


def _cn(z: torch.Tensor, var) -> torch.Tensor:
    """CN(0, var) complex64 from standard-normal pairs z (..., 2); var a
    float (its scale taken in float64, as JAX takes it) or a float32
    tensor broadcasting against z[..., 0]."""
    std = (math.sqrt(var / 2.0) if isinstance(var, float)
           else torch.sqrt(var / 2.0))
    return torch.complex(z[..., 0], z[..., 1]) * std


def _sig_db(rx_sig: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.mean(rx_sig.abs() ** 2, dim=-2))


def _scale(cfg: SimConfig, y: torch.Tensor) -> torch.Tensor:
    return y * (math.sqrt(cfg.used_sc) / cfg.fft_length)


def receiver_chain(cfg: SimConfig, z, rx_sig, snr_db, gain_db, chan_delay,
                   noise_power_db=None):
    """Preamp gain and AWGN, subcarrier power scaling and sync.

    Args:
      z: standard-normal draws, rx_sig.shape + (2,).
      rx_sig: (..., nsamp, num_rx) complex channel output (with tail
        padding).
      snr_db: target sounding SNR (scalar, dB); ignored when
        noise_power_db is given.
      gain_db: preamp gain (= spLoss, generate_maMIMO_LTF.m:236).
      chan_delay: (...) integer sync offsets in samples.
      noise_power_db: fixed noise power; the "perfect CSI" leg uses
        −100 dB (BER_test_maMIMO_LTF.m:268-271).

    Returns:
      (y_sync, snr_cs, noise_db): (..., nsamp − pad, num_rx) complex64,
      (..., num_rx) realized per-antenna SNR [dB], (...) applied noise
      power [dB].
    """
    rx_sig = torch.as_tensor(rx_sig).to(torch.complex64)
    sig_db = _sig_db(rx_sig)                                 # (..., R)
    if noise_power_db is None:
        noise_db = torch.mean(sig_db - snr_db + gain_db, dim=-1)
    else:
        noise_db = torch.full(sig_db.shape[:-1], float(noise_power_db),
                              device=sig_db.device)
    snr_cs = sig_db - noise_db[..., None] + gain_db
    n_var = 10.0 ** (noise_db / 10.0)
    noise = _cn(z, n_var[..., None, None])
    gain_amp = 10.0 ** (torch.as_tensor(gain_db, dtype=torch.float32,
                                        device=rx_sig.device) / 20.0)
    y = _scale(cfg, gain_amp * rx_sig + noise)
    return sync_slice(cfg, y, chan_delay), snr_cs, noise_db


def thermal_noise_power(cfg: SimConfig) -> float:
    """MATLAB ``noisepow(fs, NF, 290)``: k·T·fs·10^(NF/10) [W], the
    thermal noise floor of the useNoiseFig=true receiver branch
    (generate_maMIMO_LTF.m:270-292)."""
    k_boltz = 1.380649e-23
    return k_boltz * 290.0 * cfg.chan_srate * 10.0 ** (
        cfg.noise_figure / 10.0)


def receiver_chain_nf(cfg: SimConfig, z, rx_sig, gain_db, chan_delay):
    """The noise-figure receiver (the useNoiseFig=true branch): thermal
    noise set by bandwidth and noise figure instead of a target SNR, the
    subcarrier scale factor applied to its variance
    (generate_maMIMO_LTF.m:280-292). The realized SNR is the input
    signal power over the input-referred noise power, and the gain
    amplifies signal and noise together (phased.ReceiverPreamp), as in
    the JAX function (which documents its deviation from the
    reference's printed value).

    Returns (y_sync, snr_db per antenna (..., R), noise_db (...)).
    """
    rx_sig = torch.as_tensor(rx_sig).to(torch.complex64)
    sc_fact = (cfg.used_sc / cfg.fft_length ** 2) / cfg.num_tx
    n_var = thermal_noise_power(cfg) / sc_fact
    noise_db = 10.0 * math.log10(n_var)
    snr_db = _sig_db(rx_sig) - noise_db
    noise = _cn(z, n_var)
    gain_amp = 10.0 ** (torch.as_tensor(gain_db, dtype=torch.float32,
                                        device=rx_sig.device) / 20.0)
    y = _scale(cfg, gain_amp * (rx_sig + noise))
    return (sync_slice(cfg, y, chan_delay), snr_db,
            torch.full(snr_db.shape[:-1], noise_db, device=snr_db.device))


def interference_chain(cfg: SimConfig, z_noise, z_intf, rx_sig, chan_delay,
                       noise_power_dbm: float = -85.0,
                       interference_power_dbm: float = -55.0):
    """The SINR variant (generate_maMIMO_LTF_SINR.m:225-251): a fixed
    thermal floor (−85 dBm) plus complex-Gaussian interference (−55 dBm),
    no preamp gain; ``z_noise`` and ``z_intf`` are the two draws. As in
    the JAX function, the SINR comes from the measured received power,
    the draws are unit-variance circular Gaussians, and the reported
    noise power is the summed noise and interference power.

    Returns (y_sync, sinr_db per antenna (..., R), noise_db (...)).
    """
    rx_sig = torch.as_tensor(rx_sig).to(torch.complex64)
    dev = rx_sig.device
    noise_db = torch.tensor(noise_power_dbm - 30.0, device=dev)
    intf_db = torch.tensor(interference_power_dbm - 30.0, device=dev)
    denom_db = 10.0 * torch.log10(10.0 ** (noise_db / 10.0)
                                  + 10.0 ** (intf_db / 10.0))
    sinr_db = _sig_db(rx_sig) - denom_db
    y = _scale(cfg, rx_sig + _cn(z_noise, 10.0 ** (noise_db / 10.0))
               + _cn(z_intf, 10.0 ** (intf_db / 10.0)))
    return (sync_slice(cfg, y, chan_delay), sinr_db,
            denom_db.expand(sinr_db.shape[:-1]))
