"""Single-bounce scattering MIMO channel (the port's copy of
``mamimo_tpu/channel/scattering.py``).

Replaces ``phased.ScatteringMIMOChannel`` as configured in
``helperApplyMUChannel.m:85-133``: a BS (Tx) array at the origin, the
user (Rx) array at a random position within ``max_range``, point
scatterers uniform in a box of half-size ``scat_radius_frac · range``
around the Rx, CN(0, 1) gains, free-space spreading loss λ/(4πd) and the
carrier phase exp(−j2πd/λ) over each Tx→scatterer→Rx path, path delays
between the arrays' reference positions, and the channel delay
floor(min τ · Fs) samples.

Random draws come from an explicit ``torch.Generator`` in place of a JAX
key. The two give different numbers for the same seed, so the
realization math is also exposed on given draws (``scenario_from_draws``,
``scattering_from_draws``), which the tests feed with the JAX package's
draws. Every float32 operation runs in the JAX package's order, and the
path lengths with the fused multiply-adds of XLA's compiled code
(``fma32``: the scatterer positions and the norms' sums of squares), as
JAX computes them under ``jit`` (``generate_dataset``). The carrier
phase ``unit_phasor(−d/λ)`` turns one float32 ulp of a 1 km path (about
6e-5 m) into about 0.006 cycles: one rounding more or less in d (JAX
eager against JAX jit) moves ``cr`` by about 1e-2 relative, so d is
computed in JAX's roundings; it stays float32 as in JAX (float64 would
move it further from the reference).

The channel is applied in the frequency domain (``apply_channel``): each
path's fractional delay is an exact phase ramp over a zero-padded FFT.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.utils.numerics import fma32, full_f32_matmul, unit_phasor


def _f32(x, device=None) -> torch.Tensor:
    """x (a tensor, numpy array or number) as a float32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def fspl_db(dist, lam):
    """Free-space path loss in dB (MATLAB ``fspl``)."""
    return 20.0 * torch.log10(4.0 * math.pi * _f32(dist) / lam)


def ula_positions(n: int, spacing: float) -> np.ndarray:
    """Element positions of an n-element ULA along the y axis, centred at
    the origin (phased.ULA's getElementPosition layout).

    Returns (3, n) float32 metres."""
    y = (np.arange(n) - (n - 1) / 2.0) * spacing
    pos = np.zeros((3, n), np.float32)
    pos[1] = y
    return pos


def ura_positions(n: int, ncols: int, spacing: float) -> np.ndarray:
    """n-element uniform rectangular array in the y-z plane
    ([n/ncols × ncols] grid, phased.URA([expFactor numSTS]) layout,
    helperApplyMUChannel.m:53-55). Returns (3, n) float32 metres."""
    nrows = n // ncols
    if nrows * ncols != n:
        raise ValueError(f"{n} elements do not fill {ncols} columns")
    y = (np.arange(ncols) - (ncols - 1) / 2.0) * spacing
    z = (np.arange(nrows) - (nrows - 1) / 2.0) * spacing
    pos = np.zeros((3, n), np.float32)
    yy, zz = np.meshgrid(y, z)
    pos[1] = yy.reshape(-1)
    pos[2] = zz.reshape(-1)
    return pos


def helper_array_info(num_tx: int, num_rx: int, num_sts: int,
                      validate: bool = True):
    """Array-geometry dispatch of the MathWorks ``helperArrayInfo(prm)``
    helper (generate_maMIMO_LTF.m:123, helperApplyMUChannel.m:49): a ULA
    of numTx elements when one data stream is sounded, a partitioned URA
    of [numTx/numSTS × numSTS] elements otherwise
    (generate_maMIMO_LTF.m:126-136); the Rx array follows the same rule
    (generate_maMIMO_LTF.m:145-156).

    Returns (is_tx_ura, exp_factor_tx, is_rx_ura, exp_factor_rx).
    """
    if validate:
        if num_tx % num_sts:
            raise ValueError(
                f"num_tx={num_tx} must be a multiple of num_sts={num_sts}")
        if num_rx % num_sts:
            raise ValueError(
                f"num_rx={num_rx} must be a multiple of num_sts="
                f"{num_sts} (the reference partitions the Rx array as "
                f"[numRx/numSTS x numSTS], generate_maMIMO_LTF.m:145-156)")
    exp_tx = num_tx // num_sts
    exp_rx = num_rx // num_sts
    is_ura = num_sts > 1
    return is_ura, exp_tx, is_ura, exp_rx


def resolve_geometry(geometry: str, num_sts: int) -> str:
    """Map the config's geometry flag to a concrete layout: 'auto'
    follows helper_array_info (URA iff num_sts > 1); 'ula'/'ura' are
    manual overrides."""
    if geometry == "auto":
        return "ura" if num_sts > 1 else "ula"
    return geometry


def array_positions(n: int, geometry: str, spacing: float,
                    ncols: int = 1) -> np.ndarray:
    if resolve_geometry(geometry, max(ncols, 1)) == "ura":
        return ura_positions(n, max(ncols, 1), spacing)
    return ula_positions(n, spacing)


def steering_vectors(elem_pos_wavelengths, az_deg, el_deg) -> torch.Tensor:
    """MATLAB ``steervec(pos, [az; el])`` equivalent.

    Args:
      elem_pos_wavelengths: (3, n) element positions in wavelengths.
      az_deg, el_deg: (..., m) angles in degrees.

    Returns:
      (..., n, m) complex64 steering matrix exp(j·2π·posᵀ·u).
    """
    az = torch.deg2rad(_f32(az_deg))
    el = torch.deg2rad(_f32(el_deg))
    u = torch.stack([torch.cos(el) * torch.cos(az),
                     torch.cos(el) * torch.sin(az), torch.sin(el)], dim=-2)
    pos = _f32(elem_pos_wavelengths, u.device)
    with full_f32_matmul():
        phase = 2.0 * math.pi * torch.einsum("dn,...dm->...nm", pos, u)
    return torch.complex(torch.cos(phase), torch.sin(phase))


class Scenario(NamedTuple):
    """Fixed-per-experiment geometry (drawn once under the experiment
    seed, like prm.mobileRanges/mobileAngles at
    generate_maMIMO_LTF.m:48-51)."""

    mobile_range: torch.Tensor   # () metres
    mobile_az: torch.Tensor      # () degrees
    mobile_el: torch.Tensor      # () degrees
    rx_pos: torch.Tensor         # (3,)
    sp_loss_db: torch.Tensor     # () free-space path loss BS→user
    tx_elem: torch.Tensor        # (3, num_tx) metres
    rx_elem: torch.Tensor        # (3, num_rx) metres (local)


class ChannelRealization(NamedTuple):
    """Per-packet channel draw (one phased.ScatteringMIMOChannel state)."""

    cr: torch.Tensor          # (num_tx, num_rx, ns) complex path responses
    tau: torch.Tensor         # (ns,) path delays [s], scatterer order
    chan_delay: torch.Tensor  # () int32 samples


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    """U[lo, hi) float32 from ``gen``, formed as jax.random.uniform does."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def scenario_from_draws(cfg: SimConfig, rng, az, el,
                        device=None) -> Scenario:
    """The scenario for given draws: user range ``rng`` (an integer in
    [1, max_range], as float32), azimuth ``az`` in [−180, 180) and
    elevation ``el`` in [−90, 90) degrees."""
    rng, az, el = (_f32(v, device) for v in (rng, az, el))
    azr, elr = torch.deg2rad(az), torch.deg2rad(el)
    rx_pos = rng * torch.stack([torch.cos(elr) * torch.cos(azr),
                                torch.cos(elr) * torch.sin(azr),
                                torch.sin(elr)])
    sp_loss = fspl_db(rng, cfg.lam)
    tx_elem = _f32(array_positions(cfg.num_tx, cfg.tx_geometry,
                                   0.5 * cfg.lam, cfg.num_sts), device)
    rx_elem = _f32(array_positions(cfg.num_rx, cfg.rx_geometry,
                                   0.5 * cfg.lam, cfg.num_sts), device)
    return Scenario(rng, az, el, rx_pos, sp_loss, tx_elem, rx_elem)


def make_scenario(cfg: SimConfig, gen: torch.Generator) -> Scenario:
    """Draw the user placement from ``gen``; compute geometry and path
    loss. The scenario's tensors lie on the generator's device."""
    rng = torch.randint(1, int(cfg.max_range) + 1, (), generator=gen,
                        device=gen.device)
    az = _uniform(gen, (), -180.0, 180.0)
    el = _uniform(gen, (), -90.0, 90.0)
    return scenario_from_draws(cfg, rng, az, el, gen.device)


def _norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Euclidean norm over ``dim`` (of size 3), in float32 as XLA's
    compiled norm computes it: sqrt(fma(x2, x2, fma(x1, x1, x0·x0))),
    the square root correctly rounded (through float64: torch's float32
    sqrt on the CPU is not always)."""
    x0, x1, x2 = x.unbind(dim)
    return torch.sqrt(fma32(x2, x2, fma32(x1, x1, x0 * x0)).double()).float()


def scattering_from_draws(cfg: SimConfig, scen: Scenario, u,
                          g) -> ChannelRealization:
    """The path responses for given draws: ``u`` (..., 3, ns) uniform in
    [−1, 1) places the scatterers in the box around the Rx, ``g`` (..., 2,
    ns) standard normal makes the CN(0, 1) gains. Leading dims (...) are
    packets; the realization's tensors carry them (cr (..., Nt, Nr, ns),
    tau (..., ns), chan_delay (...))."""
    dev = scen.rx_pos.device
    u, g = _f32(u, dev), _f32(g, dev)
    rad = scen.mobile_range * cfg.scat_radius_frac
    scat = fma32(u, rad, scen.rx_pos[:, None])                  # (..., 3, ns)
    g = g / math.sqrt(2.0)
    gains = torch.complex(g[..., 0, :], g[..., 1, :])           # CN(0,1)

    # distances Tx element -> scatterer, scatterer -> Rx element
    d_tx = _norm(scat[..., :, None, :] - scen.tx_elem[:, :, None],
                 -3)                                            # (..., Nt, ns)
    rx_glob = scen.rx_pos[:, None] + scen.rx_elem               # (3, Nr)
    d_rx = _norm(scat[..., :, None, :] - rx_glob[:, :, None],
                 -3)                                            # (..., Nr, ns)
    d = d_tx[..., :, None, :] + d_rx[..., None, :, :]           # (..., Nt, Nr, ns)
    amp = cfg.lam / (4.0 * math.pi * d)
    # carrier phase with argument reduction (utils/numerics.py); XLA's
    # compiled code (and PyTorch's CUDA division by a scalar) divides by
    # the constant λ as a product with its float32 reciprocal
    phase = unit_phasor(-d * np.float32(1.0 / cfg.lam))
    cr = gains[..., None, None, :] * amp * phase

    # reference-position path delays (tau output of helperApplyMUChannel)
    d_ref = _norm(scat, -2) + _norm(scat - scen.rx_pos[:, None], -2)
    tau = d_ref / cfg.c_light                                   # (..., ns)
    chan_delay = torch.floor(torch.amin(tau, dim=-1)
                             * cfg.chan_srate).to(torch.int32)
    return ChannelRealization(cr, tau, chan_delay)


def realize_scattering(cfg: SimConfig, gen: torch.Generator,
                       scen: Scenario) -> ChannelRealization:
    """Draw one packet's scatterers and gains from ``gen`` and form the
    path responses (on the scenario's device)."""
    ns = cfg.n_scatterers
    u = _uniform(gen, (3, ns), -1.0, 1.0)
    g = torch.randn((2, ns), generator=gen, device=gen.device)
    return scattering_from_draws(cfg, scen, u, g)


def realize_channel(cfg: SimConfig, gen: torch.Generator,
                    scen: Scenario) -> ChannelRealization:
    """Draw one packet's channel under ``cfg.channel_model``: 'scattering'
    and 'fir' share the one-ring realization (only the application
    differs, ``apply_channel_model``); the CDL models ('cdl_nlos',
    'cdl_los') draw ``channel/cdl.py::realize_cdl``."""
    if cfg.channel_model not in ("scattering", "fir"):
        from mamimo_tpu_torch.channel.cdl import realize_cdl

        return realize_cdl(cfg, gen, scen)
    return realize_scattering(cfg, gen, scen)


def _signed_bins(n: int) -> np.ndarray:
    k = np.arange(n)
    return ((k + n // 2) % n) - n // 2


def apply_channel(cfg: SimConfig, sig, chan: ChannelRealization,
                  fft_size: int = 16384) -> torch.Tensor:
    """Pass a padded Tx signal through the scattering channel.

    Exact frequency-domain application: each path contributes
    ``cr · exp(−j·2π·k_signed·D_s / nfft)`` with D_s = τ_s·Fs the
    (fractional) path delay in samples. Products run in full float32.

    Args:
      sig: (..., nsamp, num_tx) complex, zero-padded at the tail by at
        least the largest path delay (``pipeline/sounding.py::pad_signal``),
        on the realization's device; one signal for every packet of a
        realization with leading packet dims, or one per packet.
      fft_size: FFT length >= nsamp (+ delay headroom).

    Returns:
      (..., nsamp, num_rx) complex64 faded signal, with the realization's
      leading dims. The frequency response is materialized: (..., F,
      num_tx, num_rx) complex64, 16 MB a packet at BS32 (F = 16384).
    """
    sig = torch.as_tensor(sig).to(torch.complex64)
    nsamp = sig.shape[-2]
    if fft_size < nsamp:
        raise ValueError(f"fft_size {fft_size} must cover the {nsamp}-sample "
                         f"padded signal")
    delays = chan.tau * cfg.chan_srate                         # (..., ns)
    k = torch.as_tensor(_signed_bins(fft_size), dtype=torch.float32,
                        device=delays.device)                  # (F,)
    ramp = unit_phasor(-k[:, None] * delays[..., None, :]
                       / fft_size)                             # (..., F, ns)
    with full_f32_matmul():
        hf = torch.einsum("...mns,...fs->...fmn", chan.cr, ramp)
        xf = torch.fft.fft(sig, n=fft_size, dim=-2)            # (..., F, Nt)
        yf = torch.einsum("...fm,...fmn->...fn", xf, hf)
    return torch.fft.ifft(yf, dim=-2)[..., :nsamp, :]


def apply_channel_model(cfg: SimConfig, sig, chan: ChannelRealization,
                        fft_size: int = 16384) -> torch.Tensor:
    """Channel application dispatched on ``cfg.channel_model``: 'fir' —
    banded tapped-FIR filtering with sinc fractional-delay taps
    (``parallel/halo.py``), the counterpart of the reference's
    ``comm.MIMOChannel`` path (helperApplyMUChannel.m:145-185); anything
    else — the exact phase-ramp form ``apply_channel``."""
    if cfg.channel_model == "fir":
        from mamimo_tpu_torch.parallel.halo import (
            apply_channel_taps,
            channel_taps,
        )

        taps = channel_taps(cfg, chan, n_taps=cfg.fir_taps)
        return apply_channel_taps(torch.as_tensor(sig), taps)
    return apply_channel(cfg, sig, chan, fft_size=fft_size)


def analytic_subcarrier_channel(cfg: SimConfig, chan: ChannelRealization,
                                sync_delay=None) -> torch.Tensor:
    """Exact per-subcarrier channel seen by the OFDM demodulator after
    synchronizing at ``sync_delay`` samples (default chan.chan_delay):

        H(k, m, n) = Σ_s cr(m,n,s) · exp(−j·2π·b_k·(τ_s·Fs − sync)/fft)

    Returns (num_carriers, num_tx, num_rx) complex64 — the noise-free
    oracle the LS estimator must recover (up to the known preamble
    amplitude scale).
    """
    if sync_delay is None:
        sync_delay = chan.chan_delay
    dev = chan.tau.device
    bins = torch.as_tensor(
        np.asarray(cfg.carrier_locations, np.float32) - cfg.fft_length // 2,
        device=dev)
    d = chan.tau * cfg.chan_srate - _f32(sync_delay, dev)
    ramp = unit_phasor(-bins[:, None] * d[None, :] / cfg.fft_length)  # (C, ns)
    with full_f32_matmul():
        return torch.einsum("mns,cs->cmn", chan.cr, ramp)
