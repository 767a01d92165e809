"""Channel sounding: preamble → channel → receiver → demod → LS/LMMSE (the
port's copy of ``mamimo_tpu/pipeline/sounding.py``).

The per-packet loop of ``generate_maMIMO_LTF.m:197-386`` (the
isOnlyCSI=true path of dataset generation), plus the "perfect CSI"
−100 dB-noise pass of ``BER_test_maMIMO_LTF.m:262-288``, so that every
packet carries its own oracle label.

JAX vmaps one packet's function; the port computes a leading packet
axis. The random numbers are apart from the math: ``draw_sounding``
draws each packet's standard draws from that packet's own
``torch.Generator`` (the only Python loop over packets), and
``sound_from_draws`` computes a whole batch from them
(``channel_from_draws``, then ``sound_realization``, which can also take
a realization made elsewhere). The tests feed ``sound_from_draws`` with
the JAX package's own draws. ``sound_packet`` is the two on one packet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from mamimo_tpu_torch.channel.cdl import cdl_from_draws, num_phases
from mamimo_tpu_torch.channel.noise import (
    draw_normal,
    interference_chain,
    receiver_chain,
    receiver_chain_nf,
)
from mamimo_tpu_torch.channel.scattering import (
    ChannelRealization,
    Scenario,
    _uniform,
    apply_channel_model,
    scattering_from_draws,
)
from mamimo_tpu_torch.config import SimConfig, default_fft_size
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.estimate import (
    lmmse_estimate,
    lmmse_estimate_cg,
    lmmse_estimate_direct,
    lmmse_estimate_eig,
    ls_estimate,
)
from mamimo_tpu_torch.ops.ltf import gen_preamble
from mamimo_tpu_torch.ops.ofdm import ofdm_demodulate

NOISE_MODES = ("snr", "sinr", "nf")


class SoundingResult(NamedTuple):
    """One sounding, with the packets' leading dims (...) or none."""

    rx: torch.Tensor          # (..., len_ltf, num_rx) received preamble
    h_ls: torch.Tensor        # (..., C, num_tx, num_rx) LS estimate
    h_perfect: torch.Tensor   # (..., C, num_tx, num_rx) −100 dB-noise LS
    h_mmse: torch.Tensor      # (..., C, num_tx, num_rx) LMMSE (zeros if off)
    snr_cs: torch.Tensor      # (..., num_rx) realized sounding SNR [dB]
    noise_db: torch.Tensor    # (...) applied noise power [dB]
    tau: torch.Tensor         # (..., ns) path delays
    chan_delay: torch.Tensor  # (...) int32


class SoundingDraws(NamedTuple):
    """The standard draws of a batch of packets, leading axis B.

    u, g: the scattering realization's (B, 3, ns) uniform [−1, 1) and
    (B, 2, ns) standard normal draws ('scattering' and 'fir'); phi: the
    CDL ray phases (B, clusters·20), uniform [0, 2π); noise, intf, perf:
    standard normals (B, nsamp, num_rx, 2) of the noisy receiver, of the
    'sinr' mode's interference, and of the oracle leg, nsamp the padded
    preamble length. The draws a configuration does not use are None."""

    u: Optional[torch.Tensor]
    g: Optional[torch.Tensor]
    phi: Optional[torch.Tensor]
    noise: torch.Tensor
    intf: Optional[torch.Tensor]
    perf: torch.Tensor


def _check_noise_mode(noise_mode: str) -> None:
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")


def _is_cdl(cfg: SimConfig) -> bool:
    return cfg.channel_model not in ("scattering", "fir")


def _draw_channel(cfg: SimConfig, gen: torch.Generator):
    """One packet's channel draws (u, g, phi) from ``gen``, the first it
    gives: u then g for the one-ring models, phi for CDL."""
    if _is_cdl(cfg):
        return (None, None,
                _uniform(gen, (num_phases(cfg),), 0.0, 2.0 * math.pi))
    ns = cfg.n_scatterers
    u = _uniform(gen, (3, ns), -1.0, 1.0)
    return (u, torch.randn((2, ns), generator=gen, device=gen.device), None)


def _stack(per) -> SoundingDraws:
    return SoundingDraws(*(None if parts[0] is None else torch.stack(parts)
                           for parts in zip(*per)))


def draw_sounding(cfg: SimConfig, gens: Sequence[torch.Generator],
                  noise_mode: str = "snr") -> SoundingDraws:
    """The draws of len(gens) packets, packet i from gens[i] alone (so a
    packet's draws do not depend on the batch it is drawn in), on the
    generators' device. Each generator gives, in order: the channel
    draws (u then g, or phi; ``channel/scattering.py::realize_scattering``
    and ``channel/cdl.py::realize_cdl`` draw the same), the noise, the
    interference ('sinr' only), then the oracle leg's noise."""
    _check_noise_mode(noise_mode)
    if not gens:
        raise ValueError("draw_sounding needs at least one generator")
    nsamp = cfg.len_ltf + cfg.num_pad_zeros
    shape = (nsamp, cfg.num_rx)
    per = []
    for gen in gens:
        chan = _draw_channel(cfg, gen)
        noise = draw_normal(gen, shape)
        intf = draw_normal(gen, shape) if noise_mode == "sinr" else None
        per.append(chan + (noise, intf, draw_normal(gen, shape)))
    return _stack(per)


def draw_channel(cfg: SimConfig,
                 gens: Sequence[torch.Generator]) -> SoundingDraws:
    """The channel draws alone of len(gens) packets (those
    ``draw_sounding`` begins with; the receivers' draws are None): enough
    for ``channel_from_draws`` to regenerate the packets' channels."""
    if not gens:
        raise ValueError("draw_channel needs at least one generator")
    return _stack([_draw_channel(cfg, g) + (None, None, None) for g in gens])


def pad_signal(cfg: SimConfig, sig) -> torch.Tensor:
    """Append the channel-delay zero padding (helperApplyMUChannel.m:34):
    sig (nsamp, num_tx), a tensor or a numpy array, → (nsamp +
    num_pad_zeros, num_tx) on sig's device."""
    sig = torch.as_tensor(sig)
    pad = torch.zeros((cfg.num_pad_zeros, sig.shape[1]), dtype=sig.dtype,
                      device=sig.device)
    return torch.cat([sig, pad], dim=0)


def estimate_from_rx(cfg: SimConfig, rx, tau=None, snr_db=None,
                     with_mmse: bool = False, mmse_estimator: str = "cg",
                     mmse_n_iter: int = 16):
    """OFDM demod + LS (+ LMMSE) from synced received preambles rx (...,
    len_ltf, num_rx): the analytic half of the DNN's job (``ofdmdemod`` and
    the LS despread, generate_maMIMO_LTF.m:336-342).

    Args:
      tau, snr_db: (..., ns) delays and (..., num_rx) realized SNRs [dB],
        for the LMMSE.
      mmse_estimator: the LMMSE form when with_mmse: 'cg' (the
        circulant-preconditioned CG, the production form), 'direct' (the
        exact solve on the right-hand sides), 'dense' (the LMMSE_ce.m
        smoothing matrix) or 'eig' (the eigenbasis form).
      mmse_n_iter: the CG's trip count ('cg' only).

    Returns:
      (h_ls, h_mmse), each (..., C, num_tx, num_rx); h_mmse is zeros
      without with_mmse.
    """
    grid, _ = ofdm_demodulate(cfg, rx, nsym=cfg.num_tx)
    h_ls = ls_estimate(cfg, grid, cfg.num_tx)
    if not with_mmse:
        return h_ls, torch.zeros_like(h_ls)
    if mmse_estimator == "cg":
        return h_ls, lmmse_estimate_cg(cfg, h_ls, tau, snr_db,
                                       n_iter=mmse_n_iter)
    forms = {"direct": lmmse_estimate_direct, "dense": lmmse_estimate,
             "eig": lmmse_estimate_eig}
    if mmse_estimator not in forms:
        raise ValueError(f"unknown mmse_estimator {mmse_estimator!r}")
    return h_ls, forms[mmse_estimator](cfg, h_ls, tau, snr_db)


def channel_from_draws(cfg: SimConfig, scen: Scenario,
                       draws: SoundingDraws) -> ChannelRealization:
    """The batch's channel realization from its draws, under
    ``cfg.channel_model``, on the scenario's device."""
    if _is_cdl(cfg):
        return cdl_from_draws(cfg, scen, draws.phi)
    return scattering_from_draws(cfg, scen, draws.u, draws.g)


def sound_realization(cfg: SimConfig, scen: Scenario,
                      chan: ChannelRealization, draws: SoundingDraws,
                      snr_db, preamble=None, with_mmse: bool = False,
                      noise_mode: str = "snr", fft_size: int | None = None,
                      interference_dbm: float = -55.0,
                      noise_floor_dbm: float = -85.0,
                      mmse_estimator: str = "cg",
                      mmse_n_iter: int = 16) -> SoundingResult:
    """Sound a batch of packets through their channel realization
    ``chan`` (leading packet axis B), with the receivers' draws of
    ``draws`` (``noise``, ``intf``, ``perf``), on the scenario's device.

    Args:
      snr_db: target sounding SNR (ignored in 'sinr' mode).
      preamble: the sounding preamble (len_ltf, num_tx), static across
        packets (default ``gen_preamble``).
      noise_mode: 'snr' (generate_maMIMO_LTF.m), 'nf' (the noise-figure
        receiver) or 'sinr' (generate_maMIMO_LTF_SINR.m's fixed noise and
        interference, at interference_dbm / noise_floor_dbm).
      fft_size: the channel application's FFT length (default
        ``default_fft_size(cfg)``).
      mmse_estimator, mmse_n_iter: as ``estimate_from_rx``.
    """
    _check_noise_mode(noise_mode)
    dev = scen.rx_pos.device
    if fft_size is None:
        fft_size = default_fft_size(cfg)
    if preamble is None:
        preamble = gen_preamble(cfg, cfg.num_tx)
    sig = pad_signal(cfg, torch.as_tensor(preamble, device=dev)
                     .to(torch.complex64))
    faded = apply_channel_model(cfg, sig, chan, fft_size=fft_size)

    gain_db = scen.sp_loss_db
    if noise_mode == "snr":
        rx, snr_cs, noise_db = receiver_chain(
            cfg, draws.noise, faded, snr_db, gain_db, chan.chan_delay)
    elif noise_mode == "sinr":
        rx, snr_cs, noise_db = interference_chain(
            cfg, draws.noise, draws.intf, faded, chan.chan_delay,
            noise_power_dbm=noise_floor_dbm,
            interference_power_dbm=interference_dbm)
    else:
        rx, snr_cs, noise_db = receiver_chain_nf(
            cfg, draws.noise, faded, gain_db, chan.chan_delay)
    h_ls, h_mmse = estimate_from_rx(
        cfg, rx, chan.tau, snr_cs, with_mmse=with_mmse,
        mmse_estimator=mmse_estimator, mmse_n_iter=mmse_n_iter)

    # the oracle: the same chain with negligible noise, at the noisy
    # leg's gain convention (the sinr chain has no preamp: gain 0, noise
    # pinned 100 dB below the received signal)
    if noise_mode == "sinr":
        rx_p, _, _ = receiver_chain(cfg, draws.perf, faded, 100.0, 0.0,
                                    chan.chan_delay)
    else:
        rx_p, _, _ = receiver_chain(cfg, draws.perf, faded, snr_db, gain_db,
                                    chan.chan_delay, noise_power_db=-100.0)
    h_perfect, _ = estimate_from_rx(cfg, rx_p)
    return SoundingResult(rx=rx, h_ls=h_ls, h_perfect=h_perfect,
                          h_mmse=h_mmse, snr_cs=snr_cs, noise_db=noise_db,
                          tau=chan.tau, chan_delay=chan.chan_delay)


def sound_from_draws(cfg: SimConfig, scen: Scenario, draws: SoundingDraws,
                     snr_db, **kw) -> tuple[SoundingResult,
                                            ChannelRealization]:
    """Sound a batch of packets from their draws (``draw_sounding``):
    ``channel_from_draws`` then ``sound_realization`` (whose options
    ``kw`` takes). Returns the result and the realization, each tensor
    with the leading packet axis B."""
    chan = channel_from_draws(cfg, scen, draws)
    return sound_realization(cfg, scen, chan, draws, snr_db, **kw), chan


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def sound_packet(cfg: SimConfig, gen: torch.Generator, scen: Scenario,
                 snr_db, preamble=None, with_mmse: bool = False,
                 noise_mode: str = "snr", fft_size: int | None = None,
                 interference_dbm: float = -55.0,
                 noise_floor_dbm: float = -85.0, mmse_estimator: str = "cg",
                 mmse_n_iter: int = 16, device=None
                 ) -> tuple[SoundingResult, ChannelRealization]:
    """Simulate one sounding packet: its draws from ``gen`` (the
    per-packet seed contract of prm.seed_p, generate_maMIMO_LTF.m:33-41:
    the same generator state regenerates the same packet), then
    ``sound_from_draws`` on the one packet. Options as
    ``sound_realization``.

    Args:
      device: where it runs; None means the card (cuda), and raises
        without one. ``gen`` and ``scen`` must lie on it (ValueError).

    Returns the packet's result and realization, without a packet axis.
    """
    dev = resolve_device("cuda" if device is None else device)
    for what, d in (("gen", gen.device), ("scen", scen.rx_pos.device)):
        if not _same_device(d, dev):
            raise ValueError(f"{what} is on {d}, the packet runs on {dev}")
    draws = draw_sounding(cfg, [gen], noise_mode)
    res, chan = sound_from_draws(
        cfg, scen, draws, snr_db, preamble=preamble, with_mmse=with_mmse,
        noise_mode=noise_mode, fft_size=fft_size,
        interference_dbm=interference_dbm, noise_floor_dbm=noise_floor_dbm,
        mmse_estimator=mmse_estimator, mmse_n_iter=mmse_n_iter)
    return (SoundingResult(*(t[0] for t in res)),
            ChannelRealization(*(t[0] for t in chan)))
