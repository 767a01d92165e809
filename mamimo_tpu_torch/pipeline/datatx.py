"""The closed-loop data-transmission leg (the port's copy of
``mamimo_tpu/pipeline/datatx.py``): hybrid precoding → coded QPSK/OFDM
data frame → channel → receiver → equalize → decode → BER/EVM/BF gain.

The ``~isOnlyCSI`` branch of ``generate_maMIMO_LTF.m:403-640`` and the
per-estimator loop of ``BER_test_maMIMO_LTF.m:347-647``: given a CSI
estimate from any source (LS / LMMSE / DNN / perfect), compute OMP
hybrid weights, transmit a coded frame through the packet's channel
(preamble-primed, helperApplyMUChannel.m:26-35) and recover the bits.

The random numbers are apart from the math, as in
``pipeline/sounding.py``: ``draw_data_tx`` draws each packet's steering
rays, bits and receiver noise from that packet's own generator, and
``data_tx_from_draws`` computes a batch from them on leading dims that
broadcast (the closed loop runs packets × sources, the sources of a
packet sharing its channel and draws). The tests feed JAX's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from mamimo_tpu_torch.channel.noise import draw_normal, sync_slice
from mamimo_tpu_torch.channel.scattering import (
    ChannelRealization,
    Scenario,
    _uniform,
    apply_channel_model,
    array_positions,
    steering_vectors,
)
from mamimo_tpu_torch.config import SimConfig, default_fft_size
from mamimo_tpu_torch.ops.coding import (
    conv_encode,
    gen_pilots,
    mimo_equalize,
    qam_constellation,
    qam_demod_approx_llr,
    qam_mod,
    qpsk_constellation,
    qpsk_demod_llr,
    qpsk_mod,
    viterbi_decode,
)
from mamimo_tpu_torch.ops.estimate import ls_estimate
from mamimo_tpu_torch.ops.jsdm import jsdm_transmit_weights, pack_block_diagonal
from mamimo_tpu_torch.ops.ltf import gen_preamble
from mamimo_tpu_torch.ops.metrics import bit_error_rate, evm_rms
from mamimo_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
from mamimo_tpu_torch.ops.omp import omp_hyb_weights
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


class DataTxResult(NamedTuple):
    """One transmission per batch element (...)."""

    ber: torch.Tensor       # (...)
    evm: torch.Tensor       # (...) RMS EVM %
    snr_dt: torch.Tensor    # (..., num_rx) data-transmission SNR [dB]
    bf_gain: torch.Tensor   # (...) mean(snr_DT) − mean(snr_CS) [dB]
    decoded: torch.Tensor   # (..., num_frm_bits) int32 decoded bits


class DataTxDraws(NamedTuple):
    """The standard draws of a batch of data legs, leading dims (...).

    az, el: the steering rays (..., n_rays), uniform degrees in
    [−180, 180) and [−90, 90) (None on the multi-user leg, which has no
    dictionary); bits: (..., [U,] num_frm_bits) int32 fair coin flips;
    noise: (..., [U,] nsamp, num_rx, 2) standard normals of the receiver,
    nsamp = ``data_leg_samples``. The multi-user leg has a user axis U."""

    az: Optional[torch.Tensor]
    el: Optional[torch.Tensor]
    bits: torch.Tensor
    noise: torch.Tensor


def data_leg_samples(cfg: SimConfig, n_pre_sym: int) -> int:
    """Received samples of the data leg after the sounding preamble: the
    precoded preamble's n_pre_sym symbols, the data symbols and the
    delay padding."""
    return (n_pre_sym + cfg.num_data_symbols) * cfg.sym_len \
        + cfg.num_pad_zeros


def _bits(gen: torch.Generator, n: int) -> torch.Tensor:
    return (torch.rand((n,), generator=gen, device=gen.device)
            < 0.5).to(torch.int32)


def draw_data_tx(cfg: SimConfig,
                 gens: Sequence[torch.Generator]) -> DataTxDraws:
    """The single-user draws of len(gens) packets, packet i from gens[i]
    alone, in order: the rays' azimuths, their elevations, the bits, the
    receiver noise. Stacked on a leading packet axis, on the generators'
    device."""
    shape = (data_leg_samples(cfg, cfg.num_sts), cfg.num_rx)
    per = [(_uniform(g, (cfg.n_rays,), -180.0, 180.0),
            _uniform(g, (cfg.n_rays,), -90.0, 90.0),
            _bits(g, cfg.num_frm_bits), draw_normal(g, shape))
           for g in gens]
    return DataTxDraws(*(torch.stack(parts) for parts in zip(*per)))


def draw_data_tx_mu(cfg: SimConfig,
                    gens: Sequence[torch.Generator]) -> DataTxDraws:
    """The multi-user draws of len(gens) packets, packet i from gens[i]:
    every user's bits (user 0 first), then every user's receiver noise.
    bits (P, U, num_frm_bits), noise (P, U, nsamp, num_rx, 2)."""
    u_cnt = cfg.num_users
    shape = (data_leg_samples(cfg, u_cnt * cfg.num_sts), cfg.num_rx)
    bits, noise = [], []
    for g in gens:
        bits.append(torch.stack([_bits(g, cfg.num_frm_bits)
                                 for _ in range(u_cnt)]))
        noise.append(torch.stack([draw_normal(g, shape)
                                  for _ in range(u_cnt)]))
    return DataTxDraws(None, None, torch.stack(bits), torch.stack(noise))


def steering_dictionary(cfg: SimConfig, az, el) -> torch.Tensor:
    """Random-ray steering dictionary At (generate_maMIMO_LTF.m:413-418):
    rays at azimuths ``az`` and elevations ``el`` (..., n_rays) degrees
    over the BS array's geometry (steervec(prm.posTxElem, txang)) →
    (..., num_tx, n_rays)."""
    pos_wl = array_positions(cfg.num_tx, cfg.tx_geometry, 0.5, cfg.num_sts)
    return steering_vectors(pos_wl, az, el)


def _map_symbols(cfg: SimConfig, bits: torch.Tensor, ns: int) -> torch.Tensor:
    """Coded, modulated and layer-mapped frames: bits (..., K) → (..., C,
    nsym, ns), layer mapping column-major (carrier fastest, stream
    slowest: reshape(mappedSym, numCarriers, numDataSymbols, numSTS),
    generate_maMIMO_LTF.m:479-480)."""
    coded = conv_encode(bits, terminated=True)
    if cfg.bits_per_subcarrier == 2:
        syms = qpsk_mod(coded)
    else:
        syms = qam_mod(coded, cfg.mod_order)
    grid = syms.reshape(syms.shape[:-1] + (ns, cfg.num_data_symbols,
                                           cfg.num_carriers))
    return grid.permute(*range(grid.dim() - 3), -1, -2, -3)


def _transmit(cfg: SimConfig, grid: torch.Tensor, v: torch.Tensor,
              m_frf: torch.Tensor) -> torch.Tensor:
    """Precode the data grid (..., C, nsym, n) per carrier with the
    Frobenius-normalized ``v`` (..., C, n, n) (generate_maMIMO_LTF.m:
    485-492), OFDM-modulate it with its pilots behind the precoded
    preamble (:505), map through the analog rows m_frf (..., n, Nt), and
    prime the channel: the sounding preamble and the delay padding
    before, padding after (helperApplyMUChannel.m:26-35). Returns (...,
    len_ltf + 2·pad + frame, Nt)."""
    n = v.shape[-1]
    fro = torch.linalg.vector_norm(v, dim=(-2, -1), keepdim=True)
    norm_v = v * math.sqrt(cfg.num_tx) / torch.clamp(fro, min=1e-30)
    with full_f32_matmul():
        pre_data = torch.einsum("...cnj,...cjo->...cno", grid, norm_v)
    pilots = gen_pilots(cfg.num_data_symbols, n, device=v.device)
    tx_ofdm = ofdm_modulate(cfg, pre_data, pilots) * (
        cfg.fft_length / math.sqrt(cfg.used_sc))
    tx_sts = torch.cat([gen_preamble(cfg, n, v=v), tx_ofdm], dim=-2)
    with full_f32_matmul():
        tx_sig = tx_sts @ m_frf                               # (..., L, Nt)
    lead = tx_sig.shape[:-2]
    pre = torch.as_tensor(gen_preamble(cfg, cfg.num_tx), device=v.device)
    pad = tx_sig.new_zeros(lead + (cfg.num_pad_zeros, cfg.num_tx))
    return torch.cat([pre.expand(lead + pre.shape), pad, tx_sig, pad], -2)


def _faded(cfg: SimConfig, sig_pad: torch.Tensor, chan: ChannelRealization,
           fft_size: int) -> torch.Tensor:
    """The channel's output after the sounding preamble and its padding."""
    faded = apply_channel_model(cfg, sig_pad, chan, fft_size=fft_size)
    return faded[..., cfg.len_ltf + cfg.num_pad_zeros:, :]


def _receive_and_decode(cfg: SimConfig, z, faded, *, gain_db, noise_db,
                        chan_delay, n_pre_sym: int, own, bits,
                        snr_cs) -> DataTxResult:
    """Receiver chain shared by the single- and multi-user legs
    (generate_maMIMO_LTF.m:538-640): AWGN at the sounding noise power,
    subcarrier scaling, sync, demod, preamble LS, ZF-equalize the own
    streams, CSI-weighted approximate-LLR demod, Viterbi, metrics.

    Args:
      z: (..., nsamp, num_rx, 2) standard-normal receiver draws.
      faded: (..., nsamp, num_rx) the channel's output; its leading dims
        are the batch, which every other argument broadcasts against.
      gain_db, noise_db: (...) preamp gain and the sounding noise power.
      n_pre_sym: mapped-preamble symbols (numSTS over all users).
      own: (..., n_own) indices of the receiver's own streams (a user's
        block on the multi-user leg).
    """
    lead = faded.shape[:-2]
    dev = faded.device
    nrx = faded.shape[-1]
    gain_db = torch.as_tensor(gain_db, dtype=torch.float32, device=dev)
    noise_db = torch.as_tensor(noise_db, dtype=torch.float32, device=dev)
    sig_pwr = (faded.abs() ** 2).mean(-2)                     # (..., Nr)
    snr_dt = 10.0 * torch.log10(sig_pwr) - noise_db[..., None] \
        + gain_db[..., None]
    n_var_time = torch.pow(10.0, noise_db / 10.0)
    noise = torch.complex(z[..., 0], z[..., 1]) * torch.sqrt(
        n_var_time / 2.0)[..., None, None]
    y = torch.pow(10.0, gain_db / 20.0)[..., None, None] * faded + noise
    y = y * (math.sqrt(cfg.used_sc) / cfg.fft_length)
    # subcarrier-domain noise variance for the LLRs (:567-569)
    n_var = n_var_time * (cfg.used_sc / cfg.fft_length ** 2) / cfg.num_tx

    y_sync = sync_slice(cfg, y, torch.as_tensor(chan_delay,
                                                device=dev).expand(lead))
    rx_grid, _ = ofdm_demodulate(cfg, y_sync,
                                 nsym=n_pre_sym + cfg.num_data_symbols)
    # channel estimate from the mapped preamble (:578)
    h_eff = ls_estimate(cfg, rx_grid[..., :n_pre_sym, :], n_pre_sym)
    own = torch.as_tensor(own, device=dev)
    n_own = own.shape[-1]
    idx = own[..., None, :, None].expand(lead + (cfg.num_carriers, n_own,
                                                 nrx))
    h_own = torch.gather(h_eff, -2, idx)
    rx_eq, csi_w = mimo_equalize(rx_grid[..., n_pre_sym:, :], h_own)

    # carrier-fastest, stream-slowest (MATLAB rxEq(:), :590); the extra
    # sqrt(n_pre_sym) undoes the mapped preamble's per-symbol power
    # normalization, identity for numSTS = 1 (see the JAX package)
    rx_syms = rx_eq.permute(*range(rx_eq.dim() - 3), -1, -2, -3).reshape(
        lead + (-1,)) / math.sqrt(cfg.num_tx * n_pre_sym)
    if cfg.bits_per_subcarrier == 2:
        llr = qpsk_demod_llr(rx_syms, n_var)
        ref_const = qpsk_constellation(device=dev)
    else:
        llr = qam_demod_approx_llr(rx_syms, cfg.mod_order, n_var)
        ref_const = qam_constellation(cfg.mod_order, device=dev)
    # CSI scaling per (subcarrier, stream) (:594-598), broadcast over the
    # data symbols
    csi_k = csi_w.transpose(-1, -2)[..., :, None, :].expand(
        lead + (n_own, cfg.num_data_symbols, cfg.num_carriers)).reshape(
            lead + (-1,))
    llr = (llr.reshape(lead + (-1, cfg.bits_per_subcarrier))
           * csi_k[..., None]).reshape(lead + (-1,))

    decoded = viterbi_decode(llr, cfg.num_frm_bits, terminated=True)
    snr_cs = torch.as_tensor(snr_cs, device=dev)
    return DataTxResult(
        ber=bit_error_rate(torch.as_tensor(bits, device=dev).expand(
            decoded.shape), decoded),
        evm=evm_rms(rx_syms, ref_const),
        snr_dt=snr_dt,
        bf_gain=snr_dt.mean(-1) - snr_cs.mean(-1),
        decoded=decoded)


def data_tx_from_draws(cfg: SimConfig, scen: Scenario,
                       chan: ChannelRealization, csi, noise_db, snr_cs,
                       draws: DataTxDraws, fft_size: int | None = None,
                       gain_db=None) -> DataTxResult:
    """A batch of single-user closed-loop data transmissions.

    The batch is csi's leading dims (...); the channel, the draws, the
    noise powers and the sounding SNRs broadcast against them (a packet's
    sources share its channel and draws).

    Args:
      scen: the experiment's scenario.
      chan: the packets' channel realizations (those of the sounding).
      csi: (..., C, num_tx, num_rx) channel estimates used for precoding.
      noise_db: (...) noise power of the sounding (the evaluator reuses
        it, BER_test_maMIMO_LTF.m:254-257,502).
      snr_cs: (..., num_rx) sounding SNR for the beamforming gain.
      draws: ``draw_data_tx``'s.
      fft_size: the channel's FFT length (default
        ``default_fft_size(cfg, data_leg=True)``).
      gain_db: the receiver preamp gain; None means the snr-mode
        convention, spLoss. SINR-mode datasets pass 0.0: the reference's
        SINR data leg runs the preamp at gain 0
        (generate_maMIMO_LTF_SINR.m:466,488-491).
    """
    if fft_size is None:
        fft_size = default_fft_size(cfg, data_leg=True)
    ns = cfg.num_sts
    csi = torch.as_tensor(csi).to(torch.complex64)
    dev = csi.device
    at = steering_dictionary(cfg, draws.az.to(dev), draws.el.to(dev))
    fbb, frf = omp_hyb_weights(csi, ns, ns, at)  # (.., C, ns, ns), (.., C, ns, Nt)
    m_frf = frf.mean(-3)                                     # (..., ns, Nt)
    bits = draws.bits.to(dev)
    sig_pad = _transmit(cfg, _map_symbols(cfg, bits, ns), fbb, m_frf)
    faded = _faded(cfg, sig_pad, chan, fft_size)
    return _receive_and_decode(
        cfg, draws.noise.to(dev), faded,
        gain_db=scen.sp_loss_db if gain_db is None else gain_db,
        noise_db=noise_db, chan_delay=chan.chan_delay, n_pre_sym=ns,
        own=torch.arange(ns, device=dev), bits=bits, snr_cs=snr_cs)


def run_data_transmission(cfg: SimConfig, gen: torch.Generator,
                          scen: Scenario, chan: ChannelRealization, csi,
                          noise_db, snr_cs, fft_size: int | None = None,
                          gain_db=None) -> DataTxResult:
    """One packet's closed-loop data transmission with a given CSI source
    (csi (C, num_tx, num_rx)): its draws from ``gen``, then
    ``data_tx_from_draws``. Options as there; runs on csi's device."""
    draws = draw_data_tx(cfg, [gen])
    res = data_tx_from_draws(cfg, scen, chan, torch.as_tensor(csi)[None],
                             noise_db, snr_cs, draws, fft_size, gain_db)
    return DataTxResult(*(t[0] for t in res))


def data_tx_mu_from_draws(cfg: SimConfig, scens: Scenario,
                          chans: ChannelRealization, csi_users,
                          noise_db_users, snr_cs_users, draws: DataTxDraws,
                          fft_size: int | None = None) -> DataTxResult:
    """A batch of multi-user closed loops: JSDM precoding and per-user
    decoding (the numUsers > 1 branch, generate_maMIMO_LTF.m:427-440,
    531-640).

    Args:
      scens: the users' stacked scenarios (leading axis U).
      chans: the users' channel realizations (..., U, ...).
      csi_users: (..., U, C, num_tx, num_rx) per-user CSI for precoding.
      noise_db_users: (..., U) sounding noise powers.
      snr_cs_users: (..., U, num_rx) sounding SNRs.
      draws: ``draw_data_tx_mu``'s.

    Returns a DataTxResult with the batch's dims and the user axis (...,
    U).
    """
    if fft_size is None:
        fft_size = default_fft_size(cfg, data_leg=True)
    u_cnt, ns = cfg.num_users, cfg.num_sts
    sts_tot = u_cnt * ns
    csi = torch.as_tensor(csi_users).to(torch.complex64)
    dev = csi.device
    fbb, m_frf = jsdm_transmit_weights(csi, ns)
    v = pack_block_diagonal(fbb, ns)                 # (..., C, tot, tot)
    bits = draws.bits.to(dev)                        # (..., U, K)
    grid = _map_symbols(cfg, bits, ns)               # (..., U, C, nsym, ns)
    grid = grid.movedim(-4, -2).reshape(grid.shape[:-4] + (
        cfg.num_carriers, cfg.num_data_symbols, sts_tot))
    sig_pad = _transmit(cfg, grid, v, m_frf)[..., None, :, :]
    faded = _faded(cfg, sig_pad, chans, fft_size)    # (..., U, L, Nr)
    own = torch.arange(sts_tot, device=dev).reshape(u_cnt, ns)
    return _receive_and_decode(
        cfg, draws.noise.to(dev), faded, gain_db=scens.sp_loss_db,
        noise_db=noise_db_users, chan_delay=chans.chan_delay,
        n_pre_sym=sts_tot, own=own, bits=bits, snr_cs=snr_cs_users)


def run_data_transmission_mu(cfg: SimConfig, gen: torch.Generator, scens,
                             chans, csi_users, noise_db_users, snr_cs_users,
                             fft_size: int | None = None) -> DataTxResult:
    """One packet's multi-user closed loop (csi_users (U, C, num_tx,
    num_rx)): its draws from ``gen``, then ``data_tx_mu_from_draws``.
    Returns the (U,) per-user result."""
    draws = draw_data_tx_mu(cfg, [gen])
    res = data_tx_mu_from_draws(
        cfg, scens, chans, torch.as_tensor(csi_users)[None],
        noise_db_users, snr_cs_users, draws, fft_size)
    return DataTxResult(*(t[0] for t in res))
