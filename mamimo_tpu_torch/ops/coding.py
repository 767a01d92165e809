"""Channel coding and modulation (the port's copy of
``mamimo_tpu/ops/coding.py``): the K=7 rate-1/3 convolutional code, the
soft Viterbi decoder, QPSK/QAM mapping with approximate LLRs, the
per-subcarrier MIMO equalizer and the data symbols' pilots.

Replaces the comm-toolbox objects of the data-transmission leg:
``comm.ConvolutionalEncoder(poly2trellis(7,[133 171 165]),'Terminated')``
(generate_maMIMO_LTF.m:462-464), ``comm.ViterbiDecoder`` unquantized
(:527-529), ``qammod/qamdemod`` approx-LLR (:474,591) and
``helperMIMOEqualize`` (:582).

Every function works on leading batch dims. The Viterbi decoder keeps
all 64 states of every codeword of the batch in one tensor and loops in
Python over the trellis steps, forward (add-compare-select) and back
(traceback): a few small operations a step whatever the batch.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from mamimo_tpu_torch.ops.estimate import _solve
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

CONSTRAINT = 7
POLYS = (0o133, 0o171, 0o165)   # generator polynomials, octal
NUM_STATES = 1 << (CONSTRAINT - 1)
RATE_DEN = len(POLYS)


@lru_cache(maxsize=None)
def _trellis() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(next_state[s,b], out_bits[s,b,3], prev_state[s',i], prev_bit[s',i])

    State = the 6 most recent input bits, newest in the MSB (MATLAB
    poly2trellis convention: register = [newest ... oldest], generator
    taps from the MSB of the octal polynomial).
    """
    ns = NUM_STATES
    next_state = np.zeros((ns, 2), np.int32)
    out_bits = np.zeros((ns, 2, RATE_DEN), np.int8)
    for s in range(ns):
        for b in range(2):
            reg = (b << (CONSTRAINT - 1)) | s     # 7-bit register
            for j, p in enumerate(POLYS):
                out_bits[s, b, j] = bin(reg & p).count("1") & 1
            next_state[s, b] = reg >> 1
    prev_state = np.zeros((ns, 2), np.int32)
    prev_bit = np.zeros((ns, 2), np.int8)
    cnt = np.zeros(ns, np.int32)
    for s in range(ns):
        for b in range(2):
            t = next_state[s, b]
            prev_state[t, cnt[t]] = s
            prev_bit[t, cnt[t]] = b
            cnt[t] += 1
    assert (cnt == 2).all()
    return next_state, out_bits, prev_state, prev_bit


def conv_encode(bits, terminated: bool = True) -> torch.Tensor:
    """Rate-1/3 K=7 convolutional encoder.

    bits: (..., K) integers {0, 1}. Returns (..., 3·(K+6)) int32 coded
    bits when terminated (6 zero tail bits flush the register,
    'Terminated' mode), the three outputs of each step together. Output
    j at step t is the parity of the register [b_t, b_t−1, ..., b_t−6]
    under polynomial j: one convolution mod 2, no loop over time.
    """
    b = torch.as_tensor(bits).to(torch.int32)
    if terminated:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (CONSTRAINT - 1,))], -1)
    # window[..., t, k] = b_{t−k}, zeros before the start
    padded = torch.cat([b.new_zeros(b.shape[:-1] + (CONSTRAINT - 1,)), b], -1)
    win = padded.unfold(-1, CONSTRAINT, 1).flip(-1)          # (..., T, 7)
    taps = torch.as_tensor(
        [[(p >> (CONSTRAINT - 1 - k)) & 1 for k in range(CONSTRAINT)]
         for p in POLYS], dtype=torch.int32, device=b.device)  # (3, 7)
    out = (win[..., None, :] * taps).sum(-1) & 1             # (..., T, 3)
    return out.reshape(out.shape[:-2] + (-1,))


def viterbi_decode(llrs, num_info_bits: int,
                   terminated: bool = True) -> torch.Tensor:
    """Soft-input Viterbi decoder over a batch of codewords.

    LLR convention: llr > 0 ⇒ bit 0 more likely (MATLAB qamdemod
    'approxllr'). Branch metric for coded bit c: +llr if c == 0 else
    −llr; the path metric is maximized, renormalized to its maximum
    every step; a tie keeps the first predecessor, as JAX's argmax does.

    Args:
      llrs: (..., 3·T) soft inputs (T = num_info_bits + 6 when
        terminated), float32.
      num_info_bits: number of information bits to return.

    Returns:
      (..., num_info_bits) int32 hard-decided bits, on llrs' device.
    """
    _, out_bits, prev_state, prev_bit = _trellis()
    llrs = torch.as_tensor(llrs).float()
    lead = llrs.shape[:-1]
    dev = llrs.device
    x = llrs.reshape(-1, llrs.shape[-1] // RATE_DEN, RATE_DEN)  # (B, T, 3)
    B, T = x.shape[0], x.shape[1]
    ps = torch.as_tensor(prev_state.astype(np.int64), device=dev)  # (S, 2)
    pb = torch.as_tensor(prev_bit.astype(np.int32), device=dev)
    # sign of each coded bit on the transition INTO s' from predecessor i
    ob_in = out_bits[prev_state, prev_bit]                     # (S, 2, 3)
    sgn = torch.as_tensor(1.0 - 2.0 * ob_in.astype(np.float32), device=dev)
    # branch metrics of every step at once: Σ_j sgn·llr, j in order
    bm = ((sgn[..., 0] * x[..., 0, None, None]
           + sgn[..., 1] * x[..., 1, None, None])
          + sgn[..., 2] * x[..., 2, None, None])               # (B, T, S, 2)
    bm = bm.transpose(0, 1).contiguous()                       # (T, B, S, 2)

    metric = torch.full((B, NUM_STATES), -1e30, device=dev)
    metric[:, 0] = 0.0
    decisions = torch.empty((T, B, NUM_STATES), dtype=torch.bool, device=dev)
    for t in range(T):
        cand = metric[:, ps] + bm[t]                           # (B, S, 2)
        c0, c1 = cand.unbind(-1)
        torch.gt(c1, c0, out=decisions[t])
        new = torch.maximum(c0, c1)
        metric = new - new.amax(-1, keepdim=True)
    if terminated:
        state = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        state = metric.argmax(-1)
    rows = torch.arange(B, device=dev)
    bits = torch.empty((T, B), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        i = decisions[t, rows, state].long()
        bits[t] = pb[state, i]
        state = ps[state, i]
    return bits[:num_info_bits].T.reshape(lead + (num_info_bits,))


# ----------------------------------------------------------------------
# QPSK / QAM
# ----------------------------------------------------------------------

def qpsk_constellation(device=None) -> torch.Tensor:
    """Unit-average-power QPSK points indexed by integer (b0<<1)|b1."""
    pts = torch.tensor([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                       dtype=torch.complex64, device=device)
    return pts / math.sqrt(2.0)


def qpsk_mod(bits) -> torch.Tensor:
    """Gray QPSK, unit average power; bits (..., 2K) → symbols (..., K).

    Mapping: b0 → real sign, b1 → imag sign; sym = ((1−2b0)+j(1−2b1))/√2.
    """
    b = torch.as_tensor(bits).float()
    b = b.reshape(b.shape[:-1] + (-1, 2))
    return torch.complex(1.0 - 2.0 * b[..., 0],
                         1.0 - 2.0 * b[..., 1]) / math.sqrt(2.0)


def qpsk_demod_llr(syms, noise_var) -> torch.Tensor:
    """Approximate per-bit LLRs (llr > 0 ⇒ bit 0), unit-average-power
    QPSK: llr_b0 = 2√2·Re(y)/σ², llr_b1 = 2√2·Im(y)/σ² (max-log LLR for
    the Gray mapping above).

    syms: (..., K) complex; noise_var: a float or a tensor broadcasting
    against (...). Returns (..., 2K), [b0, b1] interleaved per symbol.
    """
    y = torch.as_tensor(syms)
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    scale = (2.0 * math.sqrt(2.0) / nv)[..., None]
    llr = torch.stack([scale * y.real, scale * y.imag], dim=-1)
    return llr.reshape(llr.shape[:-2] + (-1,))


# ----------------------------------------------------------------------
# Generic square M-QAM (MATLAB qammod/qamdemod 'gray','UnitAveragePower')
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def _qam_tables(m: int):
    """(constellation (m,), bit_table (m, log2(m))) gray square QAM with
    unit average power. Bit order: [I bits | Q bits], MSB first per axis.
    Bits 0...0 (gray level 0) map to the most positive amplitude, the
    convention of qpsk_mod (llr > 0 ⇒ bit 0)."""
    k = int(np.log2(m))
    if 2 ** k != m or k % 2:
        raise ValueError(f"square QAM only, got m={m}")
    kh = k // 2
    n_pam = 1 << kh
    lev = np.arange(n_pam)
    gray = lev ^ (lev >> 1)
    amp = (n_pam - 1) - 2 * lev
    amp_for_gray = np.zeros(n_pam)
    amp_for_gray[gray] = amp                       # gray code g -> amplitude
    scale = np.sqrt(2.0 * (n_pam**2 - 1) / 3.0)    # unit avg power
    const = np.zeros(m, np.complex64)
    bits = np.zeros((m, k), np.int8)
    for i in range(m):
        gi, gq = i >> kh, i & (n_pam - 1)
        const[i] = (amp_for_gray[gi] + 1j * amp_for_gray[gq]) / scale
        for b in range(kh):
            bits[i, b] = (gi >> (kh - 1 - b)) & 1
            bits[i, kh + b] = (gq >> (kh - 1 - b)) & 1
    return const, bits


def qam_constellation(m: int, device=None) -> torch.Tensor:
    """The (m,) complex64 points of ``_qam_tables(m)``."""
    return torch.as_tensor(_qam_tables(m)[0], device=device)


def qam_mod(bits, m: int) -> torch.Tensor:
    """Gray square M-QAM, unit average power; bits (..., k·K) → (..., K)
    symbols (k = log2 m). The bits of a symbol spell its table row."""
    const, table = _qam_tables(m)
    k = table.shape[1]
    b = torch.as_tensor(bits).to(torch.int64)
    b = b.reshape(b.shape[:-1] + (-1, k))
    weights = torch.as_tensor(1 << np.arange(k - 1, -1, -1), device=b.device)
    idx = (b * weights).sum(-1)
    return torch.as_tensor(const, device=b.device)[idx]


def qam_demod_approx_llr(syms, m: int, noise_var) -> torch.Tensor:
    """Max-log approximate LLRs (MATLAB 'approxllr'): llr > 0 ⇒ bit 0,

        llr_b = (min_{s: bit_b(s)=1} |y−s|² − min_{s: bit_b(s)=0} |y−s|²)/σ²

    syms (..., K); noise_var a float or a tensor broadcasting against
    (...). Returns (..., k·K)."""
    const, table = _qam_tables(m)
    y = torch.as_tensor(syms)
    c = torch.as_tensor(const, device=y.device)
    d2 = (y[..., None] - c).abs() ** 2                       # (..., K, m)
    t = torch.as_tensor(table.astype(np.float32).T, device=y.device)  # (k, m)
    big = 1e30
    d0 = (d2[..., None, :] + big * t).amin(-1)               # (..., K, k)
    d1 = (d2[..., None, :] + big * (1.0 - t)).amin(-1)
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    llr = (d1 - d0) / nv[..., None, None]
    return llr.reshape(llr.shape[:-2] + (-1,))


def mimo_equalize(rx_grid, h):
    """Per-subcarrier zero-forcing MIMO equalization and CSI weights
    (helperMIMOEqualize behaviour: the equalized symbols and the
    per-stream channel energy that scales the LLRs,
    generate_maMIMO_LTF.m:582,595-598).

    Args:
      rx_grid: (..., C, nsym, Nr) received data-carrier symbols.
      h: (..., C, nsts, Nr) estimated channel (y = x·H per carrier).

    Returns:
      (rx_eq (..., C, nsym, nsts), csi (..., C, nsts)). The right
      pseudo-inverse x̂ = y Hᴴ (H Hᴴ)⁻¹ takes the inverse through
      ``ops/estimate.py::_solve`` (one system at a time on the CPU).
    """
    rx_grid, h = torch.as_tensor(rx_grid), torch.as_tensor(h)
    n = h.shape[-2]
    with full_f32_matmul():
        hc = h.conj()
        hh = torch.einsum("...jr,...kr->...jk", h, hc)       # (..., C, n, n)
        rhs = torch.einsum("...nr,...jr->...nj", rx_grid, hc)
        eye = torch.eye(n, dtype=hh.dtype, device=hh.device)
        inv = _solve(hh, eye.expand(hh.shape))
        rx_eq = rhs @ inv
    csi = (h.abs() ** 2).sum(-1)                             # (..., C, n)
    return rx_eq, csi


def _pilot_polarity_np(n: int, z: int = 4) -> np.ndarray:
    """IEEE 802.11 pilot polarity sequence p_{z}..p_{z+n-1}: the
    127-periodic ±1 output of the 802.11 scrambler LFSR (S(x) = x⁷ + x⁴ +
    1, all-ones seed) mapped 0→+1 / 1→−1 (IEEE 802.11-2016 §17.3.5.10);
    data symbols start at offset z=4 (§21.3.7.6)."""
    state = [1] * 7
    seq = np.empty(127, np.float32)
    for i in range(127):
        b = state[6] ^ state[3]
        seq[i] = 1.0 - 2.0 * b
        state = [b] + state[:6]
    return seq[(z + np.arange(n)) % 127]


def gen_pilots(nsym: int, nsts: int, device=None) -> torch.Tensor:
    """Multi-antenna pilot tones for the data symbols (helperGenPilots
    equivalent, generate_maMIMO_LTF.m:495-499): the 802.11ac VHT-80MHz
    pattern Ψ = {1,1,1,−1,−1,1,1,1} rotated by one tone a data symbol
    (Ψ[(m+n) mod 8], IEEE 802.11-2016 §21.3.10.10), scaled by the
    polarity sequence p_{n+4} and replicated across the streams.

    Returns (8, nsym, nsts) complex64."""
    n_pilot = 8
    psi = np.asarray([1, 1, 1, -1, -1, 1, 1, 1], np.float32)
    pol = _pilot_polarity_np(nsym)
    m = np.arange(n_pilot)[:, None]
    n = np.arange(nsym)[None, :]
    pil = psi[(m + n) % n_pilot] * pol[None, :]                # (8, nsym)
    out = np.repeat(pil[:, :, None], nsts, axis=2).astype(np.complex64)
    return torch.as_tensor(out, device=device)
