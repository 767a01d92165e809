"""Channel estimators (the port's copy of ``mamimo_tpu/ops/estimate.py``):
per-subcarrier LS in four forms and the frequency-correlation LMMSE in
five.

LS: ``ls_estimate`` (the FFT form, on the ``ofdm_demodulate`` grid),
``ls_estimate_matmul`` (time-major complex preambles),
``ls_estimate_rxmajor`` (antenna-major complex preambles) and
``ls_estimate_planes`` (flat rx-major planes). ``ls_estimate_planes`` is
the plain PyTorch version of the flat-planes LS kernels and
``ls_estimate_matmul`` that of the per-pair LS kernel
(``ops/kernels/fused_ls.py``): the CPU paths, and the references the
kernels are held to on the card.

LMMSE (``LMMSE_ce.m``): the dense smoothing matrix (``lmmse_weight``,
``lmmse_estimate``, ``lmmse_estimate_chunked``), the solve on the
right-hand sides (``lmmse_estimate_direct``), the eigenbasis form
(``lmmse_estimate_eig``) and the circulant-preconditioned CG
(``lmmse_estimate_cg``, the production sounding form). None of them is
a TPU kernel in the JAX package: they are PyTorch here (cuSOLVER's
solve and eigh, cuFFT, cuBLAS on the card), in full float32.
"""

from __future__ import annotations

import math
from contextlib import nullcontext

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.ltf import _hadamard_np, _ltf_np
from mamimo_tpu_torch.utils.numerics import full_f32_matmul, matmul_precision


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


def ls_matmul_constants(cfg: SimConfig, padded: bool = False, device=None):
    """Constants of ls_estimate_matmul: (A, P) with A =
    dft_selected_np(cfg), (num_carriers, fft_length) complex64 (with
    ``padded``: dft_selected_padded_np(cfg), (num_carriers, sym_len), the
    constants of ls_estimate_rxmajor), and P the float32 ±1 Hadamard
    matrix."""
    a = dft_selected_padded_np(cfg) if padded else dft_selected_np(cfg)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(_hadamard_np(cfg.num_tx), device=device))


def ls_matmul_constants_rxmajor(cfg: SimConfig, device=None):
    """Constants (A_padded, P) of ls_estimate_rxmajor."""
    return ls_matmul_constants(cfg, padded=True, device=device)


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


def ls_estimate(cfg: SimConfig, rx_grid, num_sts: int | None = None):
    """Least-squares MIMO channel estimate from the demodulated preamble
    (the FFT form: ``ofdm_demodulate`` then this despread),
    ``hD(:,j,i) = rxsym * conj(P(j,:))' ./ (nltf * ltf(ind))``
    (helperMIMOChannelEstimate.m:24-41).

    Args:
      rx_grid: (..., num_carriers, nsym >= num_sts, num_rx) demodulated
        data-carrier grid.
      num_sts: number of sounded streams (default cfg.num_tx).

    Returns:
      (..., num_carriers, num_sts, num_rx) complex channel estimate.
    """
    if num_sts is None:
        num_sts = cfg.num_tx
    rx = torch.as_tensor(rx_grid)
    p = torch.as_tensor(_hadamard_np(num_sts), device=rx.device)
    ltf = torch.as_tensor(
        _ltf_np(cfg.fft_length)[np.asarray(cfg.carrier_locations)],
        device=rx.device)
    with full_f32_matmul():
        hd = torch.einsum("...cnr,jn->...cjr", rx[..., :num_sts, :],
                          p.to(rx.dtype))
    denom = (num_sts * ltf).to(hd.real.dtype)
    return hd / denom[:, None, None]


def ls_estimate_rxmajor(cfg: SimConfig, rx: torch.Tensor,
                        consts=None) -> torch.Tensor:
    """LS estimation in the rx-major layout (the math of
    ls_estimate_matmul): each antenna's preamble is contiguous in time,
    the per-symbol DFT contracts it against the padded DFT matrix (the CP
    drop folded in as zero columns), then the despread contracts the
    symbol axis.

    Args:
      rx: (B, num_rx, len_ltf) complex64.
      consts: optional (A_padded, P) from ls_matmul_constants_rxmajor.

    Returns:
      (B, num_rx, num_tx, num_carriers) complex64; permute(0, 3, 2, 1)
      gives the ls_estimate layout.
    """
    if consts is None:
        consts = ls_matmul_constants_rxmajor(cfg, device=rx.device)
    a, p = consts
    b, nrx, _ = rx.shape
    x = rx.reshape(b, nrx, cfg.num_tx, cfg.sym_len)
    with full_f32_matmul():
        y = torch.einsum("brnt,ct->brnc", x, a.to(rx.dtype))
        return torch.einsum("jn,brnc->brjc", p.to(rx.dtype), y)


# ---------------------------------------------------------------------------
# LMMSE (LMMSE_ce.m:23-39). Every product runs in full float32 on the
# card (TF32 off), as JAX pins HIGHEST: these are the oracle-held forms.
# ---------------------------------------------------------------------------


def lmmse_tau_rms(tau) -> torch.Tensor:
    """The reference's rms-delay proxy from the scatterer 'h' vector
    (LMMSE_ce.m:27-30; see lmmse_weight for the delays-as-h quirk):
    (..., ns) → (...,)."""
    tau = torch.as_tensor(tau)
    k = torch.arange(tau.shape[-1], dtype=tau.dtype, device=tau.device)
    w = tau * tau
    hh = torch.sum(w, dim=-1)
    tmp = w * k
    r = torch.sum(tmp, dim=-1) / hh
    r2 = torch.sum(tmp * k, dim=-1) / hh
    return torch.sqrt(torch.clamp(r2 - r * r, min=0.0))


def _inv_one_plus_j(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + j·x) for real float32 x, complex64."""
    return 1.0 / torch.complex(torch.ones_like(x), x)


def lmmse_rf(cfg: SimConfig, tau) -> torch.Tensor:
    """Frequency-correlation matrix Rf[a, b] = 1/(1 + j·2π·τ_rms·df·(a−b))
    (LMMSE_ce.m:33-36; Rhp = Rpp0 = Rf): (..., ns) → (..., C, C)."""
    tau_rms = lmmse_tau_rms(tau)
    n = cfg.num_carriers
    a = torch.arange(n, device=tau_rms.device)
    diff = (a[:, None] - a[None, :]).to(torch.float32)
    w = (2.0 * math.pi) * tau_rms[..., None, None] * (1.0 / n)
    return _inv_one_plus_j(w * diff)


def lmmse_eig_factor(cfg: SimConfig, tau):
    """Eigendecomposition of Rf, the per-packet half of the eigenbasis
    LMMSE: Rf = U·diag(λ)·Uᴴ. Rpp = Rf + σ²I shares Rf's eigenvectors,
    so M = Rf·Rpp⁻¹ = U·diag(λ/(λ + 1/snr))·Uᴴ and one factorization
    serves every antenna and SNR. The eigenvectors are not unique (their
    phases, and the basis of a repeated eigenvalue, differ between
    solvers): compare estimates, not ``u``.

    Returns (u, lam): (..., C, C) complex64, (..., C) float32 ascending.
    """
    with full_f32_matmul():
        lam, u = torch.linalg.eigh(lmmse_rf(cfg, tau))
    return u, lam


def _snr_lin(snr_db, device) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32,
                                    device=device) * 0.1)


def lmmse_estimate_eig(cfg: SimConfig, h_ls, tau=None, snr_db=None,
                       factors=None) -> torch.Tensor:
    """LMMSE estimate through the eigenbasis of Rf (the math of
    lmmse_estimate): ĥ = U · (λ/(λ + 1/snr) ⊙ (Uᴴ·h_LS)).

    Args:
      h_ls:    (..., C, nsts, R) LS estimate.
      tau:     (..., ns) path delays (unused when factors is given).
      snr_db:  (..., R) per-antenna sounding SNR in dB.
      factors: optional (u, lam) from lmmse_eig_factor, to share one
        factorization across SNR levels.

    Returns: same shape as h_ls.
    """
    if factors is None:
        factors = lmmse_eig_factor(cfg, tau)
    u, lam = factors
    snr = _snr_lin(snr_db, lam.device)
    d = lam[..., :, None] / (lam[..., :, None] + 1.0 / snr[..., None, :])
    with full_f32_matmul():
        g = torch.einsum("...dc,...djr->...cjr", u.conj(), h_ls.to(u.dtype))
        g = g * d[..., :, None, :].to(u.dtype)
        return torch.einsum("...cd,...djr->...cjr", u, g)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.linalg.solve(a, b) over broadcast batch dims. On the CPU the
    systems are solved one at a time: PyTorch's batched CPU LU (MKL's
    getrf/getrs in a parallel loop) fails with "Parameter 6 was incorrect
    on entry to CLASWP" and never returns once ``torch.set_num_threads``
    has been called in the process, as the bench's CPU yardstick does
    (torch 2.13, MKL 2024.2); one system at a time is unaffected."""
    if a.is_cuda:
        return torch.linalg.solve(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a2 = a.expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b2 = b.expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    x = torch.stack([torch.linalg.solve(ai, bi) for ai, bi in zip(a2, b2)])
    return x.reshape(batch + b.shape[-2:])


def lmmse_weight(cfg: SimConfig, tau, snr_db) -> torch.Tensor:
    """Per-(packet, rx-antenna) LMMSE smoothing matrix M = Rhp · Rpp⁻¹
    (LMMSE_ce.m:23-39), with the reference's quirk: the "channel impulse
    response" it is given is the vector of scatterer path delays
    (generate_maMIMO_LTF.m:210,342), so the rms-delay proxy is computed
    from τ² weights over the scatterer index (lmmse_tau_rms), and
    Nfft = Np = num_carriers, Nps = 1, df = 1/num_carriers:

        Rhp = Rpp0 = Rf (lmmse_rf),  Rpp = Rf + I/snr,  M = Rhp · Rpp⁻¹

    computed as solve(Rppᵀ, Rhpᵀ)ᵀ.

    Args:
      tau:    (..., n_scatterers) path delays in scatterer order.
      snr_db: (...,) per-antenna sounding SNR in dB.

    Returns:
      (..., num_carriers, num_carriers) complex64 M.
    """
    rf = lmmse_rf(cfg, tau)
    snr = _snr_lin(snr_db, rf.device)
    eye = torch.eye(cfg.num_carriers, dtype=rf.dtype, device=rf.device)
    rpp = rf + eye / snr[..., None, None]
    with full_f32_matmul():
        m = _solve(rpp.transpose(-1, -2), rf.transpose(-1, -2))
    return m.transpose(-1, -2).to(torch.complex64)


def lmmse_estimate(cfg: SimConfig, h_ls, tau, snr_db) -> torch.Tensor:
    """LMMSE channel estimate from the LS estimate, the dense form:
    M (lmmse_weight) applied per rx antenna.

    Args:
      h_ls:   (..., num_carriers, num_sts, num_rx) LS estimate.
      tau:    (..., n_scatterers) path delays (see lmmse_weight).
      snr_db: (..., num_rx) per-antenna sounding SNR in dB.

    Returns:
      same shape as h_ls.
    """
    tau = torch.as_tensor(tau)
    m = lmmse_weight(cfg, tau[..., None, :], snr_db)         # (..., R, C, C)
    with full_f32_matmul():
        return torch.einsum("...rcd,...djr->...cjr", m, h_ls.to(m.dtype))


def lmmse_estimate_chunked(cfg: SimConfig, h_ls, tau, snr_db,
                           chunk: int = 32) -> torch.Tensor:
    """lmmse_estimate over the leading packet axis, ``chunk`` packets at a
    time, which bounds the live (chunk, num_rx, C, C) smoothing matrices.

    Args:
      h_ls: (B, C, num_sts, num_rx); tau: (B, ns); snr_db: (B, num_rx).
    """
    snr_db = torch.as_tensor(snr_db, device=h_ls.device)
    return torch.cat([
        lmmse_estimate(cfg, h_ls[i:i + chunk], tau[i:i + chunk],
                       snr_db[i:i + chunk])
        for i in range(0, h_ls.shape[0], chunk)])


def lmmse_estimate_direct(cfg: SimConfig, h_ls, tau, snr_db) -> torch.Tensor:
    """LMMSE estimate without the smoothing matrix (the math of
    lmmse_estimate): ĥ = Rf · solve(Rpp, h), a solve with the num_sts
    right-hand sides only. Shapes as lmmse_estimate."""
    tau = torch.as_tensor(tau)
    rf = lmmse_rf(cfg, tau[..., None, :])                    # (..., 1, C, C)
    snr = _snr_lin(snr_db, rf.device)                        # (..., R)
    eye = torch.eye(cfg.num_carriers, dtype=rf.dtype, device=rf.device)
    rpp = rf + eye / snr[..., None, None]                    # (..., R, C, C)
    rhs = h_ls.to(rf.dtype).movedim(-1, -3)                  # (..., R, C, s)
    with full_f32_matmul():
        x = _solve(rpp, rhs)
        y = rf @ x
    return y.movedim(-3, -1).to(torch.complex64)


def _lmmse_generator(cfg: SimConfig, tau) -> torch.Tensor:
    """Toeplitz generator of Rf: f[k] = 1/(1 + j·2π·τ_rms·df·k),
    k = 0..C−1 (negative lags are conj(f[k])): (..., ns) → (..., C)."""
    tau_rms = lmmse_tau_rms(tau)
    n = cfg.num_carriers
    k = torch.arange(n, dtype=torch.float32, device=tau_rms.device)
    return _inv_one_plus_j((2.0 * math.pi / n) * tau_rms[..., None] * k)


def lmmse_estimate_cg(cfg: SimConfig, h_ls, tau, snr_db, n_iter: int = 16,
                      embed: int = 512, precond_precision=None,
                      matvec_precision=None) -> torch.Tensor:
    """LMMSE estimate by circulant-preconditioned conjugate gradients (the
    math of lmmse_estimate; the production sounding form).

    Rf is Hermitian Toeplitz, generated by the one scalar τ_rms, and
    M·h = h − σ²·Rpp⁻¹·h; so the estimator is one Toeplitz-plus-σ²I solve
    whose matvec goes through an ``embed``-point circulant embedding. The
    preconditioner is the padded-circulant solve (the clamped embedding
    spectrum plus σ²). Like the JAX function, the transforms are the
    truncated DFT products (C rows forward, C columns back) with the
    angle reduced mod ``embed`` in float32 before scaling, and ``n_iter``
    fixed steps, so each iteration is JAX's.

    Args:
      h_ls (..., C, nsts, R), tau (..., ns), snr_db (..., R): as
        lmmse_estimate.
      matvec_precision, precond_precision: the precision of the matvec's
        and of the preconditioner's DFT products by JAX's name:
        'highest' (None for the matvec: full float32), 'high' or
        'default' (TF32 on the card; JAX's 3-pass and 1-pass bf16 on the
        TPU). The preconditioner follows the matvec when None. The CPU
        computes float32 for every name (``matmul_precision``).

    Returns: same shape as h_ls, complex64.
    """
    n, m = cfg.num_carriers, embed
    if m < 2 * n - 1:
        raise ValueError(f"embed {m} must cover every Toeplitz lag "
                         f"(>= {2 * n - 1})")
    mv_prec = "highest" if matvec_precision is None else matvec_precision
    pc_prec = mv_prec if precond_precision is None else precond_precision
    for name in (mv_prec, pc_prec):
        matmul_precision(name)                              # validates
    f = _lmmse_generator(cfg, tau)                           # (..., C)
    cdt, dev = f.dtype, f.device
    zeros = torch.zeros(f.shape[:-1] + (m - 2 * n + 1,), dtype=cdt,
                        device=dev)
    c = torch.cat([f, zeros, f[..., 1:].flip(-1).conj()], dim=-1)
    ce = torch.fft.fft(c, dim=-1)[..., None, None, :]        # (..., 1, 1, M)
    snr = _snr_lin(snr_db, dev)                              # (..., R)
    sig2 = (1.0 / snr)[..., None, None]                      # (..., R, 1, 1)
    pe = torch.clamp(ce.real, min=0.0) + sig2                # (..., R, 1, M)
    b = h_ls.to(cdt).movedim(-1, -3).transpose(-1, -2)       # (..., R, s, C)

    kc = torch.arange(n, dtype=torch.float32, device=dev)
    jm = torch.arange(m, dtype=torch.float32, device=dev)
    ang = (2.0 * math.pi / m) * torch.remainder(kc[:, None] * jm[None, :], m)
    fwd = torch.complex(torch.cos(ang), -torch.sin(ang))     # (C, M)
    inv = fwd.conj().transpose(0, 1) / m                     # (M, C)

    def matvec(v):
        with matmul_precision(mv_prec):
            w = ((v @ fwd) * ce) @ inv
        return w + sig2 * v

    def precond(r):
        with matmul_precision(pc_prec):
            return ((r @ fwd) / pe) @ inv

    def rdot(u, v):
        return torch.sum(u.conj() * v, dim=-1, keepdim=True).real.float()

    eps = 1e-30
    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    rho = rdot(r, z)
    for _ in range(n_iter):
        ap = matvec(p)
        alpha = (rho / (rdot(p, ap) + eps)).to(cdt)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rho_n = rdot(r, z)
        beta = (rho_n / (rho + eps)).to(cdt)
        p = z + beta * p
        rho = rho_n
    y = b - sig2 * x                                         # h − σ²·Rpp⁻¹h
    return y.transpose(-1, -2).movedim(-3, -1).to(torch.complex64)
