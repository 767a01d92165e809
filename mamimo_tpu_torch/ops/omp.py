"""Orthogonal-matching-pursuit hybrid beamforming weights (the port's
copy of ``mamimo_tpu/ops/omp.py``).

A reformulation of ``ompdecomp.m:105-116`` and ``omphybweights.m:169-203``
(El Ayach et al., "Spatially Sparse Precoding in Millimeter Wave MIMO
Systems", IEEE TWC 2014):

* the greedy loop runs a fixed ``max_sparsity`` iterations with a growing
  masked basis: the normal equations pad the Gram matrix with identity
  rows, so unselected columns contribute exact zeros; a decomposition
  that has converged (residual ≤ float32 eps) stops changing;
* every function works on leading batch dims (packets, sources,
  carriers): the dictionary may carry fewer of them (one per packet,
  shared by its sources and carriers) and is never copied out to the
  batch.

Singular vectors carry an arbitrary phase, so the digital weights do
too; the atom choice and the RF weights do not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mamimo_tpu_torch.ops.estimate import _solve
from mamimo_tpu_torch.utils.numerics import full_f32_matmul

_EPS32 = float(torch.finfo(torch.float32).eps)


class OMPResult(NamedTuple):
    coeff: torch.Tensor     # (..., S, Nw) digital weights
    atoms: torch.Tensor     # (..., N, S) chosen dictionary atoms
    atom_idx: torch.Tensor  # (..., S) indices into the dictionary
    err_norm: torch.Tensor  # (...) final residual Frobenius norm


def _fro(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=(-2, -1))


def omp_decomp(wopt, adict, max_sparsity: int,
               norm_weight=None) -> OMPResult:
    """Decompose ``wopt ≈ atoms @ coeff`` with atoms from ``adict``.

    Mirrors ompdecomp.m: at step m pick the atom maximizing
    ``diag(Psi Psi^H)`` with ``Psi = A^H W r`` (:107-109), weighted-LS
    refit of all coefficients so far (:111), residual normalization
    (:112-114). Early convergence (err <= eps) freezes further updates.

    Args:
      wopt: (..., N, Nw) target (complex).
      adict: (..., N, Na) dictionary, its leading dims broadcasting
        against wopt's.
      max_sparsity: the number of atoms (NtRF).
      norm_weight: optional (..., N, N) W for the weighted norm.
    """
    wopt = torch.as_tensor(wopt).to(torch.complex64)
    adict = torch.as_tensor(adict, device=wopt.device).to(torch.complex64)
    n, nw = wopt.shape[-2:]
    s_max = int(max_sparsity)
    lead = torch.broadcast_shapes(wopt.shape[:-2], adict.shape[:-2])
    dev = wopt.device
    if norm_weight is not None:
        W = torch.as_tensor(norm_weight, device=dev).to(torch.complex64)
        lead = torch.broadcast_shapes(lead, W.shape[:-2])
    wopt = wopt.expand(lead + (n, nw))
    adict = adict.reshape((1,) * (len(lead) + 2 - adict.dim()) + adict.shape)
    with full_f32_matmul():
        ah = adict.conj().transpose(-2, -1)                    # (..., Na, N)
        aw = ah if norm_weight is None else ah @ W

        def weigh(x):
            return x if norm_weight is None else W @ x

        atoms = wopt.new_zeros(lead + (n, s_max))
        idx = torch.zeros(lead + (s_max,), dtype=torch.int64, device=dev)
        res = wopt
        err = torch.ones(lead, device=dev)
        coeff = wopt.new_zeros(lead + (s_max, nw))
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        for m in range(s_max):
            psi = torch.einsum("...an,...nw->...aw", aw, res)
            k = (psi.abs() ** 2).sum(-1).argmax(-1)            # (...)
            atom = torch.take_along_dim(
                adict, k[..., None, None].expand(lead + (n, 1)), dim=-1)
            new_atoms = atoms.clone()
            new_atoms[..., m] = atom[..., 0]
            new_idx = idx.clone()
            new_idx[..., m] = k
            mask = torch.arange(s_max, device=dev) <= m
            am = new_atoms * mask
            amh = am.conj().transpose(-2, -1)
            gram = amh @ weigh(am) + torch.diag(
                (~mask).to(torch.complex64))
            rhs = amh @ weigh(wopt)
            new_coeff = _solve(gram, rhs)
            temp = wopt - am @ new_coeff
            new_err = _fro(temp)
            new_res = temp / torch.clamp(new_err, min=1e-30)[..., None, None]
            upd = ~done
            atoms = torch.where(upd[..., None, None], new_atoms, atoms)
            idx = torch.where(upd[..., None], new_idx, idx)
            res = torch.where(upd[..., None, None], new_res, res)
            err = torch.where(upd, new_err, err)
            coeff = torch.where(upd[..., None, None], new_coeff, coeff)
            done = done | (new_err <= _EPS32)
    return OMPResult(coeff, atoms, idx, err)


def _optimal_precoder(H: torch.Tensor, ns: int) -> torch.Tensor:
    """The first ns right singular vectors of H (..., Nr, Nt), as columns
    (..., Nt, ns)."""
    _, _, vh = torch.linalg.svd(H, full_matrices=False)
    return vh.conj().transpose(-2, -1)[..., :ns]


def _scale_fbb(frf: torch.Tensor, fbb: torch.Tensor, ns: int):
    """fbb scaled so that ‖frf·fbb‖_F = √ns (omphybweights.m:176-178)."""
    nrm = _fro(frf @ fbb)
    return fbb * (torch.sqrt(torch.tensor(float(ns), device=fbb.device))
                  / torch.clamp(nrm, min=1e-30))[..., None, None]


def omp_hyb_weights(h, ns: int, ntrf: int, at):
    """Hybrid precoding weights per subcarrier (omphybweights.m).

    Args:
      h: (..., L, Nt, Nr) channel estimates (comm convention).
      ns: number of data streams.
      ntrf: number of transmit RF chains.
      at: (..., Nt, Na) steering dictionary, its leading dims (without
        the carrier axis L) broadcasting against h's: the same for every
        subcarrier, as the caller replicates it at
        generate_maMIMO_LTF.m:415-418.

    Returns:
      (fbb, frf): (..., L, ns, ntrf) baseband and (..., L, ntrf, Nt) RF
      weights.
    """
    h = torch.as_tensor(h).to(torch.complex64)
    at = torch.as_tensor(at, device=h.device)[..., None, :, :]
    with full_f32_matmul():
        H = h.transpose(-2, -1)                                 # (..., Nr, Nt)
        fopt = _optimal_precoder(H, ns)
        r = omp_decomp(fopt, at, ntrf)
        frf, fbb = r.atoms, r.coeff                             # (Nt, ntrf), (ntrf, ns)
        fbb = _scale_fbb(frf, fbb, ns)
    return fbb.transpose(-2, -1), frf.transpose(-2, -1)


def omp_hyb_combining(h, ns: int, ntrf: int, at, nrrf: int, ar,
                      npow: float = 0.0):
    """Full precoding + combining variant (omphybweights.m:180-202).

    ``at`` (..., Nt, Na) and ``ar`` (..., Nr, Nar) as ``omp_hyb_weights``'s
    ``at``. Returns (fbb, frf, wbb, wrf) with shapes (..., L, ns, ntrf),
    (..., L, ntrf, Nt), (..., L, nrrf, ns), (..., L, Nr, nrrf).
    """
    h = torch.as_tensor(h).to(torch.complex64)
    dev = h.device
    nr = h.shape[-1]
    at = torch.as_tensor(at, device=dev)[..., None, :, :]
    ar = torch.as_tensor(ar, device=dev)[..., None, :, :]
    with full_f32_matmul():
        H = h.transpose(-2, -1)                                 # (..., Nr, Nt)
        fopt = _optimal_precoder(H, ns)
        rp = omp_decomp(fopt, at, ntrf)
        frf, fbb = rp.atoms, _scale_fbb(rp.atoms, rp.coeff, ns)
        Hh = H.conj().transpose(-2, -1)
        hf = H @ frf @ fbb                                      # (..., Nr, ns)
        feh = (frf @ fbb).conj().transpose(-2, -1)              # (..., ns, Nt)
        eye_s = torch.eye(ns, dtype=torch.complex64, device=dev)
        # MMSE combiner (omphybweights.m:181-183)
        gram = feh @ (Hh @ H) @ (frf @ fbb) + npow * ns * eye_s
        wmmse = _solve(gram, feh @ Hh).conj().transpose(-2, -1)  # (..., Nr, ns)
        eyy = (hf @ (eye_s / ns) @ hf.conj().transpose(-2, -1)
               + npow * torch.eye(nr, dtype=torch.complex64, device=dev))
        rc = omp_decomp(wmmse, ar, nrrf, norm_weight=eyy)
    return (fbb.transpose(-2, -1), frf.transpose(-2, -1),
            rc.coeff.conj_physical(), rc.atoms.conj_physical())
