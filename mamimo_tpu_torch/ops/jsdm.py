"""Joint Spatial Division Multiplexing (JSDM) transmit weights for the
multi-user path (the port's copy of ``mamimo_tpu/ops/jsdm.py``).

Re-derives the behaviour of the MathWorks ``helperJSDMTransmitWeights``
(called when numUsers > 1, ``generate_maMIMO_LTF.m:429``; Adhikary et
al., "Joint Spatial Division and Multiplexing", IEEE TIT 2013): one
group per user, an analog pre-beamformer per user from its channel
covariance with the other users' dominant subspace projected out (block
diagonalization), and per-user digital weights matched to the user's own
effective channel per subcarrier.

Batched linear algebra (eigendecompositions and einsums) over leading
dims (packets); the only Python loop is over the users. Eigenvectors
carry an arbitrary phase, so the analog rows do too: compare them by
their projectors b bᴴ. The digital weights of one stream per user do
not depend on it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def user_covariances(h_users) -> torch.Tensor:
    """Per-user Tx-side channel covariance R_u = Σ_c Σ_r h hᴴ / C.

    h_users: (..., U, C, Nt, Nr) per-user CSI. Returns (..., U, Nt, Nt)
    Hermitian covariances."""
    h = torch.as_tensor(h_users)
    with full_f32_matmul():
        return torch.einsum("...ucmr,...ucnr->...umn", h,
                            h.conj()) / h.shape[-3]


def jsdm_transmit_weights(h_users, num_sts: int = 1,
                          int_rank: int | None = None
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(Fbb list, mFrf) like helperJSDMTransmitWeights.

    Args:
      h_users: (..., U, C, Nt, Nr) per-user CSI estimates.
      num_sts: streams per user (equal per user).
      int_rank: rank of the interference subspace nulled per user
        (default num_sts × (U − 1)).

    Returns:
      fbb: U tensors (..., C, num_sts, num_sts), the per-user digital
        weights (the block-diagonal entries packed by
        ``pack_block_diagonal``, generate_maMIMO_LTF.m:432-438);
      m_frf: (..., U·num_sts, Nt) analog beamformer rows.
    """
    h = torch.as_tensor(h_users).to(torch.complex64)
    u_cnt, nt = h.shape[-4], h.shape[-2]
    covs = user_covariances(h)                               # (..., U, Nt, Nt)
    if int_rank is None:
        int_rank = num_sts * (u_cnt - 1)
    eye = torch.eye(nt, dtype=torch.complex64, device=h.device)
    rows, fbb = [], []
    with full_f32_matmul():
        total = covs.sum(-3)
        for u in range(u_cnt):
            # block diagonalization: project the user's covariance onto the
            # orthogonal complement of the other users' dominant
            # (rank-int_rank) subspace, then eigenbeam inside it
            r_int = total - covs[..., u, :, :]
            _, v_int = torch.linalg.eigh(r_int)
            u_int = v_int[..., nt - int_rank:]               # (..., Nt, rank)
            proj = eye - u_int @ u_int.conj().transpose(-2, -1)
            r_proj = proj @ covs[..., u, :, :] @ proj.conj().transpose(-2, -1)
            _, v_a = torch.linalg.eigh(r_proj)
            b_u = v_a[..., nt - num_sts:]                    # (..., Nt, sts)
            b_u = b_u / torch.linalg.vector_norm(b_u, dim=-2, keepdim=True)
            rows.append(b_u.conj().transpose(-2, -1))
            # per-carrier digital weights on the user's own effective block
            g = torch.einsum("...ms,...cmr->...csr", b_u.conj(),
                             h[..., u, :, :, :])             # (..., C, sts, Nr)
            gg = torch.einsum("...csr,...ctr->...cst", g, g.conj())
            norm = torch.sqrt(torch.clamp(
                torch.diagonal(gg, dim1=-2, dim2=-1).real, min=1e-30))
            f_u = gg.conj() / norm[..., None]
            peak = f_u.abs().amax((-2, -1), keepdim=True)
            fbb.append(f_u / torch.clamp(peak, min=1e-30))
    return fbb, torch.cat(rows, dim=-2)


def pack_block_diagonal(fbb: List[torch.Tensor], num_sts: int) -> torch.Tensor:
    """Pack per-user Fbb blocks (..., C, num_sts, num_sts) into the (...,
    C, sts_tot, sts_tot) steering matrix, transposed like the
    reference's ``v`` (generate_maMIMO_LTF.m:432-438)."""
    u_cnt = len(fbb)
    tot = u_cnt * num_sts
    steering = fbb[0].new_zeros(fbb[0].shape[:-2] + (tot, tot))
    for u in range(u_cnt):
        sl = slice(u * num_sts, (u + 1) * num_sts)
        steering[..., sl, sl] = fbb[u]
    return steering.transpose(-2, -1)
