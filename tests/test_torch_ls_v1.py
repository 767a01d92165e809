"""The port's v1 flat-planes LS (mamimo_tpu_torch.ops.kernels.fused_ls::
ls_planes_pallas / ls_planes_v1) against the JAX package's
ls_planes_pallas in interpret mode.

Inputs are made with numpy and handed to both packages. The CUDA kernel
(csrc/ls_v1.cu) runs only on the card (chip_smoke.py); here the wrapper's
CPU path (the kernel's plain version) is held to the JAX kernel, and the
layout the CUDA kernel writes — the shared GEMM and Walsh–Hadamard body
of csrc/ls_core.cuh, stored as padded (hr, hi) rows — is rebuilt in
float64 numpy and held to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_planes_pallas as j_ls_planes_pallas,
    ls_planes_pallas_constants as j_constants,
    ls_raw_to_complex as j_raw_to_complex,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_kernel_constants,
    ls_planes_pallas,
    ls_planes_pallas_constants,
    ls_planes_v1,
    ls_raw_to_complex,
)

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
S, BLOCK = 11, 4                # odd S: pad rows up to 12 samples
BF16_STEP = 2.0 ** -7           # one bfloat16 rounding step, relative


def _planes(seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, S, CFG.len_ltf)).astype(np.float32)


@pytest.mark.parametrize("cfg,jcfg,block", [(CFG, JCFG, 4),
                                            (SimConfig(), JSimConfig(), 8)])
def test_constants_equal_jax(cfg, jcfg, block):
    """(At_r, At_i, K) equal the JAX arrays exactly: (sym_len, Cp) with
    the CP as zero rows, carriers padded to 128 lanes, K = I_block ⊗ P."""
    got = ls_planes_pallas_constants(cfg, block)
    want = j_constants(jcfg, block)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(got[0].shape) == (cfg.sym_len, 256)
    assert tuple(got[2].shape) == (block * cfg.num_tx,) * 2


def _assert_raw_pads_zero(hr, hi, s, nt, c):
    for h in (hr, hi):
        h = h.float()
        assert not h[s * nt:].any(), "pad rows must be zero"
        assert not h[:, c:].any(), "pad lanes must be zero"


@pytest.mark.parametrize("form", ["complex", "raw_f32", "raw_bf16"])
def test_ls_planes_pallas_matches_jax(form):
    """The three forms the slice's paths use, against the JAX kernel in
    interpret mode on the same planes: the complex output at atol 2e-4,
    the raw padded (hr, hi) at the same padded shapes with zero pads, in
    float32 at atol 2e-4 and in bfloat16 at atol 2e-4 plus one bf16
    rounding step."""
    x = _planes()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if form == "complex":
        ref = np.asarray(j_ls_planes_pallas(JCFG, jx, block_samples=BLOCK))
        got = ls_planes_pallas(CFG, tx, block_samples=BLOCK).numpy()
        assert got.shape == (S, CFG.num_tx, CFG.num_carriers)
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
        return
    dt, jdt = ((torch.float32, jnp.float32) if form == "raw_f32"
               else (torch.bfloat16, jnp.bfloat16))
    jhr, jhi = j_ls_planes_pallas(JCFG, jx, block_samples=BLOCK, raw=True,
                                  out_dtype=jdt)
    hr, hi = ls_planes_pallas(CFG, tx, block_samples=BLOCK, raw=True,
                              out_dtype=dt)
    rows = 12 * CFG.num_tx
    for got, ref in ((hr, jhr), (hi, jhi)):
        assert got.dtype == dt
        assert tuple(got.shape) == tuple(ref.shape) == (rows, 256)
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=0 if dt == torch.float32 else BF16_STEP,
                                   atol=2e-4)
    _assert_raw_pads_zero(hr, hi, S, CFG.num_tx, CFG.num_carriers)


def test_raw_to_complex_matches_jax():
    """The port's densifier on the JAX kernel's raw output equals JAX's."""
    jhr, jhi = j_ls_planes_pallas(JCFG, jnp.asarray(_planes(4)),
                                  block_samples=BLOCK, raw=True)
    ref = np.asarray(j_raw_to_complex(JCFG, jhr, jhi, S))
    got = ls_raw_to_complex(CFG, torch.from_numpy(np.array(jhr)),
                            torch.from_numpy(np.array(jhi)), S).numpy()
    np.testing.assert_array_equal(got, ref)


def _fwht_rows(z, nt):
    """Walsh–Hadamard butterflies along groups of nt rows, in the order
    the kernel loops them."""
    z = z.reshape(-1, nt, z.shape[-1]).copy()
    h = 1
    while h < nt:
        for i in range(nt // 2):
            lo = (i // h) * 2 * h + i % h
            a, b = z[:, lo].copy(), z[:, lo + h].copy()
            z[:, lo], z[:, lo + h] = a + b, a - b
        h *= 2
    return z


@pytest.mark.parametrize("cfg,block", [(CFG, 4), (SimConfig(), 8)])
def test_ls_v1_kernel_layout(cfg, block):
    """The CUDA kernel's formulation in float64 numpy: [xr | xi] over the
    fft samples @ ls_kernel_constants (bf16), butterflies along each
    sample's num_tx rows, every sample of the padded row range stored at
    row s·num_tx + j, lane c of hr (columns < Cp) or hi (columns >= Cp).
    Held to the plain version within the bf16 DFT matrix's rounding
    (about −58 dB), with exactly zero pads."""
    s, nt = 5, cfg.num_tx
    x = np.random.default_rng(8).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)
    b = ls_kernel_constants(cfg).float().numpy().astype(np.float64)
    cp_ = b.shape[1] // 2
    s_out = -(-s // block) * block
    rows = np.zeros((2, s_out * nt, cfg.fft_length))
    rows[:, :s * nt] = x.reshape(2, s * nt, cfg.sym_len)[:, :, cfg.cp_length:]
    h = _fwht_rows(np.concatenate([rows[0], rows[1]], axis=1) @ b, nt)
    h = h.reshape(s_out * nt, 2 * cp_)
    hr, hi = h[:, :cp_], h[:, cp_:]
    _assert_raw_pads_zero(torch.from_numpy(hr), torch.from_numpy(hi), s, nt,
                          cfg.num_carriers)

    want = ls_planes_v1(cfg, torch.from_numpy(x), block_samples=block)
    got = np.stack([hr, hi])
    want = torch.stack(want).double().numpy()
    assert got.shape == want.shape
    nmse = np.sum((got - want) ** 2) / np.sum(want ** 2)
    assert 10 * np.log10(nmse) < -50.0


def test_ls_v1_refuses_bad_arguments():
    """Only float32 and bfloat16 outputs exist; a tensor that is not on
    the CPU never reaches the plain version."""
    x = torch.zeros((2, 3, CFG.len_ltf))
    with pytest.raises(TypeError, match="out_dtype"):
        ls_planes_v1(CFG, x, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="cuda or all on cpu"):
        ls_planes_v1(CFG, torch.empty((2, 3, CFG.len_ltf), device="meta"))
