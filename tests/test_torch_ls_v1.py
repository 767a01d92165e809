"""The port's v1 flat-planes LS (mamimo_tpu_torch.ops.kernels.fused_ls::
ls_planes_pallas / ls_planes_v1) against the JAX package's
ls_planes_pallas in interpret mode.

Inputs are made with numpy and handed to both packages. The CUDA kernel
(csrc/ls_v1.cu) runs only on the card (chip_smoke.py); here the wrapper's
CPU path (the kernel's plain version) is held to the JAX kernel, at the
Hopper body's tile edges too (one sample, odd S, one sample a block,
num_tx 8 and 32); the layout the CUDA kernel writes — the GEMM and
Walsh–Hadamard body of csrc/ls_sm90.cuh against the permuted constants
of ls_sm90_constants, block q's two accumulator sets stored as lanes
64q .. 64q + 63 of the padded (hr, hi) rows — is rebuilt in float64
numpy and held to the plain version; and the wrapper's CUDA branch (its
device test made to answer CUDA, the launch cut off before any build)
is held to the constants it takes. Tolerances: atol 2e-4 against JAX
in float32 (sums over a few thousand terms on both sides), plus one
bf16 rounding step relative for bf16 storage.
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
from mamimo_tpu_torch.ops.kernels import fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    LsSm90Constants,
    ls_kernel_constants,
    ls_planes_pallas,
    ls_planes_pallas_constants,
    ls_planes_v1,
    ls_raw_to_complex,
    ls_sm90_constants,
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
    fft samples of every sample of the padded range (zeros past S, as the
    map's zero fill gives them) against the permuted Bᵀ of
    ls_sm90_constants (bf16), butterflies along each sample's num_tx
    rows, and block q's sets — rows 128q .. 128q + 63 (real) and
    128q + 64 .. 128q + 127 (imaginary) of Bᵀ — stored as lanes
    64q .. 64q + 63 of hr and hi at row s·num_tx + j. Held to the plain
    version within the bf16 DFT matrix's rounding (about −58 dB), with
    exactly zero pads."""
    s, nt = 5, cfg.num_tx
    x = np.random.default_rng(8).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)
    bt = ls_sm90_constants(cfg).bt.float().numpy().astype(np.float64)
    cp_ = bt.shape[0] // 2
    s_out = -(-s // block) * block
    rows = np.zeros((2, s_out * nt, cfg.fft_length))
    rows[:, :s * nt] = x.reshape(2, s * nt, cfg.sym_len)[:, :, cfg.cp_length:]
    z = _fwht_rows(np.concatenate([rows[0], rows[1]], axis=1) @ bt.T, nt)
    z = z.reshape(s_out * nt, 2 * cp_)
    hr, hi = np.zeros((s_out * nt, cp_)), np.zeros((s_out * nt, cp_))
    for q in range(2 * cp_ // 128):
        hr[:, 64 * q:64 * q + 64] = z[:, 128 * q:128 * q + 64]
        hi[:, 64 * q:64 * q + 64] = z[:, 128 * q + 64:128 * q + 128]
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


EDGE_CFGS = {8: (CFG, JCFG), 32: (SimConfig(), JSimConfig())}


@pytest.mark.parametrize("form", ["complex", "raw_f32", "raw_bf16"])
@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("nt", [8, 32])
@pytest.mark.parametrize("s", [1, 3, 17])
def test_plain_matches_jax_at_tile_edges(s, nt, block, form):
    """The plain version against JAX's kernel in interpret mode where the
    Hopper body's tiles end (128/num_tx samples a tile: 16 at num_tx 8, 4
    at 32): one sample, S = 3 and 17 (the last tile partly past them),
    and pad rows up to block_samples (none at 1). Pads exactly zero."""
    cfg, jcfg = EDGE_CFGS[nt]
    x = np.random.default_rng(100 + s + nt + block).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if form == "complex":
        ref = np.asarray(j_ls_planes_pallas(jcfg, jx, block_samples=block))
        got = ls_planes_pallas(cfg, tx, block_samples=block).numpy()
        assert got.shape == (s, nt, cfg.num_carriers)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
        return
    dt, jdt = ((torch.float32, jnp.float32) if form == "raw_f32"
               else (torch.bfloat16, jnp.bfloat16))
    jhr, jhi = j_ls_planes_pallas(jcfg, jx, block_samples=block, raw=True,
                                  out_dtype=jdt)
    hr, hi = ls_planes_pallas(cfg, tx, block_samples=block, raw=True,
                              out_dtype=dt)
    rows = -(-s // block) * block * nt
    for got, ref in ((hr, jhr), (hi, jhi)):
        assert got.dtype == dt and tuple(got.shape) == (rows, 256)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
            rtol=0 if dt == torch.float32 else BF16_STEP, atol=2e-4)
    _assert_raw_pads_zero(hr, hi, s, nt, cfg.num_carriers)


class _Stop(Exception):
    pass


def _kernel_branch(monkeypatch):
    """Make the wrapper's device test answer CUDA and stop at the build of
    any kernel library, so the CUDA branch runs up to the launch."""
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)

    def no_build(name, defines=()):
        raise _Stop(name)

    monkeypatch.setattr(fused_ls._build, "library", no_build)


@pytest.mark.parametrize("call", ["v1", "pallas"])
def test_kernel_branch_refuses_ls_kernel_constants(monkeypatch, call):
    """On the card v1 takes only LsSm90Constants: the (2·fft, 2·Cp)
    matrix of ls_kernel_constants is refused before any launch."""
    _kernel_branch(monkeypatch)
    x = torch.from_numpy(_planes()).to(torch.bfloat16)
    fn = ls_planes_v1 if call == "v1" else ls_planes_pallas
    with pytest.raises(TypeError, match="ls_sm90_constants"):
        fn(CFG, x, ls_kernel_constants(CFG))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_branch_builds_sm90_constants(monkeypatch, out_dtype):
    """Without constants the CUDA branch builds ls_sm90_constants and
    reaches the launch of the ls_v1 library (cut off here at its build);
    given them, it reaches the same launch."""
    _kernel_branch(monkeypatch)
    built = []
    real = fused_ls.ls_sm90_constants

    def spy(cfg, device=None, dtype=torch.bfloat16):
        built.append(device)
        return real(cfg, device, dtype)

    monkeypatch.setattr(fused_ls, "ls_sm90_constants", spy)
    x = torch.from_numpy(_planes()).to(torch.bfloat16)
    with pytest.raises(_Stop, match="ls_v1"):
        ls_planes_v1(CFG, x, out_dtype=out_dtype)
    assert len(built) == 1
    with pytest.raises(_Stop, match="ls_v1"):
        ls_planes_v1(CFG, x, real(CFG), out_dtype=out_dtype)
    assert len(built) == 1
    with pytest.raises(ValueError, match=r"\(512, 256\)"):
        ls_planes_v1(CFG, x, LsSm90Constants(torch.zeros(
            (512, 256), dtype=torch.bfloat16)))


def test_kernel_branch_empty_batch_counts_no_launch(monkeypatch):
    """S = 0: empty (hr, hi), no library built, no launch counted."""
    _kernel_branch(monkeypatch)
    before = ls_planes_v1.launches
    hr, hi = ls_planes_v1(CFG, torch.empty((2, 0, CFG.len_ltf),
                                           dtype=torch.bfloat16))
    assert tuple(hr.shape) == tuple(hi.shape) == (0, 256)
    assert ls_planes_v1.launches == before
