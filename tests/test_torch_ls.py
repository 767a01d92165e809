"""The port's LTF/Hadamard/DFT constants and LS estimate against the JAX
package (mamimo_tpu_torch.ops.ltf / ops.estimate / ops.kernels.fused_ls).

Inputs are made with numpy and handed to both packages. The CUDA kernel
itself runs only on the card (chip_smoke.py); here its algebra — the
real DFT-select matrix and the Walsh–Hadamard despread that replaces the
I⊗P matmul — is checked in float64 numpy, and its wrapper's CPU path
(the plain version) against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import estimate as jest
from mamimo_tpu.ops import ltf as jltf
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_planes_pallas_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu_torch.config import SimConfig, carrier_bins
from mamimo_tpu_torch.ops import estimate as pest
from mamimo_tpu_torch.ops import ltf as tltf
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_kernel_constants,
    ls_planes_pallas_v2_constants,
    ls_planes_v2,
    ls_v2_to_complex,
)

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)


def _planes(s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, CFG.len_ltf)).astype(np.float32)


def test_config_matches_reference():
    for c, j in ((SimConfig(), JSimConfig()), (CFG, JCFG)):
        assert c.to_json() == j.to_json()
        assert c.carrier_locations == j.carrier_locations
        assert (c.len_ltf, c.sym_len, c.used_sc) == (j.len_ltf, j.sym_len,
                                                     j.used_sc)
    from mamimo_tpu.config import carrier_bins as j_bins
    np.testing.assert_array_equal(carrier_bins(CFG), j_bins(JCFG))


@pytest.mark.parametrize("n", [1, 2, 8, 32])
def test_hadamard_and_ltf_equal_reference(n):
    np.testing.assert_array_equal(tltf.hadamard(n), jltf.hadamard(n))
    np.testing.assert_array_equal(tltf.pilot_p_matrix(n).numpy(),
                                  np.asarray(jltf.pilot_p_matrix(n)))
    np.testing.assert_array_equal(tltf.ltf_sequence(CFG).numpy(),
                                  np.asarray(jltf.ltf_sequence(JCFG)))
    np.testing.assert_array_equal(tltf.ltf_data_carriers(CFG).numpy(),
                                  np.asarray(jltf.ltf_data_carriers(JCFG)))
    assert tltf.preamble_scale(CFG, n) == jltf.preamble_scale(JCFG, n)


@pytest.mark.parametrize("cfg,jcfg", [(CFG, JCFG), (SimConfig(), JSimConfig())])
def test_dft_and_preamble_equal_reference(cfg, jcfg):
    np.testing.assert_array_equal(pest.dft_selected_np(cfg),
                                  jest.dft_selected_np(jcfg))
    np.testing.assert_array_equal(pest.dft_selected_padded_np(cfg),
                                  jest.dft_selected_padded_np(jcfg))
    for t, j in zip(pest.ls_planes_constants(cfg),
                    jest.ls_planes_constants(jcfg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(ls_planes_pallas_v2_constants(cfg, 4),
                    j_v2_constants(jcfg, 4)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tltf.gen_preamble(cfg),
                                  jltf.gen_preamble(jcfg))


@pytest.mark.parametrize("s", [11, 4])
def test_ls_estimate_planes_matches_jax(s):
    """Plain LS and the wrapper's CPU path against JAX ls_estimate_planes
    and the JAX v2 kernel (interpret mode) densified by ls_v2_to_complex;
    odd S exercises the kernel's row padding."""
    x = _planes(s, seed=s)
    ref = np.asarray(jest.ls_estimate_planes(JCFG, jnp.asarray(x)))
    got = pest.ls_estimate_planes(CFG, torch.from_numpy(x)).numpy()
    assert got.shape == (s, CFG.num_tx, CFG.num_carriers)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)

    h, _ = ls_planes_pallas_v2(JCFG, jnp.asarray(x), block_samples=4)
    kern = np.asarray(j_v2_to_complex(JCFG, h, s))
    np.testing.assert_allclose(got, kern, rtol=0, atol=2e-4)
    # the port's densifier on the TPU kernel's raw (rows, 2·Cp) output
    dense = ls_v2_to_complex(CFG, torch.from_numpy(np.array(h)), s).numpy()
    np.testing.assert_array_equal(dense, kern)

    planes2 = ls_planes_v2(CFG, torch.from_numpy(x)).numpy()
    assert planes2.shape == (2, s, CFG.num_tx, CFG.num_carriers)
    np.testing.assert_allclose(planes2[0] + 1j * planes2[1], ref, rtol=0,
                               atol=2e-4)


def _fwht_rows(z, nt):
    """In-order Walsh–Hadamard butterflies along groups of nt rows — the
    LS kernel's despread, written as the kernel loops it."""
    z = z.reshape(-1, nt, z.shape[-1]).copy()
    h = 1
    while h < nt:
        for i in range(nt // 2):
            lo = (i // h) * 2 * h + i % h
            a, b = z[:, lo].copy(), z[:, lo + h].copy()
            z[:, lo], z[:, lo + h] = a + b, a - b
        h *= 2
    return z


@pytest.mark.parametrize("cfg", [CFG, SimConfig()])
def test_ls_kernel_algebra(cfg):
    """The CUDA kernel's formulation in float64 numpy: [xr | xi] over the
    fft samples (CP skipped by address) @ ls_kernel_constants, then the
    Walsh–Hadamard butterflies along each sample's num_tx rows, equals
    the plain LS."""
    s, nt = 3, cfg.num_tx
    x = np.random.default_rng(7).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)
    b = ls_kernel_constants(cfg).float().numpy().astype(np.float64)
    rows = x.reshape(2, s * nt, cfg.sym_len)[:, :, cfg.cp_length:]
    a = np.concatenate([rows[0], rows[1]], axis=1).astype(np.float64)
    h = _fwht_rows(a @ b, nt)                      # (s, nt, 2·Cp)
    cp_ = b.shape[1] // 2
    c = cfg.num_carriers
    got = h[..., :c] + 1j * h[..., cp_:cp_ + c]
    # the kernel's DFT matrix is bf16: hold it against the plain LS run
    # on the same bf16-rounded DFT constants
    at_r, at_i, p = pest.ls_planes_constants(cfg, dtype=torch.bfloat16)
    ref = pest.ls_estimate_planes(
        cfg, torch.from_numpy(x),
        (at_r.float(), at_i.float(), p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("bad", [lambda: tltf.hadamard(12),
                                 lambda: tltf.ltf_sequence(
                                     SimConfig(fft_length=128))])
def test_unsupported_configs_raise(bad):
    """A config from outside (a checkpoint's JSON) that the LTF tables do
    not cover is refused with ValueError, not an assert."""
    with pytest.raises(ValueError):
        bad()


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU never reaches the plain version:
    a wrapper launches its kernel (CUDA) or raises."""
    x = torch.empty((2, 3, CFG.len_ltf), device="meta")
    with pytest.raises(ValueError, match="cuda or all on cpu"):
        ls_planes_v2(CFG, x)
