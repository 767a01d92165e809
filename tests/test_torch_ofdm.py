"""The port's OFDM and the LS forms that sit on it against the JAX package
(mamimo_tpu_torch.ops.ofdm; ops.estimate's ls_estimate, the FFT form,
ls_estimate_rxmajor and ls_matmul_constants(padded=True)), on the same
numpy inputs at Nt 8, Nr 2, and the FFT-form LS against the float64
oracle of tests/golden/reference_semantics.npz."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import estimate as je
from mamimo_tpu.ops import ofdm as jo
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops import estimate as pe
from mamimo_tpu_torch.ops import ofdm as po

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG, JCFG = SimConfig(**KW), JSimConfig(**KW)
FIX = os.path.join(os.path.dirname(__file__), "golden",
                   "reference_semantics.npz")


def _cn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _nmse_db(a, b):
    return 10 * np.log10(_rel(a, b) ** 2)


@pytest.mark.parametrize("with_pilots", [False, True])
def test_grid_and_modulation_match_jax(with_pilots):
    """build_grid and ofdm_modulate with a leading batch axis, and
    ofdm_demodulate of the result (data and pilot grids)."""
    rng = np.random.default_rng(0)
    data = _cn(rng, (3, CFG.num_carriers, 4, 2))
    pil = _cn(rng, (3, len(CFG.pilot_indices), 4, 2)) if with_pilots else None
    tp = None if pil is None else torch.tensor(pil)
    jp = None if pil is None else jnp.asarray(pil)
    np.testing.assert_array_equal(
        po.build_grid(CFG, torch.tensor(data), tp).numpy(),
        np.asarray(jo.build_grid(JCFG, jnp.asarray(data), jp)))
    sig = po.ofdm_modulate(CFG, torch.tensor(data), tp)
    jsig = jo.ofdm_modulate(JCFG, jnp.asarray(data), jp)
    assert tuple(sig.shape) == (3, 4 * CFG.sym_len, 2)
    assert _rel(sig.numpy(), jsig) < 1e-6
    # the pilot grid is rounding noise without pilots: hold both grids
    # to the data's scale
    for got, want in zip(po.ofdm_demodulate(CFG, sig),
                         jo.ofdm_demodulate(JCFG, jsig)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(data).max())


def test_ofdm_round_trip():
    """demod(mod(x)) == x over two leading dims, pilots included; the
    symbol count is inferred from the length."""
    rng = np.random.default_rng(1)
    data = torch.tensor(_cn(rng, (2, 3, CFG.num_carriers, 5, 2)))
    pil = torch.tensor(_cn(rng, (2, 3, len(CFG.pilot_indices), 5, 2)))
    d, p = po.ofdm_demodulate(CFG, po.ofdm_modulate(CFG, data, pil))
    assert _rel(d.numpy(), data.numpy()) < 1e-6
    assert _rel(p.numpy(), pil.numpy()) < 1e-6


def test_ls_estimate_matches_jax():
    """The FFT-form despread on a batched grid with extra symbols."""
    rng = np.random.default_rng(2)
    grid = _cn(rng, (3, CFG.num_carriers, CFG.num_tx + 2, CFG.num_rx))
    got = pe.ls_estimate(CFG, torch.tensor(grid))
    want = je.ls_estimate(JCFG, jnp.asarray(grid))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_ls_estimate_matches_reference_oracle():
    """The float64 transliteration of helperMIMOChannelEstimate.m:24-41
    (the bound of tests/test_reference_oracles.py)."""
    g = np.load(FIX)
    cfg = SimConfig(num_tx=8, num_rx=2)
    got = pe.ls_estimate(cfg, torch.tensor(g["ls_rx_grid"].astype(
        np.complex64)))
    np.testing.assert_allclose(got.numpy(), g["ls_out"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("padded", [False, True])
def test_ls_matmul_constants_match_jax(padded):
    a, p = pe.ls_matmul_constants(CFG, padded=padded)
    ja, jp = je.ls_matmul_constants(JCFG, padded=padded)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert a.shape == (CFG.num_carriers,
                       CFG.sym_len if padded else CFG.fft_length)
    ra, _ = pe.ls_matmul_constants_rxmajor(CFG)
    np.testing.assert_array_equal(ra.numpy(), np.asarray(
        je.ls_matmul_constants_rxmajor(JCFG)[0]))


def test_ls_estimate_rxmajor_matches_jax():
    rng = np.random.default_rng(3)
    rx = _cn(rng, (3, CFG.num_rx, CFG.len_ltf))
    got = pe.ls_estimate_rxmajor(CFG, torch.tensor(rx))
    want = je.ls_estimate_rxmajor(JCFG, jnp.asarray(rx))
    assert got.shape == want.shape == (3, CFG.num_rx, CFG.num_tx,
                                       CFG.num_carriers)
    assert _rel(got.numpy(), want) < 1e-6


def test_ls_fft_form_equals_the_matmul_forms():
    """ls_estimate(ofdm_demodulate(rx)) is the math of ls_estimate_matmul
    and ls_estimate_rxmajor: within -100 dB."""
    rng = np.random.default_rng(4)
    rx = torch.tensor(_cn(rng, (4, CFG.len_ltf, CFG.num_rx)))
    grid, _ = po.ofdm_demodulate(CFG, rx, nsym=CFG.num_tx)
    fft_form = pe.ls_estimate(CFG, grid)
    mm = pe.ls_estimate_matmul(CFG, rx)
    rxm = pe.ls_estimate_rxmajor(CFG, rx.transpose(1, 2).contiguous())
    assert _nmse_db(fft_form.numpy(), mm.numpy()) < -100.0
    assert _nmse_db(rxm.permute(0, 3, 2, 1).numpy(), mm.numpy()) < -100.0
