"""The port's LMMSE estimators (mamimo_tpu_torch.ops.estimate) against
the JAX package's on the same numpy inputs, and against the float64
oracle of tests/golden/reference_semantics.npz.

Every form is held to its JAX counterpart at 2e-4 of the estimate's
scale (the oracle bound of tests/test_reference_oracles.py: the solves
are float32 at condition numbers up to about 1e3 at 20 dB), and the CG
form to the dense solve within the bounds of tests/test_lmmse_metrics.py.
C is 234 whatever Nt is; the inputs are those of test_lmmse_metrics.py's
CG tests (3 packets, 100 delays, 2 streams, 4 antennas).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import estimate as je
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops import estimate as pe
from mamimo_tpu_torch.utils.numerics import matmul_precision

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG, JCFG = SimConfig(**KW), JSimConfig(**KW)
FIX = os.path.join(os.path.dirname(__file__), "golden",
                   "reference_semantics.npz")
C = CFG.num_carriers


def _inputs():
    rng = np.random.default_rng(5)
    tau = rng.uniform(1e-6, 4e-6, (3, 100)).astype(np.float32)
    h = (rng.standard_normal((3, C, 2, 4))
         + 1j * rng.standard_normal((3, C, 2, 4))).astype(np.complex64)
    mixed = rng.uniform(-25.0, 15.0, (3, 4)).astype(np.float32)
    return h, tau, mixed


H, TAU, MIXED = _inputs()


def _snr(snr_db):
    return MIXED if snr_db == "mixed" else np.full((3, 4), snr_db, np.float32)


def _port(fn, snr, *a, **kw):
    return fn(CFG, torch.tensor(H), torch.tensor(TAU), torch.tensor(snr),
              *a, **kw).numpy()


def _jax(fn, snr, *a, **kw):
    return np.asarray(fn(JCFG, jnp.asarray(H), jnp.asarray(TAU),
                         jnp.asarray(snr), *a, **kw))


FORMS = {"dense": (pe.lmmse_estimate, je.lmmse_estimate),
         "direct": (pe.lmmse_estimate_direct, je.lmmse_estimate_direct),
         "eig": (pe.lmmse_estimate_eig, je.lmmse_estimate_eig),
         "cg": (pe.lmmse_estimate_cg, je.lmmse_estimate_cg)}


@pytest.mark.parametrize("snr_db", [-25.0, 0.0, 20.0, "mixed"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_lmmse_form_matches_jax(form, snr_db):
    p, j = FORMS[form]
    s = _snr(snr_db)
    got, want = _port(p, s), _jax(j, s)
    assert got.shape == want.shape == H.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_lmmse_chunked_matches_jax_and_equals_dense():
    """The chunked form (2 packets a chunk over 3) is the dense form."""
    s = _snr("mixed")
    got = _port(pe.lmmse_estimate_chunked, s, chunk=2)
    want = _jax(je.lmmse_estimate_chunked, s, chunk=2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, _port(pe.lmmse_estimate, s), rtol=0,
                               atol=1e-6 * np.abs(got).max())


@pytest.mark.parametrize("which", ["small", "big"])
def test_lmmse_weight_matches_reference_oracle(which):
    """LMMSE_ce.m:23-39 in float64, with the delays-as-h quirk, at the
    pipeline's delay scale and a strongly correlated one."""
    g = np.load(FIX)
    m = pe.lmmse_weight(SimConfig(num_tx=8, num_rx=2),
                        torch.tensor(g[f"lmmse_tau_{which}"],
                                     dtype=torch.float32),
                        torch.tensor(float(g["lmmse_snr_db"]))).numpy()
    got = m @ g["lmmse_h_tilde"].astype(np.complex64)
    ref = g[f"lmmse_out_{which}"]
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("snr_db,atol", [(-25.0, 2e-3), (0.0, 2e-3),
                                         (20.0, 2e-3), ("mixed", 2e-4)])
def test_lmmse_cg_matches_the_dense_solve(snr_db, atol):
    """test_lmmse_metrics.py::test_lmmse_cg_matches_solve's bounds."""
    s = _snr(snr_db)
    np.testing.assert_allclose(_port(pe.lmmse_estimate_cg, s),
                               _port(pe.lmmse_estimate, s), rtol=0, atol=atol)


@pytest.mark.parametrize("snr_db,atol", [(30.0, 2e-3), (40.0, 8e-3),
                                         (120.0, 3e-3)])
def test_lmmse_cg_high_snr(snr_db, atol):
    """test_lmmse_metrics.py::test_lmmse_cg_high_snr's bounds against the
    direct solve (the near-noiseless regime of label generation)."""
    s = _snr(snr_db)
    got = _port(pe.lmmse_estimate_cg, s)
    assert np.abs(got - _port(pe.lmmse_estimate_direct, s)).max() < atol


def test_lmmse_eig_against_the_solve_by_the_estimate():
    """Eigenvectors are not unique (phases, degenerate bases), so the
    eigenbasis form is held to the solve by its estimate, and by its
    eigenvalues (ascending) against float64; one factorization serves
    another SNR."""
    s = _snr("mixed")
    ref = _port(pe.lmmse_estimate, s)
    np.testing.assert_allclose(_port(pe.lmmse_estimate_eig, s), ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    u, lam = pe.lmmse_eig_factor(CFG, torch.tensor(TAU))
    rf = pe.lmmse_rf(CFG, torch.tensor(TAU)).numpy().astype(np.complex128)
    lam64 = np.linalg.eigvalsh(rf)
    np.testing.assert_allclose(lam.numpy(), lam64, rtol=0,
                               atol=1e-5 * np.abs(lam64).max())
    s2 = s + 10.0
    got = pe.lmmse_estimate_eig(CFG, torch.tensor(H), snr_db=torch.tensor(s2),
                                factors=(u, lam)).numpy()
    ref2 = _port(pe.lmmse_estimate, s2)
    np.testing.assert_allclose(got, ref2, rtol=0,
                               atol=2e-4 * np.abs(ref2).max())


def test_lmmse_rf_and_generator_match_jax():
    """The correlation matrix, its Toeplitz generator and τ_rms."""
    t = torch.tensor(TAU)
    np.testing.assert_allclose(pe.lmmse_tau_rms(t).numpy(),
                               np.asarray(je.lmmse_tau_rms(jnp.asarray(TAU))),
                               rtol=1e-5)
    rf = pe.lmmse_rf(CFG, t).numpy()
    np.testing.assert_allclose(rf, np.asarray(je.lmmse_rf(
        JCFG, jnp.asarray(TAU))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pe._lmmse_generator(CFG, t).numpy(),
                               rf[:, :, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,tf32", [("highest", False), ("HIGH", True),
                                       ("default", True), (None, False)])
def test_matmul_precision_names(name, tf32):
    """JAX's precision names: 'highest' (and None) is full float32, 'high'
    and 'default' TF32 on the card; the caller's setting comes back."""
    before = torch.backends.cuda.matmul.allow_tf32
    with matmul_precision(name):
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is before


def test_lmmse_cg_precision_options():
    """On the CPU every name computes float32, so the options give the
    CG's default estimate; an unknown name raises."""
    s = _snr(0.0)
    ref = _port(pe.lmmse_estimate_cg, s)
    for mv, pc in (("highest", "default"), ("high", None), (None, "high")):
        np.testing.assert_array_equal(
            _port(pe.lmmse_estimate_cg, s, matvec_precision=mv,
                  precond_precision=pc), ref)
    with pytest.raises(ValueError, match="precision"):
        _port(pe.lmmse_estimate_cg, s, matvec_precision="fastest")
    with pytest.raises(ValueError, match="embed"):
        _port(pe.lmmse_estimate_cg, s, embed=256)


def test_lmmse_solves_after_set_num_threads():
    """The dense and direct forms return on the CPU in a process that has
    called torch.set_num_threads (the bench's CPU yardstick does):
    PyTorch's batched CPU LU never returns there."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch; torch.set_num_threads(torch.get_num_threads()); "
        "from mamimo_tpu_torch.config import SimConfig; "
        "from mamimo_tpu_torch.ops import estimate as pe; "
        "cfg = SimConfig(num_tx=8, num_rx=2); "
        "h = torch.randn(2, 234, 4, 2, dtype=torch.complex64); "
        "tau = 1.4e-6 + 3e-7 * torch.rand(2, 20); "
        "s = torch.zeros(2, 2); "
        "[f(cfg, h, tau, s) for f in (pe.lmmse_estimate, "
        "pe.lmmse_estimate_direct, pe.lmmse_estimate_chunked)]; "
        "print('solved')")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "solved" in r.stdout, r.stderr[-2000:]
