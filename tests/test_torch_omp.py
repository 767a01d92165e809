"""The port's OMP hybrid beamforming (mamimo_tpu_torch.ops.omp) against
the JAX package's ``ops/omp.py`` on JAX's channels at
tests/test_closed_loop.py's CL_CFG size (Nt 8, Nr 2, 64-ray steering
dictionary).

Singular vectors carry an arbitrary phase, so the digital weights fbb
(and coeff) are compared after one phase per carrier (per stream) is
taken out; the atom indices and the RF weights frf are phase-free and
compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cl_jax import CL_KW, phase_aligned_rel, rel
from mamimo_tpu.channel.scattering import make_scenario as j_make_scenario
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import omp as jo
from mamimo_tpu.pipeline.datatx import steering_dictionary as j_dict
from mamimo_tpu.pipeline.sounding import sound_packet as j_sound
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops import omp as po
from mamimo_tpu_torch.pipeline.datatx import steering_dictionary


@pytest.fixture(scope="module")
def chans():
    """JAX's perfect CSI of 2 packets (C, Nt, Nr) and JAX's dictionaries
    (Nt, n_rays) for them."""
    jcfg = JSimConfig(**CL_KW)
    scen = j_make_scenario(jcfg, jax.random.PRNGKey(5))
    sound = jax.jit(lambda k: j_sound(jcfg, k, scen, 20.0, fft_size=8192))
    h, at, rays = [], [], []
    for i in range(2):
        res, _ = sound(jax.random.PRNGKey(10 + i))
        h.append(np.asarray(res.h_perfect))
        k = jax.random.PRNGKey(30 + i)
        at.append(np.asarray(j_dict(jcfg, k)))
        k1, k2 = jax.random.split(k)
        rays.append((np.asarray(jax.random.uniform(
            k1, (jcfg.n_rays,), minval=-180.0, maxval=180.0)),
            np.asarray(jax.random.uniform(
                k2, (jcfg.n_rays,), minval=-90.0, maxval=90.0))))
    return np.stack(h), np.stack(at), rays


def test_steering_dictionary_matches_jax(chans):
    _, at, rays = chans
    cfg = SimConfig(**CL_KW)
    az = torch.tensor(np.stack([r[0] for r in rays]))
    el = torch.tensor(np.stack([r[1] for r in rays]))
    got = steering_dictionary(cfg, az, el)
    assert tuple(got.shape) == (2, cfg.num_tx, cfg.n_rays)
    assert rel(got.numpy(), at) < 1e-6


@pytest.mark.parametrize("nw,s_max", [(1, 1), (1, 3), (2, 2)])
def test_omp_decomp_matches_jax(nw, s_max):
    rng = np.random.default_rng(nw * 10 + s_max)

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    wopt, adict = cn(5, 8, nw), cn(8, 40)
    got = po.omp_decomp(torch.tensor(wopt), torch.tensor(adict), s_max)
    fn = jax.jit(lambda w: jo.omp_decomp(w, jnp.asarray(adict), s_max))
    for b in range(5):
        want = fn(jnp.asarray(wopt[b]))
        np.testing.assert_array_equal(got.atom_idx[b].numpy(),
                                      np.asarray(want.atom_idx))
        np.testing.assert_array_equal(got.atoms[b].numpy(),
                                      np.asarray(want.atoms))
        assert rel(got.coeff[b].numpy(), want.coeff) < 1e-5
        assert abs(float(got.err_norm[b]) - float(want.err_norm)) < 1e-5


def test_omp_decomp_weighted_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    w = (a @ a.conj().T + np.eye(4)).astype(np.complex64)
    wopt = (rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
            ).astype(np.complex64)
    adict = (rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
             ).astype(np.complex64)
    got = po.omp_decomp(torch.tensor(wopt), torch.tensor(adict), 2,
                        norm_weight=torch.tensor(w))
    want = jax.jit(lambda x: jo.omp_decomp(x, adict, 2, norm_weight=w))(wopt)
    np.testing.assert_array_equal(got.atom_idx.numpy(),
                                  np.asarray(want.atom_idx))
    assert rel(got.coeff.numpy(), want.coeff) < 1e-5


@pytest.mark.parametrize("ns", [1, 2])
def test_omp_hyb_weights_match_jax(chans, ns):
    """Both packets as one batch, each with its own dictionary, against
    JAX per packet: frf exactly (atoms of the same dictionary), fbb and
    frf·fbb to 1e-5 up to one phase per carrier and stream."""
    h, at, _ = chans
    fbb, frf = po.omp_hyb_weights(torch.tensor(h), ns, ns, torch.tensor(at))
    fn = jax.jit(lambda x, a: jo.omp_hyb_weights(x, ns, ns, a))
    for b in range(2):
        w_fbb, w_frf = (np.asarray(x) for x in fn(jnp.asarray(h[b]),
                                                  jnp.asarray(at[b])))
        np.testing.assert_array_equal(frf[b].numpy(), w_frf)
        # fbb (C, ns, ntrf): row s of carrier c has one phase
        assert phase_aligned_rel(fbb[b].numpy(), w_fbb, axes=(-1,)) < 1e-5
        prod = np.einsum("csj,cjn->csn", fbb[b].numpy(), frf[b].numpy())
        w_prod = np.einsum("csj,cjn->csn", w_fbb, w_frf)
        assert phase_aligned_rel(prod, w_prod, axes=(-1,)) < 1e-5


def test_omp_hyb_combining_matches_jax(chans):
    h, at, _ = chans
    cfg = SimConfig(**CL_KW)
    from mamimo_tpu_torch.channel.scattering import (
        steering_vectors,
        ula_positions,
    )

    rng = np.random.default_rng(9)
    ar = steering_vectors(ula_positions(cfg.num_rx, 0.5),
                          torch.tensor(rng.uniform(-180, 180, 16),
                                       dtype=torch.float32),
                          torch.zeros(16)).numpy()
    got = po.omp_hyb_combining(torch.tensor(h[0]), 1, 1,
                               torch.tensor(at[0]), 1, torch.tensor(ar),
                               npow=0.1)
    want = [np.asarray(x) for x in jax.jit(
        lambda x: jo.omp_hyb_combining(x, 1, 1, at[0], 1, ar, npow=0.1))(
            jnp.asarray(h[0]))]
    np.testing.assert_array_equal(got[1].numpy(), want[1])      # frf
    np.testing.assert_array_equal(got[3].numpy(), want[3])      # wrf
    assert phase_aligned_rel(got[0].numpy(), want[0], axes=(-1,)) < 1e-5
    # the combiner's weights carry the precoder's phase, conjugated
    assert phase_aligned_rel(got[2].numpy(), want[2], axes=(-2,)) < 1e-5
