"""The port's scattering channel against the JAX package
(mamimo_tpu_torch.channel.scattering, utils.numerics, config, the
pipeline's pad_signal).

The two packages draw different random numbers for one seed, so the
JAX package's draws (jax.random on its own keys) are fed to the port's
realization math; signals are made with numpy and handed to both. The
carrier phase of a path, unit_phasor(−d/λ) in float32, agrees only to a
few float32 ulps of d (one ulp of a 1 km path is 0.006 cycles), so the
phase of ``cr`` is held to that and its amplitude, the delays and the
channel delay tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.channel import scattering as js
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import default_fft_size as j_fft_size
from mamimo_tpu.ops.ltf import gen_preamble
from mamimo_tpu.pipeline.sounding import pad_signal as j_pad_signal
from mamimo_tpu.utils.numerics import unit_phasor as j_unit_phasor
from mamimo_tpu_torch.channel import scattering as ps
from mamimo_tpu_torch.config import SimConfig, default_fft_size
from mamimo_tpu_torch.pipeline.sounding import pad_signal
from mamimo_tpu_torch.utils.numerics import unit_phasor

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG, JCFG = SimConfig(**KW), JSimConfig(**KW)


def _jax_draws(cfg, key):
    """The draws of JAX make_scenario and realize_scattering for `key`
    (scenario) and fold_in(key, 0) (packet), as numpy."""
    k1, k2, k3 = jax.random.split(key, 3)
    rng = jax.random.randint(k1, (), 1, int(cfg.max_range) + 1)
    az = jax.random.uniform(k2, (), minval=-180.0, maxval=180.0)
    el = jax.random.uniform(k3, (), minval=-90.0, maxval=90.0)
    kp, kg = jax.random.split(jax.random.fold_in(key, 0))
    u = jax.random.uniform(kp, (3, cfg.n_scatterers), minval=-1.0,
                           maxval=1.0)
    g = jax.random.normal(kg, (2, cfg.n_scatterers))
    return [np.asarray(a, np.float32) for a in (rng, az, el, u, g)]


def _jax_realization(cfg, seed):
    """JAX's realization under jit, as generate_dataset computes it (XLA's
    compiled code fuses multiply-adds into the path lengths, which eager
    dispatch does not; the port follows the compiled roundings)."""
    key = jax.random.PRNGKey(seed)
    scen = js.make_scenario(cfg, key)
    chan = jax.jit(lambda k: js.realize_channel(cfg, k, scen))(
        jax.random.fold_in(key, 0))
    return scen, chan


def _as_port(chan):
    """A JAX realization carried across as numpy."""
    return ps.ChannelRealization(*(torch.tensor(np.asarray(a)) for a in chan))


def test_unit_phasor_and_fft_size_match_jax():
    c = np.random.default_rng(0).uniform(-1e5, 1e5, 4096).astype(np.float32)
    np.testing.assert_allclose(unit_phasor(torch.tensor(c)).numpy(),
                               np.asarray(j_unit_phasor(jnp.asarray(c))),
                               rtol=0, atol=2e-6)
    for kw in ({}, KW, dict(num_tx=64)):
        for data_leg in (False, True):
            assert default_fft_size(SimConfig(**kw), data_leg) == \
                j_fft_size(JSimConfig(**kw), data_leg)


@pytest.mark.parametrize("n,ncols,geometry", [(8, 1, "auto"), (32, 4, "auto"),
                                              (8, 2, "ula"), (16, 1, "ura")])
def test_array_geometry_matches_jax(n, ncols, geometry):
    lam = CFG.lam
    np.testing.assert_array_equal(
        ps.array_positions(n, geometry, 0.5 * lam, ncols),
        js.array_positions(n, geometry, 0.5 * lam, ncols))
    assert ps.helper_array_info(n, 4, ncols if n % ncols == 0 else 1) == \
        js.helper_array_info(n, 4, ncols if n % ncols == 0 else 1)
    assert ps.resolve_geometry(geometry, ncols) == \
        js.resolve_geometry(geometry, ncols)
    pos = ps.array_positions(n, geometry, 0.5, ncols)
    rng = np.random.default_rng(n)
    az = rng.uniform(-180, 180, 7).astype(np.float32)
    el = rng.uniform(-90, 90, 7).astype(np.float32)
    np.testing.assert_allclose(ps.steering_vectors(pos, az, el).numpy(),
                               np.asarray(js.steering_vectors(pos, az, el)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(ps.fspl_db(123.0, lam).numpy(),
                               np.asarray(js.fspl_db(123.0, lam)), rtol=1e-6)
    with pytest.raises(ValueError):
        ps.helper_array_info(6, 4, 4)


@pytest.mark.parametrize("seed", [0, 6, 11])
def test_realization_on_jax_draws_matches_jax(seed):
    jscen, jchan = _jax_realization(JCFG, seed)
    rng, az, el, u, g = _jax_draws(JCFG, jax.random.PRNGKey(seed))
    scen = ps.scenario_from_draws(CFG, rng, az, el)
    for got, ref in zip(scen, jscen):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    chan = ps.scattering_from_draws(CFG, scen, u, g)
    cr, cr_j = chan.cr.numpy(), np.asarray(jchan.cr)
    assert cr.dtype == np.complex64 and cr.shape == cr_j.shape
    np.testing.assert_allclose(np.abs(cr), np.abs(cr_j), rtol=2e-6)
    np.testing.assert_allclose(chan.tau.numpy(), np.asarray(jchan.tau),
                               rtol=2e-7)
    assert int(chan.chan_delay) == int(jchan.chan_delay)
    # the phase: within a few float32 ulps of the path length d
    pos = np.asarray(jscen.rx_pos, np.float64)
    scat = pos[:, None] + u.astype(np.float64) * float(rng) \
        * CFG.scat_radius_frac
    tx = np.asarray(jscen.tx_elem, np.float64)
    rx = pos[:, None] + np.asarray(jscen.rx_elem, np.float64)
    d = (np.linalg.norm(scat[:, None] - tx[:, :, None], axis=0)[:, None]
         + np.linalg.norm(scat[:, None] - rx[:, :, None], axis=0)[None])
    ulp_cycles = np.spacing(d.astype(np.float32)) / CFG.lam
    dphi = np.abs(np.angle(cr / cr_j))
    assert np.all(dphi <= 4 * 2 * np.pi * ulp_cycles), \
        (dphi / (2 * np.pi * ulp_cycles)).max()


def test_realize_channel_draws_from_a_generator():
    gen = torch.Generator().manual_seed(3)
    scen = ps.make_scenario(CFG, gen)
    assert 1 <= float(scen.mobile_range) <= CFG.max_range
    assert -180 <= float(scen.mobile_az) < 180
    assert -90 <= float(scen.mobile_el) < 90
    chan = ps.realize_channel(CFG, gen, scen)
    assert chan.cr.shape == (CFG.num_tx, CFG.num_rx, CFG.n_scatterers)
    assert chan.cr.dtype == torch.complex64 and chan.tau.dtype == torch.float32
    assert chan.chan_delay.dtype == torch.int32
    assert torch.isfinite(torch.view_as_real(chan.cr)).all()
    # the same seed gives the same channel; the CDL models draw the CDL
    # realization (channel/cdl.py)
    gen2 = torch.Generator().manual_seed(3)
    ps.make_scenario(CFG, gen2)
    again = ps.realize_channel(CFG, gen2, scen)
    torch.testing.assert_close(again.cr, chan.cr, rtol=0, atol=0)
    cdl = ps.realize_channel(CFG.replace(channel_model="cdl_nlos"), gen, scen)
    assert cdl.cr.shape == (CFG.num_tx, CFG.num_rx, 20)
    assert torch.isfinite(torch.view_as_real(cdl.cr)).all()


@pytest.mark.parametrize("model", ["scattering", "fir"])
def test_apply_channel_matches_jax(model):
    cfg, jcfg = CFG.replace(channel_model=model), \
        JCFG.replace(channel_model=model)
    _, jchan = _jax_realization(jcfg, 6)
    sig = pad_signal(cfg, gen_preamble(jcfg, jcfg.num_tx))
    jsig = j_pad_signal(jcfg, jnp.asarray(gen_preamble(jcfg, jcfg.num_tx)))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    ref = np.asarray(js.apply_channel_model(jcfg, jsig, jchan, fft_size=8192))
    got = ps.apply_channel_model(cfg, sig, _as_port(jchan), fft_size=8192)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("sync", [None, 3])
def test_analytic_subcarrier_channel_matches_jax(sync):
    _, jchan = _jax_realization(JCFG, 11)
    ref = np.asarray(js.analytic_subcarrier_channel(
        JCFG, jchan, None if sync is None else jnp.int32(sync)))
    got = ps.analytic_subcarrier_channel(CFG, _as_port(jchan), sync).numpy()
    assert got.shape == (CFG.num_carriers, CFG.num_tx, CFG.num_rx)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
