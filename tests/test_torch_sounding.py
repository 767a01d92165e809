"""The port's receiver chains, CDL channel and sounding pipeline
(mamimo_tpu_torch.channel.noise, channel.cdl, pipeline.sounding) against
the JAX package at Nt 8, Nr 2.

The two packages draw different numbers for one seed, so the JAX
package's own draws are fed to the port's from-draws functions: the
keys are split exactly as ``mamimo_tpu/pipeline/sounding.py::sound_packet``
and ``generate_dataset`` split them, and drawn with ``jax.random``. The
carrier phase of a scattering path, unit_phasor(−d/λ) in float32, moves
``rx`` and the estimates by up to about 1e-2 relative between two
float32 evaluation orders (tests/test_golden.py's reason for 2e-2; JAX
eager against JAX jit differ so). The port computes the path lengths in
the roundings of JAX's compiled code, so JAX runs under jit here, as in
generate_dataset; fed JAX's realization itself (cr, tau) the chains
agree tightly.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.channel import cdl as jcdl
from mamimo_tpu.channel import noise as jnoise
from mamimo_tpu.channel.scattering import make_scenario as j_make_scenario
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import estimate as je
from mamimo_tpu.ops.ofdm import ofdm_demodulate as j_demod
from mamimo_tpu.pipeline import sounding as js
from mamimo_tpu_torch.channel import cdl as pcdl
from mamimo_tpu_torch.channel import noise as pnoise
from mamimo_tpu_torch.channel.scattering import (
    ChannelRealization,
    realize_channel,
    scenario_from_draws,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.pipeline import sounding as ps

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG, JCFG = SimConfig(**KW), JSimConfig(**KW)
HERE = os.path.dirname(__file__)
FIELDS = ("rx", "h_ls", "h_perfect", "h_mmse")


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def jax_scenario_draws(key):
    """(range, az, el) of JAX make_scenario(cfg, key)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.float32(jax.random.randint(k1, (), 1, 1001)),
            np.float32(jax.random.uniform(k2, (), minval=-180., maxval=180.)),
            np.float32(jax.random.uniform(k3, (), minval=-90., maxval=90.)))


def jax_packet_draws(jcfg, key, noise_mode="snr"):
    """The standard draws JAX sound_packet(cfg, key, ...) makes, as the
    port's per-packet tuple (u, g, phi, noise, intf, perf)."""
    k_chan, k_noise, k_perf = jax.random.split(key, 3)
    shape = (jcfg.len_ltf + jcfg.num_pad_zeros, jcfg.num_rx, 2)
    u = g = phi = intf = None
    if jcfg.channel_model in ("scattering", "fir"):
        kp, kg = jax.random.split(k_chan)
        u = jax.random.uniform(kp, (3, jcfg.n_scatterers), minval=-1.0,
                               maxval=1.0)
        g = jax.random.normal(kg, (2, jcfg.n_scatterers))
    else:
        n = len(jcdl.get_profile(jcfg.channel_model).delays) * jcdl.NUM_RAYS
        phi = jax.random.uniform(k_chan, (n,), minval=0.0,
                                 maxval=2.0 * math.pi)
    if noise_mode == "sinr":
        kn, ki = jax.random.split(k_noise)
        noise = jax.random.normal(kn, shape)
        intf = jax.random.normal(ki, shape)
    else:
        noise = jax.random.normal(k_noise, shape)
    perf = jax.random.normal(k_perf, shape)
    return tuple(None if a is None else np.asarray(a)
                 for a in (u, g, phi, noise, intf, perf))


def stack_draws(per_packet):
    return ps.SoundingDraws(*(None if parts[0] is None else
                              torch.tensor(np.stack(parts))
                              for parts in zip(*per_packet)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# receiver chains
# ---------------------------------------------------------------------------

def _rx_sig(rng, b, nsamp=1400):
    return (1e-4 * (rng.standard_normal((b, nsamp, CFG.num_rx))
                    + 1j * rng.standard_normal((b, nsamp, CFG.num_rx)))
            ).astype(np.complex64)


@pytest.mark.parametrize("chain", ["snr", "fixed_noise", "nf", "sinr"])
def test_receiver_chains_match_jax(chain):
    """Each chain on two packets at once (their own sync offsets) against
    JAX's, one packet at a time, on JAX's draws."""
    rng = np.random.default_rng(0)
    sig = _rx_sig(rng, 2)
    delays = np.array([13, 700], np.int32)
    keys = [jax.random.PRNGKey(i) for i in (7, 8)]
    shape = sig.shape[1:] + (2,)
    want = []
    z, zi = [], []
    for b, key in enumerate(keys):
        s, d = jnp.asarray(sig[b]), jnp.asarray(delays[b])
        if chain == "sinr":
            kn, ki = jax.random.split(key)
            z.append(np.asarray(jax.random.normal(kn, shape)))
            zi.append(np.asarray(jax.random.normal(ki, shape)))
            want.append(jnoise.interference_chain(JCFG, key, s, d))
            continue
        z.append(np.asarray(jax.random.normal(key, shape)))
        if chain == "nf":
            want.append(jnoise.receiver_chain_nf(JCFG, key, s, 60.0, d))
        else:
            want.append(jnoise.receiver_chain(
                JCFG, key, s, 5.0, 60.0, d,
                noise_power_db=-20.0 if chain == "fixed_noise" else None))
    tz, ts, td = torch.tensor(np.stack(z)), torch.tensor(sig), \
        torch.tensor(delays)
    if chain == "sinr":
        got = pnoise.interference_chain(CFG, tz, torch.tensor(np.stack(zi)),
                                        ts, td)
    elif chain == "nf":
        got = pnoise.receiver_chain_nf(CFG, tz, ts, 60.0, td)
    else:
        got = pnoise.receiver_chain(
            CFG, tz, ts, 5.0, 60.0, td,
            noise_power_db=-20.0 if chain == "fixed_noise" else None)
    y, snr, noise = got
    assert tuple(y.shape) == (2, 1400 - CFG.num_pad_zeros, CFG.num_rx)
    for b, (jy, jsnr, jnoise_db) in enumerate(want):
        assert _rel(y[b].numpy(), jy) < 1e-6
        np.testing.assert_allclose(snr[b].numpy(), np.asarray(jsnr),
                                   atol=1e-4)
        np.testing.assert_allclose(float(noise[b]), float(jnoise_db),
                                   atol=1e-4)


def test_receiver_matches_reference_oracle():
    """generate_maMIMO_LTF.m:239-332 in float64 (the bounds of
    tests/test_reference_oracles.py): the power bookkeeping, and the
    signal path with the noise drowned (−400 dB)."""
    g = np.load(os.path.join(HERE, "golden", "reference_semantics.npz"))
    cfg = SimConfig(num_tx=8, num_rx=2)
    rx = torch.tensor(g["rcv_rx_sig"].astype(np.complex64))
    z = torch.zeros(rx.shape + (2,))
    d = torch.tensor(int(g["rcv_chan_delay"]))
    _, snr_cs, noise_db = pnoise.receiver_chain(
        cfg, z, rx, float(g["rcv_snr_db"]), float(g["rcv_gain_db"]), d)
    np.testing.assert_allclose(snr_cs.numpy(), g["rcv_snr_cs"], atol=1e-3)
    np.testing.assert_allclose(float(noise_db), float(g["rcv_noise_db"]),
                               atol=1e-3)
    y, _, _ = pnoise.receiver_chain(
        cfg, torch.randn(rx.shape + (2,)), rx, 0.0, float(g["rcv_gain_db"]),
        d, noise_power_db=-400.0)
    ref = g["rcv_y_sync"]
    np.testing.assert_allclose(y.numpy(), ref, atol=2e-6 * np.abs(ref).max())


def test_sync_slice_gathers_and_clamps_as_jax():
    """One gather over packets; a start past the padding is clamped as
    jax.lax.dynamic_slice clamps it."""
    rng = np.random.default_rng(1)
    y = _rx_sig(rng, 3)
    delays = np.array([0, 500, 5000], np.int32)
    got = pnoise.sync_slice(CFG, torch.tensor(y), torch.tensor(delays))
    for b in range(3):
        want = jnoise.sync_slice(JCFG, jnp.asarray(y[b]),
                                 jnp.asarray(delays[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# CDL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cdl_nlos", "cdl_los"])
def test_cdl_profiles_equal_jax(name):
    np.testing.assert_array_equal(pcdl.RAY_OFFSETS, jcdl.RAY_OFFSETS)
    assert pcdl.NUM_RAYS == jcdl.NUM_RAYS
    p, j = pcdl.get_profile(name), jcdl.get_profile(name)
    for field in j.__dataclass_fields__:
        assert getattr(p, field) == getattr(j, field), field
    with pytest.raises(ValueError, match="unknown CDL profile"):
        pcdl.get_profile("cdl_z")


@pytest.mark.parametrize("name", ["cdl_nlos", "cdl_los"])
def test_cdl_realization_matches_jax(name):
    """cdl_from_draws on JAX's phases, two packets at once, against JAX
    realize_cdl one packet at a time; realize_channel dispatches to the
    CDL model."""
    cfg, jcfg = CFG.replace(channel_model=name), \
        JCFG.replace(channel_model=name)
    key = jax.random.PRNGKey(11)
    jscen = j_make_scenario(jcfg, key)
    scen = scenario_from_draws(cfg, *jax_scenario_draws(key))
    n = pcdl.num_phases(cfg)
    pkeys = [jax.random.fold_in(key, p) for p in range(2)]
    phi = np.stack([np.asarray(jax.random.uniform(
        k, (n,), minval=0.0, maxval=2.0 * math.pi)) for k in pkeys])
    got = pcdl.cdl_from_draws(cfg, scen, torch.tensor(phi))
    n_cl = len(pcdl.get_profile(name).delays)
    assert tuple(got.cr.shape) == (2, cfg.num_tx, cfg.num_rx, n_cl)
    realize = jax.jit(lambda k: jcdl.realize_cdl(jcfg, k, jscen))
    for b, k in enumerate(pkeys):
        want = realize(k)
        assert _rel(got.cr[b].numpy(), want.cr) < 1e-5
        np.testing.assert_allclose(got.tau[b].numpy(), np.asarray(want.tau),
                                   rtol=1e-6)
        assert int(got.chan_delay[b]) == int(want.chan_delay)
    one = realize_channel(cfg, torch.Generator().manual_seed(0), scen)
    assert tuple(one.cr.shape) == (cfg.num_tx, cfg.num_rx, n_cl)
    assert tuple(one.tau.shape) == (n_cl,) and one.chan_delay.ndim == 0


# ---------------------------------------------------------------------------
# the sounding pipeline
# ---------------------------------------------------------------------------

CASES = [("scattering", "snr", "cg"), ("scattering", "snr", "direct"),
         ("scattering", "snr", "dense"), ("scattering", "snr", "eig"),
         ("scattering", "nf", "cg"), ("scattering", "sinr", "cg"),
         ("cdl_los", "snr", "cg")]


@pytest.mark.parametrize("model,mode,est", CASES)
def test_sound_packet_matches_jax(model, mode, est):
    """JAX sound_packet against the port's sound_from_draws on JAX's
    draws (test_golden.py's bounds), then against sound_realization on
    JAX's own realization (tight: no phase amplification left)."""
    cfg, jcfg = CFG.replace(channel_model=model), \
        JCFG.replace(channel_model=model)
    key = jax.random.PRNGKey(3)
    jscen = j_make_scenario(jcfg, key)
    scen = scenario_from_draws(cfg, *jax_scenario_draws(key))
    pkey = jax.random.fold_in(key, 5)
    want, jchan = jax.jit(lambda k: js.sound_packet(
        jcfg, k, jscen, 5.0, with_mmse=True, noise_mode=mode,
        mmse_estimator=est))(pkey)
    draws = stack_draws([jax_packet_draws(jcfg, pkey, mode)])
    kw = dict(with_mmse=True, noise_mode=mode, mmse_estimator=est)
    got, chan = ps.sound_from_draws(cfg, scen, draws, 5.0, **kw)
    for f in FIELDS:
        assert got._asdict()[f].shape[1:] == want._asdict()[f].shape
        assert _rel(got._asdict()[f][0].numpy(), want._asdict()[f]) < 2e-2, f
    np.testing.assert_allclose(got.tau[0].numpy(), np.asarray(want.tau),
                               rtol=1e-5)
    np.testing.assert_allclose(got.snr_cs[0].numpy(), np.asarray(want.snr_cs),
                               atol=1e-3)
    np.testing.assert_allclose(float(got.noise_db[0]), float(want.noise_db),
                               atol=1e-3)
    assert int(got.chan_delay[0]) == int(want.chan_delay)

    same = ChannelRealization(*(_t(a)[None] for a in jchan))
    tight = ps.sound_realization(cfg, scen, same, draws, 5.0, **kw)
    for f in FIELDS:
        assert _rel(tight._asdict()[f][0].numpy(), want._asdict()[f]) < 1e-4, f


def test_sound_packet_entry_point(monkeypatch):
    """sound_packet = the packet's draws from its generator, then
    sound_from_draws on one packet; gen and scen must be on the device;
    the default device is the card."""
    scen = scenario_from_draws(CFG, 300.0, 20.0, 5.0)
    res, chan = ps.sound_packet(CFG, torch.Generator().manual_seed(4), scen,
                                10.0, noise_mode="sinr", device="cpu")
    draws = ps.draw_sounding(CFG, [torch.Generator().manual_seed(4)], "sinr")
    want, _ = ps.sound_from_draws(CFG, scen, draws, 10.0, noise_mode="sinr")
    assert tuple(res.rx.shape) == (CFG.len_ltf, CFG.num_rx)
    assert tuple(chan.cr.shape) == (CFG.num_tx, CFG.num_rx, CFG.n_scatterers)
    for f in res._fields:
        np.testing.assert_array_equal(res._asdict()[f].numpy(),
                                      want._asdict()[f][0].numpy())
    with pytest.raises(ValueError, match="unknown noise_mode"):
        ps.sound_packet(CFG, torch.Generator(), scen, 10.0, noise_mode="x",
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ps.sound_packet(CFG, torch.Generator(), scen, 10.0)


def test_estimate_from_rx_dispatch():
    """'direct' gives the exact solve on the sounding path (the dispatch
    test of tests/test_lmmse_metrics.py); the LS half against JAX's;
    without with_mmse the LMMSE is zeros; unknown names raise."""
    from mamimo_tpu_torch.ops import estimate as pe

    rng = np.random.default_rng(9)
    rx = (rng.standard_normal((CFG.len_ltf, CFG.num_rx))
          + 1j * rng.standard_normal((CFG.len_ltf, CFG.num_rx))
          ).astype(np.complex64)
    tau = torch.tensor(rng.uniform(1e-6, 4e-6, CFG.n_scatterers)
                       .astype(np.float32))
    snr = torch.full((CFG.num_rx,), 40.0)
    h_ls, h_direct = ps.estimate_from_rx(
        CFG, torch.tensor(rx), tau, snr, with_mmse=True,
        mmse_estimator="direct")
    grid, _ = j_demod(JCFG, jnp.asarray(rx), nsym=JCFG.num_tx)
    want_ls = np.asarray(je.ls_estimate(JCFG, grid, JCFG.num_tx))
    np.testing.assert_allclose(h_ls.numpy(), want_ls,
                               atol=1e-6 * np.abs(want_ls).max())
    want = pe.lmmse_estimate_direct(CFG, h_ls, tau, snr)
    np.testing.assert_array_equal(h_direct.numpy(), want.numpy())
    _, zeros = ps.estimate_from_rx(CFG, torch.tensor(rx))
    assert not bool(zeros.abs().any())
    with pytest.raises(ValueError, match="unknown mmse_estimator"):
        ps.estimate_from_rx(CFG, torch.tensor(rx), tau, snr, with_mmse=True,
                            mmse_estimator="nope")


def test_golden_corpus_through_jax_draws():
    """tests/golden/bs8_seed777.npz (JAX generate_dataset, seed 777, 2
    packets, 5 dB, CG LMMSE) from the port's batched sounding on the
    draws of JAX's per-packet keys, at tests/test_golden.py's bounds."""
    jcfg = JSimConfig(num_tx=8, num_rx=2, n_scatterers=16)
    cfg = SimConfig(num_tx=8, num_rx=2, n_scatterers=16)
    key_scen, key_pkts = jax.random.split(jax.random.PRNGKey(777))
    scen = scenario_from_draws(cfg, *jax_scenario_draws(key_scen))
    draws = stack_draws([jax_packet_draws(
        jcfg, jax.random.fold_in(key_pkts, p)) for p in range(2)])
    res, _ = ps.sound_from_draws(cfg, scen, draws, 5.0, with_mmse=True,
                                 fft_size=8192)
    g = np.load(os.path.join(HERE, "golden", "bs8_seed777.npz"))
    for f in FIELDS:
        assert _rel(res._asdict()[f].numpy(), g[f]) < 2e-2, f
    np.testing.assert_allclose(res.tau.numpy(), g["tau"], rtol=1e-5)
    np.testing.assert_allclose(res.snr_cs.numpy(), g["snr_cs"], atol=1e-3)
    np.testing.assert_allclose(res.noise_db.numpy(), g["noise_db"], atol=1e-3)
