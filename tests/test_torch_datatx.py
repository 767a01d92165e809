"""The port's data-transmission leg (mamimo_tpu_torch.pipeline.datatx and
the precoded preamble of ops/ltf.py) against the JAX package at
tests/test_closed_loop.py's CL_CFG size (Nt 8, Nr 2, 16 scatterers, 64
rays, 4 data symbols) and at its 2-stream URA configuration.

The two packages draw different numbers for one seed, so JAX's own
draws (its key split as ``run_data_transmission`` splits it) and its
channel go into ``data_tx_from_draws``; JAX runs under ``jax.jit``, the
form its closed loop runs in. The OMP digital weights carry the SVD's
arbitrary phase per carrier; it shapes the time-domain frame, so EVM and
SNR move with it at the percent level. On the CPU both packages take
LAPACK's SVD, whose phases agree, so the legs are compared tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cl_jax import (
    CL_KW,
    channel,
    jax_data_tx_draws,
    rel,
    scenario,
    stack_draws,
)
from mamimo_tpu.channel.scattering import make_scenario as j_make_scenario
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops.ltf import gen_preamble as j_gen_preamble
from mamimo_tpu.pipeline.datatx import run_data_transmission as j_run
from mamimo_tpu.pipeline.sounding import sound_packet as j_sound
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.ltf import gen_preamble
from mamimo_tpu_torch.pipeline import datatx as pdt

URA_KW = dict(num_tx=8, num_rx=4, num_sts=2, n_scatterers=16, n_rays=64,
              num_data_symbols=4)
FFT = 16384


def _jax_packets(kw, seed, snrs):
    """JAX's scenario, one sounded packet per SNR, and JAX's data leg on
    its LS and perfect CSI (jit), with the draws of each data leg."""
    jcfg = JSimConfig(**kw)
    scen = j_make_scenario(jcfg, jax.random.PRNGKey(seed))
    sound = jax.jit(lambda k, s: j_sound(jcfg, k, scen, s, fft_size=8192))
    run = jax.jit(lambda k, ch, csi, nd, sc: j_run(
        jcfg, k, scen, ch, csi, nd, sc, fft_size=FFT))
    out = []
    for i, snr in enumerate(snrs):
        res, chan = sound(jax.random.PRNGKey(100 + i), jnp.float32(snr))
        key = jax.random.PRNGKey(200 + i)
        for csi in (res.h_ls, res.h_perfect):
            r = run(key, chan, csi, res.noise_db, res.snr_cs)
            out.append(dict(chan=chan, csi=np.asarray(csi),
                            noise_db=float(res.noise_db),
                            snr_cs=np.asarray(res.snr_cs),
                            draws=jax_data_tx_draws(jcfg, key),
                            want={k: np.asarray(v) for k, v in
                                  r._asdict().items()}))
    return scen, out


@pytest.fixture(scope="module")
def su():
    return _jax_packets(CL_KW, 5, (10.0, 30.0))


@pytest.fixture(scope="module")
def ura():
    return _jax_packets(URA_KW, 7, (15.0,))


def _check(got, want, n_bits):
    # the decoded bits are identical: equal BER means equal error counts
    # against the same transmitted bits
    assert float(got.ber) == float(want["ber"])
    assert rel(got.evm.numpy(), want["evm"]) < 1e-4
    np.testing.assert_allclose(got.snr_dt.numpy(), want["snr_dt"],
                               atol=1e-4)
    assert abs(float(got.bf_gain) - float(want["bf_gain"])) < 1e-4
    assert got.decoded.shape[-1] == n_bits


def _run_one(cfg, scen, p):
    return pdt.data_tx_from_draws(
        cfg, scenario(scen), channel(p["chan"]), torch.tensor(p["csi"])[None],
        torch.tensor([p["noise_db"]]), torch.tensor(p["snr_cs"])[None],
        stack_draws([p["draws"]]), fft_size=FFT)


@pytest.mark.parametrize("i", range(4))
def test_data_tx_from_draws_matches_jax(su, i):
    """LS and perfect CSI at 10 dB and 30 dB, one packet at a time."""
    cfg = SimConfig(**CL_KW)
    scen, packets = su
    got = pdt.DataTxResult(*(x[0] for x in _run_one(cfg, scen, packets[i])))
    bits = packets[i]["draws"].bits
    assert float(got.ber) == float((got.decoded != bits).float().mean())
    _check(got, packets[i]["want"], cfg.num_frm_bits)


def test_data_tx_batched_equals_one_at_a_time(su):
    """The four legs as one batch (each its own channel and draws) give
    what they give alone."""
    cfg = SimConfig(**CL_KW)
    scen, packets = su
    got = pdt.data_tx_from_draws(
        cfg, scenario(scen),
        channel([np.stack([np.asarray(getattr(p["chan"], f)) for p in packets])
                 for f in ("cr", "tau", "chan_delay")]),
        torch.tensor(np.stack([p["csi"] for p in packets])),
        torch.tensor([p["noise_db"] for p in packets]),
        torch.tensor(np.stack([p["snr_cs"] for p in packets])),
        stack_draws([p["draws"] for p in packets]), fft_size=FFT)
    for i, p in enumerate(packets):
        _check(pdt.DataTxResult(*(x[i] for x in got)), p["want"],
               cfg.num_frm_bits)


def test_data_tx_two_stream_ura_matches_jax(ura):
    """num_sts = 2 through the [4×2]-URA BS array (JAX
    test_closed_loop.py:49)."""
    cfg = SimConfig(**URA_KW)
    scen, packets = ura
    for p in packets:
        got = pdt.DataTxResult(*(x[0] for x in _run_one(cfg, scen, p)))
        _check(got, p["want"], cfg.num_frm_bits)


@pytest.mark.parametrize("kw", [CL_KW, URA_KW])
def test_precoded_preamble_matches_jax(kw):
    """gen_preamble(v=...) on a batch of random weights, each against
    JAX's on its own (1e-6 relative)."""
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    rng = np.random.default_rng(0)
    ns = cfg.num_sts
    v = (rng.standard_normal((3, cfg.num_carriers, ns, ns))
         + 1j * rng.standard_normal((3, cfg.num_carriers, ns, ns))
         ).astype(np.complex64)
    got = gen_preamble(cfg, ns, v=torch.tensor(v))
    assert tuple(got.shape) == (3, ns * cfg.sym_len, ns)
    fn = jax.jit(lambda x: j_gen_preamble(jcfg, ns, v=x))
    for b in range(3):
        assert rel(got[b].numpy(), fn(jnp.asarray(v[b]))) < 1e-6
    # the static preamble is unchanged: numpy, as before
    np.testing.assert_array_equal(gen_preamble(cfg, ns),
                                  j_gen_preamble(jcfg, ns))


def test_draw_data_tx_shapes_and_streams():
    """A packet's draws come from its generator alone, in a fixed order."""
    cfg = SimConfig(**CL_KW)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    d = pdt.draw_data_tx(cfg, gens)
    assert tuple(d.az.shape) == (2, cfg.n_rays)
    assert tuple(d.bits.shape) == (2, cfg.num_frm_bits)
    assert tuple(d.noise.shape) == (2, pdt.data_leg_samples(cfg, 1),
                                    cfg.num_rx, 2)
    assert d.bits.dtype == torch.int32 and set(d.bits.unique().tolist()) \
        == {0, 1}
    assert float(d.az.min()) >= -180.0 and float(d.el.max()) < 90.0
    alone = pdt.draw_data_tx(cfg, [torch.Generator().manual_seed(2)])
    for a, b in zip(alone, d):
        np.testing.assert_array_equal(a[0].numpy(), b[1].numpy())


def test_evm_depends_on_the_svd_phase(su, monkeypatch):
    """The SVD's phase per carrier is arbitrary, yet it shapes the
    time-domain frame: OMP's digital weights turned by random phases per
    carrier leave the decoded bits as they were but move EVM and the
    data-leg SNR (the reason the card, whose SVD has other phases than
    LAPACK's, is held to the CPU on the same weights)."""
    cfg = SimConfig(**CL_KW)
    scen, packets = su
    p = packets[3]                                   # perfect CSI, 30 dB
    base = pdt.DataTxResult(*(x[0] for x in _run_one(cfg, scen, p)))
    orig = pdt.omp_hyb_weights
    g = torch.Generator().manual_seed(7)

    def turned(*a, **k):
        fbb, frf = orig(*a, **k)
        ph = torch.rand(fbb.shape[:-2] + (1, 1), generator=g)
        return fbb * torch.polar(torch.ones_like(ph), 2 * np.pi * ph), frf

    monkeypatch.setattr(pdt, "omp_hyb_weights", turned)
    got = pdt.DataTxResult(*(x[0] for x in _run_one(cfg, scen, p)))
    assert torch.equal(got.decoded, base.decoded)
    assert rel(got.evm.numpy(), base.evm.numpy()) > 1e-3
    assert float((got.snr_dt - base.snr_dt).abs().max()) > 1e-3


def test_run_data_transmission_is_its_draws_then_the_leg(su):
    """run_data_transmission = draw_data_tx from the generator, then
    data_tx_from_draws on the one packet."""
    cfg = SimConfig(**CL_KW)
    scen, packets = su
    p = packets[1]
    got = pdt.run_data_transmission(
        cfg, torch.Generator().manual_seed(4), scenario(scen),
        channel(p["chan"]), torch.tensor(p["csi"]), p["noise_db"],
        torch.tensor(p["snr_cs"]), fft_size=FFT)
    want = pdt.data_tx_from_draws(
        cfg, scenario(scen), channel(p["chan"]), torch.tensor(p["csi"])[None],
        torch.tensor([p["noise_db"]]), torch.tensor(p["snr_cs"])[None],
        pdt.draw_data_tx(cfg, [torch.Generator().manual_seed(4)]),
        fft_size=FFT)
    assert tuple(got.snr_dt.shape) == (cfg.num_rx,)
    for a, b in zip(got, want):
        assert torch.equal(a, b[0])
