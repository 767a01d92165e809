"""The port's multi-user path (mamimo_tpu_torch.ops.jsdm,
pipeline.multiuser, the multi-user data leg and run_mu_snr_sweep)
against the JAX package at tests/test_multiuser.py's MU configuration
(2 users, Nt 8, Nr 2, 12 scatterers, 4 data symbols).

JAX's draws go into the port's from-draws functions (JAX's keys split
as ``sound_packet_mu`` and ``run_data_transmission_mu`` split them),
JAX under ``jax.jit``. JSDM's analog rows are eigenvectors, each with an
arbitrary phase: they are compared by their projectors b bᴴ; the
digital weights of one stream per user do not depend on the phase."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cl_jax import (
    MU_KW,
    channel,
    jax_data_tx_mu_draws,
    jax_sounding_draws,
    rel,
    scenario,
    stack_draws,
)
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops import jsdm as jj
from mamimo_tpu.pipeline.datatx import run_data_transmission_mu as j_run_mu
from mamimo_tpu.pipeline.multiuser import make_scenarios as j_scenarios
from mamimo_tpu.pipeline.multiuser import sound_packet_mu as j_sound_mu
from mamimo_tpu.pipeline.multiuser import user_packet_key
from mamimo_tpu_torch.channel.scattering import ChannelRealization
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.eval.snr_sweep import run_mu_snr_sweep
from mamimo_tpu_torch.models.mlp import init_stacked
from mamimo_tpu_torch.ops import jsdm as pj
from mamimo_tpu_torch.pipeline import datatx as pdt
from mamimo_tpu_torch.pipeline import multiuser as pmu
from mamimo_tpu_torch.pipeline.dataset import generate_dataset
from mamimo_tpu_torch.pipeline.sounding import (
    draw_sounding,
    sound_from_draws,
    sound_realization,
)

MU, JMU = SimConfig(**MU_KW), JSimConfig(**MU_KW)
FFT = 16384


def _sound(snr):
    """JAX's seed-8 users (separable placements, tests/test_multiuser.py)
    sounded at ``snr`` under jit, the packet key fold_in(key, 1)."""
    key = jax.random.PRNGKey(8)
    scens = j_scenarios(JMU, key)
    pkt = jax.random.fold_in(key, 1)
    res, chans = jax.jit(lambda k: j_sound_mu(JMU, k, scens, snr_db=snr,
                                              fft_size=8192))(pkt)
    return scens, pkt, res, chans


@pytest.fixture(scope="module")
def mu10():
    return _sound(10.0)


@pytest.fixture(scope="module")
def mu30():
    return _sound(30.0)


def _projector(rows):
    b = np.conj(np.asarray(rows)).T                  # columns b = rowᴴ
    return b @ np.conj(b).T


def test_jsdm_weights_match_jax(mu10):
    """Two packets' CSI as one batch (the perfect and the LS estimate),
    each against JAX: the analog rows by their projectors, fbb to 1e-5."""
    _, _, res, _ = mu10
    hs = [np.asarray(res.h_perfect), np.asarray(res.h_ls)]
    fbb, m_frf = pj.jsdm_transmit_weights(torch.tensor(np.stack(hs)), 1)
    assert tuple(m_frf.shape) == (2, 2, MU.num_tx)
    for b, h in enumerate(hs):
        w_fbb, w_frf = jax.jit(lambda x: jj.jsdm_transmit_weights(x, 1))(h)
        for u in range(2):
            assert rel(_projector(m_frf[b, u:u + 1].numpy()),
                       _projector(np.asarray(w_frf)[u:u + 1])) < 1e-5
            assert rel(fbb[u][b].numpy(), w_fbb[u]) < 1e-5
        np.testing.assert_allclose(
            pj.user_covariances(torch.tensor(h)).numpy(),
            np.asarray(jj.user_covariances(jnp.asarray(h))), rtol=1e-5,
            atol=1e-5 * np.abs(np.asarray(jj.user_covariances(h))).max())


def test_pack_block_diagonal_equals_jax():
    rng = np.random.default_rng(0)
    blocks = [(rng.standard_normal((5, 2, 2)) + 1j * rng.standard_normal(
        (5, 2, 2))).astype(np.complex64) for _ in range(3)]
    got = pj.pack_block_diagonal([torch.tensor(b) for b in blocks], 2)
    want = jj.pack_block_diagonal([jnp.asarray(b) for b in blocks], 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sound_packet_mu_from_jax_draws(mu10):
    """Each user's packet from JAX's draws (tests/test_torch_sounding.py's
    bounds: 2e-2, the carrier phase amplifying one float32 rounding of a
    path length), and through JAX's own realizations (1e-4)."""
    scens, pkt, res, chans = mu10
    draws = [jax_sounding_draws(JMU, user_packet_key(pkt, u))
             for u in range(2)]
    got, gchan = pmu.sound_mu_from_draws(MU, scenario(scens), draws, 10.0,
                                         fft_size=8192)
    assert tuple(got.rx.shape) == (1, 2, MU.len_ltf, MU.num_rx)
    for f in ("rx", "h_ls", "h_perfect"):
        assert rel(getattr(got, f)[0].numpy(), getattr(res, f)) < 2e-2, f
    np.testing.assert_allclose(got.snr_cs[0].numpy(), np.asarray(res.snr_cs),
                               atol=1e-3)
    np.testing.assert_array_equal(gchan.chan_delay[0].numpy(),
                                  np.asarray(chans.chan_delay))
    for u in range(2):
        tight = sound_realization(
            MU, pmu.index_user(scenario(scens), u),
            ChannelRealization(*(x[u:u + 1] for x in channel(chans))),
            draws[u], 10.0, fft_size=8192)
        for f in ("rx", "h_ls", "h_perfect"):
            assert rel(getattr(tight, f)[0].numpy(),
                       np.asarray(getattr(res, f))[u]) < 1e-4, f


def test_sound_packet_mu_is_its_draws_then_the_batch(mu10):
    """sound_packet_mu = each user's draws from its generator, then
    sound_mu_from_draws on the one packet, without a packet axis."""
    scens = scenario(mu10[0])
    res, chan = pmu.sound_packet_mu(
        MU, [torch.Generator().manual_seed(u) for u in range(2)], scens,
        10.0, fft_size=8192, device="cpu")
    want, wchan = pmu.sound_mu_from_draws(
        MU, scens, [draw_sounding(MU, [torch.Generator().manual_seed(u)])
                    for u in range(2)], 10.0, fft_size=8192)
    assert tuple(res.h_ls.shape) == (2, MU.num_carriers, MU.num_tx,
                                     MU.num_rx)
    for a, b in zip(tuple(res) + tuple(chan), tuple(want) + tuple(wchan)):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("field", ["h_perfect", "h_ls"])
def test_data_tx_mu_matches_jax(mu10, field):
    """Per user: the BER equal, EVM to 1e-4 relative, SNR and BF gain to
    1e-4 dB, on JAX's channels and draws."""
    scens, _, res, chans = mu10
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda c: j_run_mu(JMU, key, scens, chans, c,
                                      res.noise_db, res.snr_cs,
                                      fft_size=FFT))(getattr(res, field))
    draws = stack_draws([jax_data_tx_mu_draws(JMU, key)])
    got = pdt.data_tx_mu_from_draws(
        MU, scenario(scens), channel(chans),
        torch.tensor(np.asarray(getattr(res, field)))[None],
        torch.tensor(np.asarray(res.noise_db))[None],
        torch.tensor(np.asarray(res.snr_cs))[None], draws, fft_size=FFT)
    assert tuple(got.ber.shape) == (1, 2)
    np.testing.assert_array_equal(got.ber[0].numpy(), np.asarray(want.ber))
    assert rel(got.evm[0].numpy(), want.evm) < 1e-4
    np.testing.assert_allclose(got.snr_dt[0].numpy(), np.asarray(want.snr_dt),
                               atol=1e-4)
    np.testing.assert_allclose(got.bf_gain[0].numpy(),
                               np.asarray(want.bf_gain), atol=1e-4)
    errs = (got.decoded[0] != draws.bits[0]).float().mean(-1)
    np.testing.assert_array_equal(errs.numpy(), got.ber[0].numpy())


def test_zero_interference_oracle(mu30):
    """JSDM block diagonalization (JAX test_multiuser.py:114): the two
    separable users of seed 8, perfect CSI at 30 dB, decode error-free,
    here on the port's own data-leg draws."""
    scens, _, res, chans = mu30
    out = pdt.run_data_transmission_mu(
        MU, torch.Generator().manual_seed(10), scenario(scens),
        channel(chans), torch.tensor(np.asarray(res.h_perfect)),
        torch.tensor(np.asarray(res.noise_db)),
        torch.tensor(np.asarray(res.snr_cs)), fft_size=FFT)
    assert tuple(out.ber.shape) == (2,)
    for u in range(2):
        assert float(out.ber[u]) == 0.0, (u, float(out.ber[u]))
        assert float(out.evm[u]) < 60.0, (u, float(out.evm[u]))


def test_scenarios_and_user_datasets():
    scens = pmu.make_scenarios(MU, torch.Generator().manual_seed(3))
    assert tuple(scens.rx_pos.shape) == (2, 3)
    assert float(scens.mobile_range[0]) != float(scens.mobile_range[1]) or \
        float(scens.mobile_az[0]) != float(scens.mobile_az[1])
    assert tuple(pmu.index_user(scens, 1).rx_pos.shape) == (3,)
    d0 = generate_dataset(MU, seed=3, num_packets=2, snr_db=10.0, user=0,
                          chunk=2, fft_size=8192, device="cpu")
    d1 = generate_dataset(MU, seed=3, num_packets=2, snr_db=10.0, user=1,
                          chunk=2, fft_size=8192, device="cpu")
    for u, d in enumerate((d0, d1)):
        np.testing.assert_array_equal(
            d.scenario.rx_pos.numpy(), scens.rx_pos[u].numpy())
    assert not np.allclose(d0.h_ls, d1.h_ls)
    # a user's packet regenerates from its own generator
    r, _ = sound_from_draws(MU, d1.scenario,
                            draw_sounding(MU, [d1.packet_generator(1)]),
                            10.0, fft_size=8192)
    np.testing.assert_array_equal(r.rx[0].numpy(), d1.rx[1])


def test_mu_snr_sweep_smoke():
    out = run_mu_snr_sweep(MU, snr_levels=[10.0], num_packets=2, seed=8,
                           sources=("ls", "perfect"), fft_size=FFT,
                           chunk=2, verbose=False, device="cpu")
    assert out["num_users"] == 2
    for s in ("ls", "perfect"):
        d = out["sources"][s]
        assert len(d["ber"]) == 1 and len(d["ber"][0]) == 2
        assert len(d["ber_ci"][0]) == 2
        assert all(np.isfinite(v) for v in d["evm"][0])


def test_mu_snr_sweep_dnn_source():
    """Per-user (untrained) models as the DNN source: the plumbing, not
    the accuracy; perfect CSI must do no worse than them."""
    tcfg = TrainConfig(hidden=(32, 32))
    models = [init_stacked(torch.Generator().manual_seed(u), MU, tcfg)
              for u in range(2)]
    out = run_mu_snr_sweep(MU, snr_levels=[10.0], num_packets=2, seed=8,
                           sources=("dnn", "perfect"), fft_size=FFT, chunk=2,
                           verbose=False, dnn_models=models, tcfg=tcfg,
                           device="cpu")
    d = out["sources"]["dnn"]
    assert len(d["ber"]) == 1 and len(d["ber"][0]) == 2
    assert all(np.isfinite(v) for v in d["ber"][0] + d["evm"][0])
    assert (np.mean(out["sources"]["perfect"]["ber"][0])
            <= np.mean(d["ber"][0]) + 1e-9)
    with pytest.raises(ValueError):
        run_mu_snr_sweep(MU, [10.0], 1, sources=("dnn",), device="cpu")
