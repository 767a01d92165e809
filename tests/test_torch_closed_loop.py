"""The port's closed loop as a whole (mamimo_tpu_torch.eval.closed_loop,
eval.snr_sweep and generate_dataset(with_ber=True)) against the JAX
package at tests/test_closed_loop.py's CL_CFG size (Nt 8, Nr 2, 16
scatterers, 64 rays, 4 data symbols), and on its own datasets.

The draws cannot match JAX's, so the JAX comparison takes JAX's own
dataset, regenerates each packet's channel with JAX's key (its
``evaluate_closed_loop``'s ``split(packet_key, 3)[0]``) and its data-leg
draws from ``fold_in(PRNGKey(seed), p)``, and runs the port's batched
(packet × source) leg on them, as ``evaluate_closed_loop`` batches it.
"""

import dataclasses
import os

import jax
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
from mamimo_tpu.channel.scattering import realize_channel as j_realize
from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.eval.closed_loop import evaluate_closed_loop as j_evaluate
from mamimo_tpu.eval.snr_sweep import compute_ci as j_compute_ci
from mamimo_tpu.pipeline.dataset import generate_dataset as j_generate
from mamimo_tpu_torch.channel.scattering import ChannelRealization
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.eval import closed_loop as pcl
from mamimo_tpu_torch.eval import snr_sweep as psw
from mamimo_tpu_torch.ops.metrics import nmse_subk
from mamimo_tpu_torch.pipeline.dataset import FIELDS, generate_dataset
from mamimo_tpu_torch.pipeline.datatx import (
    DataTxDraws,
    data_tx_from_draws,
    draw_data_tx,
)
from mamimo_tpu_torch.pipeline.sounding import channel_from_draws, draw_channel

CFG, JCFG = SimConfig(**CL_KW), JSimConfig(**CL_KW)
SOURCES = ("ls", "lmmse", "dnn", "perfect")
FFT = 16384


@pytest.fixture(scope="module")
def jax_run():
    """JAX's dataset (4 packets at 10 dB with LMMSE) and its closed loop
    on the first 2 packets × 4 sources, dnn = 0.5·LS."""
    ds = j_generate(JCFG, seed=5, num_packets=4, snr_db=10.0,
                    with_mmse=True, chunk=4, fft_size=8192)
    out = j_evaluate(ds, predictions=ds.h_ls * 0.5, max_packets=2,
                     fft_size=FFT)
    return ds, out


@pytest.fixture(scope="module")
def port_ds():
    return generate_dataset(CFG, seed=5, num_packets=4, snr_db=10.0,
                            with_mmse=True, chunk=4, fft_size=8192,
                            device="cpu")


def test_closed_loop_matches_jax(jax_run):
    """The slice as a whole: per-packet BER equal, EVM to 1e-4 relative,
    BF gain to 1e-4 dB, NMSE to 1e-6, for every source."""
    ds, want = jax_run
    n = 2
    real = jax.jit(lambda k: j_realize(JCFG, jax.random.split(k, 3)[0],
                                       ds.scenario))
    chans = [real(ds.packet_key(p)) for p in range(n)]
    chan = ChannelRealization(*(torch.tensor(np.stack(
        [np.asarray(getattr(c, f)) for c in chans]))[:, None]
        for f in ("cr", "tau", "chan_delay")))
    draws = stack_draws([jax_data_tx_draws(
        JCFG, jax.random.fold_in(jax.random.PRNGKey(1234), p))
        for p in range(n)])
    draws = DataTxDraws(*(t[:, None] for t in draws))
    pools = {"ls": ds.h_ls, "lmmse": ds.h_mmse, "dnn": ds.h_ls * 0.5,
             "perfect": ds.h_perfect}
    csi = torch.tensor(np.stack([pools[s][:n] for s in SOURCES], axis=1))
    got = data_tx_from_draws(
        CFG, scenario(ds.scenario), chan, csi,
        torch.tensor(ds.noise_db[:n])[:, None],
        torch.tensor(ds.snr_cs[:n])[:, None], draws, fft_size=FFT)
    assert tuple(got.ber.shape) == (n, len(SOURCES))
    ref = torch.tensor(ds.h_perfect[:n])
    for i, s in enumerate(SOURCES):
        np.testing.assert_array_equal(got.ber[:, i].numpy(), want[s].ber)
        assert rel(got.evm[:, i].numpy(), want[s].evm) < 1e-4
        np.testing.assert_allclose(got.bf_gain[:, i].numpy(),
                                   want[s].bf_gain, atol=1e-4)
        nm = nmse_subk(ref, torch.tensor(pools[s][:n])).numpy()
        np.testing.assert_allclose(nm, want[s].nmse, rtol=1e-6, atol=1e-30)


def test_batching_and_chunks_change_nothing(port_ds):
    """evaluate_closed_loop (chunks of 3 packets × 4 sources) against a
    loop of one packet at a time (its 4 sources a batch) on the same
    draws: the BER equal, EVM and BF gain to 1e-6."""
    preds = port_ds.h_ls * 0.5
    out = pcl.evaluate_closed_loop(port_ds, predictions=preds, chunk=3,
                                   fft_size=FFT, device="cpu")
    assert set(out) == set(SOURCES)
    pools = {"ls": port_ds.h_ls, "lmmse": port_ds.h_mmse, "dnn": preds,
             "perfect": port_ds.h_perfect}
    scen = port_ds.scenario
    for p in range(port_ds.num_packets):
        chan = channel_from_draws(
            CFG, scen, draw_channel(CFG, [port_ds.packet_generator(p)]))
        draws = draw_data_tx(CFG, [pcl.eval_generator(1234, p, "cpu")])
        r = data_tx_from_draws(
            CFG, scen, chan,
            torch.tensor(np.stack([pools[s][p] for s in SOURCES])),
            torch.tensor(port_ds.noise_db[p]),
            torch.tensor(port_ds.snr_cs[p]), draws, fft_size=FFT)
        for i, s in enumerate(SOURCES):
            assert float(r.ber[i]) == out[s].ber[p]
            assert abs(float(r.evm[i]) - out[s].evm[p]) \
                <= 1e-6 * out[s].evm[p]
            assert abs(float(r.bf_gain[i]) - out[s].bf_gain[p]) <= 1e-6 * max(
                1.0, abs(out[s].bf_gain[p]))


def test_closed_loop_physics(port_ds):
    """JAX's checks (test_closed_loop.py): perfect CSI decodes at 10 dB
    with a strong beamforming gain; the NMSE ranking holds."""
    out = pcl.evaluate_closed_loop(port_ds, predictions=port_ds.h_ls * 0.5,
                                   fft_size=FFT, device="cpu")
    m = out["perfect"]
    assert m.ber.shape == (4,)
    assert np.mean(m.ber) < 0.05, m.ber
    assert np.all(m.evm > 0)
    assert np.mean(m.bf_gain) > 3.0, m.bf_gain
    s = {k: v.summary() for k, v in out.items()}
    assert s["perfect"]["nmse"] < s["ls"]["nmse"] < s["dnn"]["nmse"]
    for k in s:
        assert np.isfinite(s[k]["ber"]) and np.isfinite(s[k]["evm"])


def test_closed_loop_two_stream_ura():
    """num_sts = 2 through the [4×2]-URA array on the port's own dataset:
    perfect CSI decodes most packets, EVM stays physical."""
    cfg = SimConfig(num_tx=8, num_rx=4, num_sts=2, n_scatterers=16,
                    n_rays=64, num_data_symbols=4)
    ds = generate_dataset(cfg, seed=7, num_packets=3, snr_db=15.0, chunk=3,
                          fft_size=8192, device="cpu")
    m = pcl.evaluate_closed_loop(ds, sources=("perfect", "ls"),
                                 fft_size=FFT, device="cpu")["perfect"]
    assert np.all(np.isfinite(m.ber)) and np.all(np.isfinite(m.evm))
    assert np.median(m.ber) < 0.01, m.ber
    assert np.all(m.evm < 100.0), m.evm


def test_with_ber_leaves_the_sounding_bit_equal(port_ds):
    ds = generate_dataset(CFG, seed=5, num_packets=4, snr_db=10.0,
                          with_mmse=True, chunk=3, fft_size=8192,
                          with_ber=True, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ds, f), getattr(port_ds, f))
    assert ds.ber.shape == (4,) and np.all((ds.ber >= 0) & (ds.ber <= 1))
    assert np.mean(ds.ber) < 0.05                  # LS CSI at 10 dB decodes
    cut = ds.extract_packets(2)
    np.testing.assert_array_equal(cut.ber, ds.ber[2:])
    assert port_ds.ber is None


def test_compute_ci_matches_jax():
    rng = np.random.default_rng(0)
    for x in (np.asarray([1.0, 2.0, 3.0, 4.0, 5.0]), rng.standard_normal(9),
              np.asarray([2.5])):
        np.testing.assert_allclose(psw.compute_ci(x), j_compute_ci(x),
                                   rtol=1e-12)
    lo, hi = psw.compute_ci(np.asarray([1.0, 2.0, 3.0, 4.0, 5.0]))
    assert lo < 3.0 < hi and abs((3.0 - lo) - (hi - 3.0)) < 1e-9


def test_run_snr_sweep_smoke(tmp_path):
    res = psw.run_snr_sweep(CFG, snr_levels=[0.0, 10.0], num_packets=3,
                            seed=5, with_mmse=False, chunk=4, verbose=False,
                            closed_loop=True, max_cl_packets=2,
                            predictor=lambda ds: ds.h_ls, device="cpu")
    assert len(res.nmse["ls"]) == 2 and len(res.ber["perfect"]) == 2
    assert res.nmse["ls"][0] > res.nmse["ls"][1]
    assert res.nmse["dnn"] == res.nmse["ls"]
    path = os.path.join(str(tmp_path), "sweep.json")
    res.save(path)
    assert os.path.exists(path)
    if psw.plot_sweep(res, str(tmp_path)):
        assert os.path.exists(os.path.join(str(tmp_path), "MSE.png"))


def test_sweep_handles_missing_mmse(port_ds):
    """A given dataset without h_mmse gives NaN series, not a KeyError,
    in the NMSE and the closed-loop series."""
    ds = dataclasses.replace(port_ds, h_mmse=None)
    res = psw.run_snr_sweep(CFG, snr_levels=[10.0], num_packets=4,
                            datasets={10.0: ds}, closed_loop=True,
                            max_cl_packets=1, verbose=False, device="cpu")
    assert np.isnan(res.nmse["lmmse"][0]) and np.isnan(res.ber["lmmse"][0])
    assert np.isfinite(res.nmse["ls"][0]) and np.isfinite(res.ber["ls"][0])
