"""The port's fit and evaluate_dataset (mamimo_tpu_torch.train.loop),
metrics (ops.metrics) and nmse_vs_snr (eval.closed_loop) against the JAX
package on the CPU, at Nt 4, Nr 2, hidden (32, 32).

The corpora come from the port's generate_dataset on the CPU; the same
numpy arrays go into a JAX CSIDataset. Where two fits are compared both
packages resume from one epoch-0 ``last`` checkpoint written by JAX's
save_checkpoint with its optimizer state, with method 'default' and
dropout 0 (the step is then deterministic in both). The per-epoch
losses are held to 1e-4 relative, the lr trace and epochs_ran exactly,
and the best parameters as one vector to 1e-3 of its norm (Adam turns
rounding noise into steps, so leaves can be further apart).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.eval import closed_loop as jcl
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops import metrics as jmetrics
from mamimo_tpu.pipeline.dataset import CSIDataset as JCSIDataset
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu.train import loop as jloop
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.eval.closed_loop import nmse_vs_snr
from mamimo_tpu_torch.ops import metrics
from mamimo_tpu_torch.pipeline.dataset import CSIDataset, generate_dataset
from mamimo_tpu_torch.train import loop
from mamimo_tpu_torch.train.ckpt import load_checkpoint

TINY = SimConfig(num_tx=4, num_rx=2, n_scatterers=10, n_rays=20)
JTINY = JSimConfig(**dataclasses.asdict(TINY))
HIDDEN = (32, 32)


def _jax_ds(ds: CSIDataset) -> JCSIDataset:
    """The JAX package's CSIDataset holding the port dataset's arrays."""
    return JCSIDataset(
        cfg=JTINY, rx=ds.rx, h_ls=ds.h_ls, h_perfect=ds.h_perfect,
        snr_cs=ds.snr_cs, noise_db=ds.noise_db, tau=ds.tau,
        chan_delay=ds.chan_delay, snr_target=ds.snr_target, seed=ds.seed,
        scenario=None, h_mmse=ds.h_mmse)


@pytest.fixture(scope="module")
def corpora():
    """(train corpus, 12 packets of seed 0 at 120 dB; val corpus, 4
    packets of another placement, seed 7), port and JAX datasets."""
    tr = generate_dataset(TINY, seed=0, num_packets=12, snr_db=120.0,
                          chunk=12, fft_size=4096, device="cpu")
    va = generate_dataset(TINY, seed=7, num_packets=4, snr_db=120.0,
                          chunk=4, fft_size=4096, device="cpu")
    return {"train": (tr, _jax_ds(tr)), "val": (va, _jax_ds(va))}


@pytest.fixture(scope="module")
def test_corpus():
    """4 packets at 10 dB with LMMSE labels (for the metrics)."""
    ds = generate_dataset(TINY, seed=3, num_packets=4, snr_db=10.0,
                          with_mmse=True, chunk=4, fft_size=4096,
                          device="cpu")
    return ds, _jax_ds(ds)


def _tcfgs(**kw):
    kw = {"hidden": HIDDEN, "batch_size": 16, "dropout": 0.0,
          "method": "default", "seed": 1, **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _vector(tree, jax_tree=False):
    leaves = (jax.tree_util.tree_leaves(tree) if jax_tree
              else loop.tree_leaves(tree))
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in leaves])


def _seed_workdir(path, jtcfg, seed=5):
    """An epoch-0 'last' checkpoint written by JAX, with its optimizer
    state; returns the JAX parameters."""
    p, b = jmlp.init_stacked(jax.random.PRNGKey(seed), JTINY, jtcfg)
    jckpt.save_checkpoint(os.path.join(path, "last"), JTINY, jtcfg, p, b,
                          extra={"epoch": 0},
                          opt_state=jloop.make_optimizer(jtcfg).init(p))
    return p, b


MODES = {"in_hbm": {}, "host_stream": {"host_stream": True},
         "window": {"host_stream": True, "stream_window_packets": 4}}


@pytest.mark.parametrize("mode", list(MODES))
def test_fit_matches_jax(mode, corpora, tmp_path):
    """Each single-card mode against the same JAX mode, from one JAX
    checkpoint: val on another placement rises after epoch 1 at lr 1e-2,
    so the plateau (patience 1) cuts the lr twice and the early stop
    (patience 3) ends the run at epoch 4 of 12, in both packages."""
    tcfg, jtcfg = _tcfgs(lr=1e-2, epochs=12, plateau_patience=1,
                         early_stop_patience=3, steps_per_call=2)
    (tr, jtr), (va, jva) = corpora["train"], corpora["val"]
    _seed_workdir(str(tmp_path / "seed"), jtcfg)
    for who in ("jax", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / who)
    rj = jloop.fit(JTINY, jtcfg, jtr, val_ds=jva, workdir=str(tmp_path /
                   "jax"), verbose=False, resume=True, **MODES[mode])
    rp = loop.fit(TINY, tcfg, tr, val_ds=va, workdir=str(tmp_path / "port"),
                  verbose=False, resume=True, device="cpu", **MODES[mode])
    assert rp.epochs_ran == rj.epochs_ran == 4
    assert rp.history["lr"] == rj.history["lr"]
    assert rj.history["lr"] == pytest.approx([1e-2, 1e-2, 1e-3, 1e-4])
    for k in ("loss_real", "loss_imag", "val_loss_real", "val_loss_imag"):
        np.testing.assert_allclose(rp.history[k], rj.history[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(rp.best_val, rj.best_val, rtol=1e-4)
    vj = _vector(rj.params, jax_tree=True)
    vp = _vector(rp.params)
    assert np.linalg.norm(vp - vj) <= 1e-3 * np.linalg.norm(vj)
    # the artifacts: history.json, best and last (with the optimizer
    # state) in the JAX layout
    with open(tmp_path / "port" / "history.json") as f:
        assert json.load(f) == rp.history
    last = json.loads((tmp_path / "port" / "last.json").read_text())
    assert last["extra"]["epoch"] == 4 and last["has_opt"]
    best = load_checkpoint(str(tmp_path / "port" / "best"))
    np.testing.assert_array_equal(
        _vector(best["params"]), vp.astype(np.float32))


@pytest.mark.parametrize(
    "packets,ratio,same", [(1, 0.15, False), (2, 0.15, False),
                           (7, 0.15, False), (12, 0.15, False),
                           (12, 0.0, False), (20, 0.5, False),
                           (12, 0.15, True)])
def test_split_indices_matches_jax(packets, ratio, same):
    rng = np.random.default_rng(packets)
    ds = CSIDataset(cfg=TINY, rx=np.zeros((packets, 1, 2), np.complex64),
                    h_ls=None, h_perfect=None, snr_cs=None, noise_db=None,
                    tau=None, chan_delay=None, snr_target=0.0,
                    seed=int(rng.integers(9)), scenario=None)
    jds = JCSIDataset(cfg=JTINY, rx=ds.rx, h_ls=None, h_perfect=None,
                      snr_cs=None, noise_db=None, tau=None, chan_delay=None,
                      snr_target=0.0, seed=0, scenario=None)
    kw = {"val_train_ratio": ratio, "val_same_train": same}
    got = loop._split_indices(ds, TrainConfig(**kw))
    want = jloop._split_indices(jds, JTrainConfig(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_steps_per_call_equals_single_steps(corpora):
    """steps_per_call 4 (groups through make_train_step(...).multi, the
    val pass through eval_step.multi) trains as steps_per_call 1."""
    tr, _ = corpora["train"]
    tcfg, _ = _tcfgs(epochs=3, early_stop_patience=50)
    r1 = loop.fit(TINY, tcfg, tr, verbose=False, device="cpu")
    r4 = loop.fit(TINY, tcfg.replace(steps_per_call=4), tr, verbose=False,
                  device="cpu")
    for k in r1.history:
        np.testing.assert_allclose(r4.history[k], r1.history[k], rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_vector(r4.params), _vector(r1.params),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["in_hbm", "host_stream"])
def test_resume_equals_uninterrupted_with_awgn(mode, corpora, tmp_path):
    """With the AWGN on (rbg_clt, default_snr) and dropout, 2 epochs then
    a resume to 3 draw what 3 epochs straight draw: the same history,
    best weights and checkpoints."""
    tr, _ = corpora["train"]
    tcfg = TrainConfig(hidden=HIDDEN, batch_size=16, epochs=3, seed=4,
                       steps_per_call=2, early_stop_patience=50)
    straight = loop.fit(TINY, tcfg, tr, workdir=str(tmp_path / "a"),
                        verbose=False, device="cpu", **MODES[mode])
    loop.fit(TINY, tcfg.replace(epochs=2), tr, workdir=str(tmp_path / "b"),
             verbose=False, device="cpu", **MODES[mode])
    resumed = loop.fit(TINY, tcfg, tr, workdir=str(tmp_path / "b"),
                       verbose=False, resume=True, device="cpu",
                       **MODES[mode])
    assert resumed.epochs_ran == straight.epochs_ran == 3
    for k in straight.history:
        np.testing.assert_allclose(resumed.history[k], straight.history[k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(_vector(resumed.params),
                               _vector(straight.params), rtol=1e-6,
                               atol=1e-7)
    a = load_checkpoint(str(tmp_path / "a" / "last"))
    b = load_checkpoint(str(tmp_path / "b" / "last"))
    np.testing.assert_allclose(_vector(b["params"]), _vector(a["params"]),
                               rtol=1e-6, atol=1e-7)


def test_fit_with_awgn_reduces_loss_and_beats_noise(corpora, tmp_path):
    """The default step (AWGN at the six SNR levels, rbg_clt, dropout
    0.15) fits the noiseless labels (tests/test_model_train.py:80): the
    loss falls, the predictions are finite and closer to h_ls than zero
    is, and the workdir holds history.json and the best checkpoint."""
    tr, _ = corpora["train"]
    tcfg = TrainConfig(hidden=(64, 32), batch_size=16, epochs=4,
                       early_stop_patience=50, seed=1)
    res = loop.fit(TINY, tcfg, tr, workdir=str(tmp_path), verbose=False,
                   device="cpu")
    h = res.history
    assert h["loss_real"][-1] < h["loss_real"][0]
    assert h["loss_imag"][-1] < h["loss_imag"][0]
    assert np.all(np.isfinite(res.best_val))
    pred, mse = loop.evaluate_dataset(TINY, tcfg, res.params, res.bn_state,
                                      tr, device="cpu")
    assert pred.shape == tr.h_ls.shape and pred.dtype == np.complex64
    assert np.all(np.isfinite(mse))
    assert np.mean(np.abs(pred - tr.h_ls) ** 2) < np.mean(
        np.abs(tr.h_ls) ** 2)
    ck = load_checkpoint(str(tmp_path / "best"))
    np.testing.assert_array_equal(_vector(ck["params"]),
                                  _vector(res.params).astype(np.float32))
    assert os.path.exists(tmp_path / "history.json")


def test_fit_refuses_mesh_and_a_missing_card(corpora):
    """No silent fallback: fit(mesh=...) refuses what is not a mesh of the
    port, or one without a 'data' axis (the sharded modes themselves are
    in tests/test_torch_sharded_train.py); the default device is the
    card, and there is none here."""
    from mamimo_tpu_torch.parallel.mesh import make_mesh

    tr, _ = corpora["train"]
    tcfg, _ = _tcfgs(epochs=1)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        loop.fit(TINY, tcfg, tr, mesh=object(), verbose=False, device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        loop.fit(TINY, tcfg, tr, verbose=False,
                 mesh=make_mesh({"model": 2}, devices=["cpu"] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            loop.fit(TINY, tcfg, tr, verbose=False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            loop.evaluate_dataset(TINY, tcfg, None, None, tr)


def _trained(jtcfg, seed=6):
    """JAX weights with a non-trivial BN state (numpy leaves)."""
    p, b = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), JTINY, jtcfg))
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)                    # noqa: E731
    b = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in b["mean"]],
         "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in b["var"]]}
    return p, b


@pytest.mark.parametrize("norm", ["none", "rms"])
def test_evaluate_dataset_matches_jax(norm, test_corpus):
    """evaluate_dataset on the same weights: predictions and per-plane MSE
    to 1e-5, in the (B, C, T, R) order; 3 packets a batch leaves a short
    last batch."""
    ds, jds = test_corpus
    tcfg, jtcfg = _tcfgs(input_norm=norm)
    p, b = _trained(jtcfg)
    want, wmse = jloop.evaluate_dataset(JTINY, jtcfg, p, b, jds,
                                        batch_packets=3)
    got, gmse = loop.evaluate_dataset(TINY, tcfg, p, b, ds, batch_packets=3,
                                      device="cpu")
    assert got.shape == want.shape == ds.h_ls.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_allclose(gmse, wmse, rtol=1e-5)


def test_drop_input_changes_prediction(test_corpus):
    """--testDropInput: masked inputs move the prediction; the same seed
    gives the same mask, another seed another."""
    ds, _ = test_corpus
    tcfg, jtcfg = _tcfgs()
    p, b = _trained(jtcfg)
    ev = lambda **kw: loop.evaluate_dataset(  # noqa: E731
        TINY, tcfg, p, b, ds, device="cpu", **kw)[0]
    plain = ev()
    a, a2, c = (ev(drop_input=True, drop_seed=s) for s in (9, 9, 10))
    assert not np.allclose(plain, a)
    np.testing.assert_array_equal(a, a2)
    assert not np.allclose(a, c)


def test_port_checkpoint_serves_in_jax(corpora, test_corpus, tmp_path):
    """A checkpoint fit writes loads in JAX's load_checkpoint and serves
    there what the port serves."""
    tr, _ = corpora["train"]
    ds, jds = test_corpus
    tcfg, _ = _tcfgs(epochs=2, early_stop_patience=50)
    res = loop.fit(TINY, tcfg, tr, workdir=str(tmp_path), verbose=False,
                   device="cpu")
    ck = jckpt.load_checkpoint(str(tmp_path / "best"))
    assert ck["tcfg"] == JTrainConfig(**dataclasses.asdict(tcfg))
    want, _ = jloop.evaluate_dataset(JTINY, ck["tcfg"], ck["params"],
                                     ck["bn_state"], jds)
    got, _ = loop.evaluate_dataset(TINY, tcfg, res.params, res.bn_state, ds,
                                   device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_nmse_vs_snr_and_metrics_match_jax(test_corpus):
    """nmse_vs_snr per source and the four metrics, on the same arrays."""
    ds, jds = test_corpus
    rng = np.random.default_rng(4)
    pred = (ds.h_ls + 0.1 * rng.standard_normal(ds.h_ls.shape)).astype(
        np.complex64)
    got = nmse_vs_snr(ds, pred, device="cpu")
    want = jcl.nmse_vs_snr(jds, pred)
    assert list(got) == list(want) == ["ls", "lmmse", "dnn"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert list(nmse_vs_snr(dataclasses.replace(ds, h_mmse=None),
                            device="cpu")) == ["ls"]
    ref, est = ds.h_perfect, ds.h_ls
    for name, a, b in (("nmse_subk", ref, est), ("mse_abs", ref, est)):
        np.testing.assert_allclose(
            getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b)),
            getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)),
            rtol=1e-5, err_msg=name)
    const = np.asarray([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                       np.complex64) / np.sqrt(2)
    syms = (const[rng.integers(0, 4, (3, 50))]
            + 0.1 * rng.standard_normal((3, 50))).astype(np.complex64)
    np.testing.assert_allclose(
        metrics.evm_rms(torch.from_numpy(syms), torch.from_numpy(const)),
        jmetrics.evm_rms(syms, const), rtol=1e-5)
    tx = rng.integers(0, 2, (3, 64))
    rx = np.where(rng.random((3, 64)) < 0.1, 1 - tx, tx)
    np.testing.assert_array_equal(
        metrics.bit_error_rate(torch.from_numpy(tx), torch.from_numpy(rx)),
        jmetrics.bit_error_rate(tx, rx))


def test_train_parity_placement_is_jaxs_seed_21():
    """tools/train_parity.py's placement is the one the JAX
    package draws for seed 21 at BS32 (the recipe of
    results/train_parity.json), and the port's geometry from those draws
    is JAX's."""
    from mamimo_tpu.channel.scattering import make_scenario

    from mamimo_tpu_torch.tools import train_parity

    jcfg = JSimConfig()
    want = make_scenario(jcfg, jax.random.split(jax.random.PRNGKey(21))[0])
    got = train_parity.jax_placement(SimConfig(), torch.device("cpu"))
    for k in ("mobile_range", "mobile_az", "mobile_el"):
        assert np.float32(train_parity.JAX_SEED21_PLACEMENT[k]) == \
            np.asarray(getattr(want, k)), k
    for k in ("mobile_range", "mobile_az", "mobile_el", "rx_pos",
              "sp_loss_db", "tx_elem", "rx_elem"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_train_parity_reads_the_epoch_a_resume_starts_from(tmp_path):
    """tools/train_parity.py counts a variant's epochs from the epoch its
    workdir's 'last' checkpoint resumes at (0 for a new workdir), so a
    fit that ran none is refused."""
    from mamimo_tpu_torch.tools import train_parity

    assert train_parity.resumed_epoch(str(tmp_path / "new")) == 0
    _, jtcfg = _tcfgs()
    p, b = jmlp.init_stacked(jax.random.PRNGKey(0), JTINY, jtcfg)
    jckpt.save_checkpoint(str(tmp_path / "last"), JTINY, jtcfg, p, b,
                          extra={"epoch": 7})
    assert train_parity.resumed_epoch(str(tmp_path)) == 7
