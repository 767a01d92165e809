"""The port's single-user dataset generation and its container
(mamimo_tpu_torch.pipeline.dataset), the bench's generation line and
``ls_fft`` path, and the generated corpus served by
``CSIPredictor.estimate_full``, on the CPU at Nt 8, Nr 2.

The port's packets are its own draws (one generator per packet, seeded
from (seed, packet)), so generation is held to itself across chunk sizes
and regeneration, the container to the JAX package's through files each
package writes, and the math to JAX in test_torch_sounding.py.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.pipeline.dataset import CSIDataset as JCSIDataset
from mamimo_tpu.pipeline.dataset import generate_dataset as j_generate
from mamimo_tpu_torch import bench
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import init_stacked
from mamimo_tpu_torch.models.predictor import CSIPredictor
from mamimo_tpu_torch.pipeline.dataset import CSIDataset, generate_dataset
from mamimo_tpu_torch.pipeline.sounding import draw_sounding, sound_from_draws
from mamimo_tpu_torch.train.ckpt import save_checkpoint

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG = SimConfig(**KW)
ARRAYS = ("rx", "h_ls", "h_perfect", "h_mmse", "snr_cs", "noise_db", "tau",
          "chan_delay")


def _nmse_db(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    with np.errstate(divide="ignore"):
        return 10 * np.log10(np.sum(np.abs(a - b) ** 2)
                             / np.sum(np.abs(b) ** 2))


@pytest.fixture(scope="module")
def ds():
    """5 packets at 5 dB with CG LMMSE labels, 2 packets a chunk."""
    return generate_dataset(CFG, seed=3, num_packets=5, snr_db=5.0,
                            with_mmse=True, chunk=2, device="cpu")


def test_dataset_shapes_and_physics(ds):
    c, nt, nr = CFG.num_carriers, CFG.num_tx, CFG.num_rx
    assert ds.rx.shape == (5, CFG.len_ltf, nr) and ds.rx.dtype == np.complex64
    for f in ("h_ls", "h_perfect", "h_mmse"):
        assert getattr(ds, f).shape == (5, c, nt, nr)
    assert ds.snr_cs.shape == (5, nr) and ds.noise_db.shape == (5,)
    assert ds.tau.shape == (5, CFG.n_scatterers)
    assert ds.chan_delay.dtype == np.int32
    assert ds.num_samples == 5 * nt * nr and ds.device == "cpu"
    assert all(np.isfinite(getattr(ds, f)).all() for f in ARRAYS)
    assert abs(ds.snr_cs.mean() - 5.0) < 1.0
    # the sounding's physics: LS NMSE ≈ −SNR − 0.65 dB
    assert -8.0 < _nmse_db(ds.h_ls, ds.h_perfect) < -5.0


def test_chunk_size_does_not_change_the_dataset(ds):
    """Each packet comes from its own generator: 5 packets in one chunk
    equal 5 packets two at a time."""
    one = generate_dataset(CFG, seed=3, num_packets=5, snr_db=5.0,
                           with_mmse=True, chunk=5, device="cpu")
    for f in ARRAYS:
        assert _nmse_db(getattr(one, f), getattr(ds, f)) < -100.0, f
    np.testing.assert_array_equal(one.chan_delay, ds.chan_delay)


def test_packet_generator_regenerates_a_packet(ds):
    draws = draw_sounding(CFG, [ds.packet_generator(3)], ds.noise_mode)
    res, _ = sound_from_draws(CFG, ds.scenario, draws, ds.snr_target,
                              with_mmse=True)
    for f in ARRAYS:
        assert _nmse_db(getattr(res, f)[0].numpy(),
                        getattr(ds, f)[3]) < -100.0, f


def test_save_is_read_by_jax_and_jax_save_by_the_port(ds, tmp_path):
    """The .npz container across the two packages, both ways."""
    p = str(tmp_path / "port.npz")
    ds.save(p)
    j = JCSIDataset.load(p)
    assert j.cfg == JSimConfig(**KW)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(j, f), getattr(ds, f))
    for k, v in ds.scenario._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(j.scenario, k)),
                                      v.numpy())
    assert (j.snr_target, j.seed, j.user, j.noise_mode) == (5.0, 3, 0, "snr")
    back = CSIDataset.load(p)
    assert back.device == "cpu" and back.cfg == CFG
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(back, f), getattr(ds, f))

    jcfg = JSimConfig(num_tx=8, num_rx=2, n_scatterers=8)
    jds = j_generate(jcfg, seed=1, num_packets=2, snr_db=10.0, chunk=2,
                     fft_size=4096, noise_mode="sinr")
    q = str(tmp_path / "jax.npz")
    jds.save(q)
    got = CSIDataset.load(q)
    assert got.cfg == SimConfig(num_tx=8, num_rx=2, n_scatterers=8)
    assert got.h_mmse is None and got.noise_mode == "sinr"
    for f in ARRAYS:
        if f != "h_mmse":
            np.testing.assert_array_equal(getattr(got, f), getattr(jds, f))
    for k, v in jds.scenario._asdict().items():
        np.testing.assert_array_equal(getattr(got.scenario, k).numpy(),
                                      np.asarray(v))


def test_container_methods_match_jax(ds, tmp_path):
    """rx_planes, extract_packets (both ends), decompose_index and
    pilot_matrix against the JAX container holding the same arrays."""
    p = str(tmp_path / "d.npz")
    ds.save(p)
    j = JCSIDataset.load(p)
    np.testing.assert_array_equal(ds.rx_planes(), j.rx_planes())
    for reverse in (True, False):
        a, b = ds.extract_packets(2, reverse), j.extract_packets(2, reverse)
        assert a.num_packets == b.num_packets == 2
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    idx = np.arange(ds.num_samples)
    for got, want in zip(ds.decompose_index(idx), j.decompose_index(idx)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ds.pilot_matrix(), j.pilot_matrix())


def test_bf16_fetch_and_its_refusal(ds):
    """The bf16 drain is about -50 dB from the exact one on the complex
    arrays and exact on the real ones; noiseless labels are refused."""
    b = generate_dataset(CFG, seed=3, num_packets=5, snr_db=5.0,
                         with_mmse=True, chunk=2, fetch_dtype="bf16",
                         device="cpu")
    for f in ("rx", "h_ls", "h_perfect", "h_mmse"):
        assert -60.0 < _nmse_db(getattr(b, f), getattr(ds, f)) < -45.0, f
    for f in ("snr_cs", "noise_db", "tau", "chan_delay"):
        np.testing.assert_array_equal(getattr(b, f), getattr(ds, f))
    with pytest.raises(ValueError, match="noiseless"):
        generate_dataset(CFG, seed=3, num_packets=1, snr_db=60.0,
                         fetch_dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="fetch_dtype"):
        generate_dataset(CFG, seed=3, num_packets=1, snr_db=5.0,
                         fetch_dtype="f16", device="cpu")


@pytest.mark.parametrize("what", ["with_ber", "num_users", "user",
                                  "save_raw"])
def test_unported_branches_raise(ds, what, tmp_path):
    """The branches that later slices ported: save_raw writes the raw
    container, which the loader reads back as the dataset's arrays;
    with_ber adds the data leg's BER and leaves the sounding as it was;
    num_users > 1 generates user 0's dataset of a multi-user experiment;
    a user other than 0 of a single-user configuration raises."""
    if what == "save_raw":
        from mamimo_tpu_torch.data.native_loader import NativeBatchLoader

        ds.save_raw(str(tmp_path / "raw"))
        with NativeBatchLoader(str(tmp_path / "raw")) as ld:
            sig, y = ld.gather_packets(np.arange(ds.num_packets))
        np.testing.assert_array_equal(sig[0] + 1j * sig[1], ds.rx)
        np.testing.assert_array_equal(y[0] + 1j * y[1], ds.h_ls)
        return
    if what == "user":
        with pytest.raises(ValueError, match="single-user"):
            generate_dataset(CFG, seed=0, num_packets=1, snr_db=5.0,
                             device="cpu", user=1)
        return
    kw = {"with_ber": dict(with_ber=True)}.get(what, {})
    cfg = CFG.replace(num_users=2) if what == "num_users" else CFG
    d = generate_dataset(cfg, seed=3, num_packets=2, snr_db=5.0,
                         with_mmse=True, chunk=2, device="cpu", **kw)
    assert d.rx.shape == (2, CFG.len_ltf, CFG.num_rx)
    if what == "with_ber":
        assert d.ber.shape == (2,) and np.all(np.isfinite(d.ber))
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(d, f), getattr(ds, f)[:2])
    else:
        assert d.ber is None and d.user == 0
        assert not np.array_equal(d.rx, ds.rx[:2])


@pytest.mark.parametrize("cfg_kw,mode", [({}, "nf"), ({}, "sinr"),
                                         ({"channel_model": "cdl_nlos"},
                                          "snr"),
                                         ({"channel_model": "fir"}, "snr")])
def test_noise_modes_and_channel_models_generate(cfg_kw, mode):
    cfg = CFG.replace(**cfg_kw)
    d = generate_dataset(cfg, seed=4, num_packets=3, snr_db=10.0,
                         noise_mode=mode, chunk=2, with_mmse=True,
                         mmse_estimator="direct", device="cpu")
    assert d.noise_mode == mode
    assert all(np.isfinite(getattr(d, f)).all() for f in ARRAYS)
    # LS NMSE ≈ −(realized SNR) − 0.65 dB in every mode (nf and sinr
    # realize about −20 dB here)
    snr = float(d.snr_cs.mean())
    assert -snr - 3.0 < _nmse_db(d.h_ls, d.h_perfect) < -snr


def test_generated_corpus_served_by_estimate_full(ds, tmp_path):
    """The slice as a whole: the corpus's received preambles, as the
    canonical planes, through CSIPredictor.estimate_full (the CPU's
    plain versions here): its LS is the corpus's LS, rx-major."""
    tcfg = TrainConfig(hidden=(32, 32))
    params, bn = init_stacked(torch.Generator().manual_seed(0), CFG, tcfg)
    save_checkpoint(str(tmp_path / "best"), CFG, tcfg, params, bn)
    pred = CSIPredictor(str(tmp_path), device="cpu")
    planes = ds.rx_planes()
    assert planes.shape == (2, 5 * CFG.num_rx, CFG.len_ltf)
    h_ls, h_dnn = pred.estimate_full(planes)
    want = ds.h_ls.transpose(0, 3, 2, 1).reshape(h_ls.shape)
    assert _nmse_db(h_ls, want) < -100.0
    assert h_dnn.shape == h_ls.shape and np.isfinite(h_dnn).all()


def test_run_gen_bench_line(monkeypatch):
    monkeypatch.setenv("BENCH_NT", "8")
    monkeypatch.setenv("BENCH_NR", "2")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bench.run_gen_bench(num_packets=4, chunk=2, device="cpu")
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(
        json.dumps(res))
    assert (res["metric"], res["unit"]) == ("gen_packets_per_s", "packets/s")
    extra = res["extra"]
    assert (extra["device"], extra["num_packets"], extra["chunk"],
            extra["config"]) == ("cpu", 4, 2, "BS8")
    assert tuple(extra["modes"]) == ("ls", "ls_bf16fetch", "lmmse",
                                     "with_ber", "device_sounding")
    for m in extra["modes"].values():
        assert m["packets_per_s"] > 0 and m["wall_s"] > 0
        assert m["estimates_per_s"] == pytest.approx(
            m["packets_per_s"] * 16)
    assert res["value"] == extra["modes"]["ls"]["packets_per_s"]


def test_bench_ls_fft_path_is_the_ls():
    """bench_paths' ls_fft (estimate_from_rx on the time-major preambles)
    equals the ls_matmul path."""
    tcfg = TrainConfig(hidden=(32, 32))
    params, bn = init_stacked(torch.Generator().manual_seed(1), CFG, tcfg)
    paths = bench.bench_paths(CFG, tcfg, params, bn)
    planes = torch.randn((2, 3 * CFG.num_rx, CFG.len_ltf),
                         generator=torch.Generator().manual_seed(2))
    fft_form = paths["ls_fft"][0](planes)
    assert paths["ls_fft"][1] is False
    assert tuple(fft_form.shape) == (3, CFG.num_carriers, CFG.num_tx,
                                     CFG.num_rx)
    assert _nmse_db(fft_form.numpy(),
                    paths["ls_matmul"][0](planes).numpy()) < -100.0


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        generate_dataset(CFG, seed=0, num_packets=1, snr_db=5.0)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.run_gen_bench(num_packets=1, chunk=1, print_result=False)
