"""The port's data I/O (mamimo_tpu_torch.data: the raw container and its
native loader, the MATLAB and pickle formats, the datasource registry;
CSIDataset.save_raw) against the JAX package on the same numpy arrays.

The native loader is built with g++ into mamimo_tpu_torch/_build/ on
first use; the plain NumPy gather (native=False) is held to it bit for
bit. Arrays are made from a seed with numpy at Nt 4, Nr 2.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from mamimo_tpu.data import matlab_io as jmio
from mamimo_tpu.data import native_loader as jnl
from mamimo_tpu.data import sources as jsrc
from mamimo_tpu.pipeline.dataset import CSIDataset as JCSIDataset
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.data import matlab_io as mio
from mamimo_tpu_torch.data import native_loader as nl
from mamimo_tpu_torch.data import sources as src
from mamimo_tpu_torch.pipeline.dataset import CSIDataset

CFG = SimConfig(num_tx=4, num_rx=2, n_scatterers=10)
B = 5


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def arrays():
    """(rx (B, L, R), h_ls (B, C, T, R)) complex64 from a seed."""
    rng = np.random.default_rng(0)
    return (_crandn(rng, B, CFG.len_ltf, CFG.num_rx),
            _crandn(rng, B, CFG.num_carriers, CFG.num_tx, CFG.num_rx))


@pytest.fixture(scope="module")
def raw_files(arrays, tmp_path_factory):
    """The same arrays written by each package: {"jax": path, "port":
    path}."""
    d = tmp_path_factory.mktemp("raw")
    paths = {"jax": str(d / "jax.raw"), "port": str(d / "port.raw")}
    jnl.write_raw(paths["jax"], *arrays)
    nl.write_raw(paths["port"], *arrays)
    return paths


def _dataset(arrays, cls, cfg):
    """A CSIDataset of the package of ``cls`` holding ``arrays``."""
    rx, h = arrays
    z = np.zeros
    return cls(cfg=cfg, rx=rx, h_ls=h, h_perfect=h, snr_cs=z((B, 2)),
               noise_db=z(B), tau=z((B, 10)), chan_delay=z(B, np.int32),
               snr_target=120.0, seed=0, scenario=None)


def test_write_raw_bytes_equal_jax(arrays, raw_files, tmp_path):
    """write_raw and CSIDataset.save_raw write JAX's bytes."""
    with open(raw_files["jax"], "rb") as f:
        want = f.read()
    with open(raw_files["port"], "rb") as f:
        assert f.read() == want
    from mamimo_tpu.config import SimConfig as JSimConfig

    jcfg = JSimConfig(**dataclasses.asdict(CFG))
    _dataset(arrays, CSIDataset, CFG).save_raw(str(tmp_path / "p.raw"))
    _dataset(arrays, JCSIDataset, jcfg).save_raw(str(tmp_path / "j.raw"))
    assert (tmp_path / "p.raw").read_bytes() == want
    assert (tmp_path / "j.raw").read_bytes() == want


@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "plain"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loaders_read_each_others_files(raw_files, native, writer):
    """The port's loader (native and plain) reads either package's file,
    and JAX's loader the port's: gather, gather_packets and prefetch/wait
    equal JAX's, bit for bit."""
    idx = np.asarray([0, 5, 17, 3, B * 8 - 1, 9], np.int64)
    pkts = np.asarray([3, 0, B - 1], np.int64)
    other = "port" if writer == "jax" else "jax"
    with nl.NativeBatchLoader(raw_files[writer], native=native) as ld:
        ref = jnl.NativeBatchLoader(raw_files[other])
        assert ld.using_native == native
        assert (ld.B, ld.L, ld.R, ld.C, ld.T, ld.num_samples) == \
            (ref.B, ref.L, ref.R, ref.C, ref.T, ref.num_samples)
        for got, want in ((ld.gather(idx), ref.gather(idx)),
                          (ld.gather_packets(pkts), ref.gather_packets(pkts))):
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        # prefetch/wait: a hit, then back to back
        ld.prefetch(idx[::-1])
        for g, w in zip(ld.wait(), ref.gather(idx[::-1])):
            np.testing.assert_array_equal(g, w)
        ld.prefetch(idx[:2])
        first = ld.wait()
        ld.prefetch(idx[2:])
        second = ld.wait()
        np.testing.assert_array_equal(first[0], ref.gather(idx[:2])[0])
        np.testing.assert_array_equal(second[1], ref.gather(idx[2:])[1])
        ref.close()


@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "plain"])
def test_out_of_range_raises_as_jax(raw_files, native):
    """An index past the container raises IndexError with JAX's native
    message; a wait without a prefetch raises."""
    ref = jnl.NativeBatchLoader(raw_files["jax"])
    with nl.NativeBatchLoader(raw_files["port"], native=native) as ld:
        for call, arg in (("gather", [ld.num_samples]),
                          ("gather", [-1]),
                          ("gather_packets", [B])):
            with pytest.raises(IndexError) as want:
                getattr(ref, call)(np.asarray(arg))
            with pytest.raises(IndexError) as got:
                getattr(ld, call)(np.asarray(arg))
            assert str(got.value) == str(want.value)
        with pytest.raises(RuntimeError, match="no prefetch"):
            ld.wait()
    ref.close()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises, and so
    does a file that is no container."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", bad)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nl, "_lib", None)
    with pytest.raises(RuntimeError, match="native loader build failed"):
        nl.NativeBatchLoader(str(tmp_path / "x.raw"))
    monkeypatch.undo()
    junk = tmp_path / "junk.raw"
    junk.write_bytes(b"NOTRAW" + bytes(100))
    with pytest.raises(OSError):
        nl.NativeBatchLoader(str(junk))
    with pytest.raises(ValueError):
        nl.NativeBatchLoader(str(junk), native=False)


def test_native_library_in_port_build_dir():
    """The library is built into the port's _build/, never into the JAX
    loader's native/build/."""
    path = nl.build_library()
    assert path.parent == nl.REPO / "mamimo_tpu_torch" / "_build"
    assert path.exists()


def test_raw_matches(arrays, raw_files, tmp_path):
    """fit's stale-file guard: the file of the same arrays matches, other
    arrays or a missing file do not."""
    from mamimo_tpu_torch.train.loop import _raw_matches

    ds = _dataset(arrays, CSIDataset, CFG)
    assert _raw_matches(raw_files["jax"], ds)
    other = _dataset((arrays[0][::-1].copy(), arrays[1]), CSIDataset, CFG)
    assert not _raw_matches(raw_files["jax"], other)
    assert not _raw_matches(str(tmp_path / "none.raw"), ds)


def _complex_compound(arr):
    out = np.empty(arr.shape, dtype=[("real", "<f8"), ("imag", "<f8")])
    out["real"] = arr.real
    out["imag"] = arr.imag
    return out


def test_load_reference_mat_matches_jax(tmp_path):
    """The MATLAB v7.3 packet file of tests/test_matlab_io.py, read by
    both packages."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    nb, L, R, T, C = 3, 40, 2, 4, 234
    rx = (rng.standard_normal((nb, L, R))
          + 1j * rng.standard_normal((nb, L, R)))
    h_ls = (rng.standard_normal((nb, C, T, R))
            + 1j * rng.standard_normal((nb, C, T, R)))
    snr = rng.standard_normal((nb, 1, R))
    P = np.sign(rng.standard_normal((T, T)))
    path = str(tmp_path / "maMIMO_3___test.mat")
    with h5py.File(path, "w") as f:
        d_x = f.create_dataset("d_x", data=_complex_compound(
            rx.transpose(2, 1, 0)))
        d_y = f.create_dataset("d_y", data=_complex_compound(
            h_ls.transpose(3, 2, 1, 0)))
        d_s = f.create_dataset("d_s", data=snr.transpose(2, 1, 0))
        usr = f.create_dataset("usr_data", (3, 1), dtype=h5py.ref_dtype)
        usr[0, 0], usr[1, 0], usr[2, 0] = d_x.ref, d_y.ref, d_s.ref
        f.create_dataset("P", data=P.T)
        prm = f.create_group("prm")
        prm.create_dataset("FFTLength", data=np.asarray([[256.0]]))
        prm.create_dataset("CyclicPrefixLength", data=np.asarray([[64.0]]))
    got, want = mio.load_reference_mat(path), jmio.load_reference_mat(path)
    assert got.keys() == want.keys()
    for k in ("rx", "h_ls", "snr_cs", "P"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sim_params"] == want["sim_params"]
    np.testing.assert_allclose(got["rx"], rx.astype(np.complex64), rtol=1e-6)


def test_pickle_round_trip_with_jax(arrays, tmp_path):
    """The reference's dataset.b pickle: the port writes what JAX writes
    (same seed, same schema), and each package reads the other's."""
    rx, h = arrays
    P = np.sign(np.random.default_rng(1).standard_normal((4, 4)))
    sp = {"FFTLength": 256, "CPLen": 64, "nTX": 4, "nRX": 2}
    mio.save_pickle_dataset(rx, h, P, sp, str(tmp_path / "p.b"), seed=3)
    jmio.save_pickle_dataset(rx, h, P, sp, str(tmp_path / "j.b"), seed=3)
    with open(tmp_path / "p.b", "rb") as f:
        a = pickle.load(f)
    with open(tmp_path / "j.b", "rb") as f:
        b = pickle.load(f)
    np.testing.assert_array_equal(a["X"], b["X"])
    assert a["LTF"].keys() == b["LTF"].keys()
    for which, path in (("jax reads port", "p.b"), ("port reads jax", "j.b")):
        load = jmio.load_pickle_dataset if which == "jax reads port" \
            else mio.load_pickle_dataset
        d = load(str(tmp_path / path))
        np.testing.assert_array_equal(d["rx"], rx)
        np.testing.assert_array_equal(d["h_ls"], h)
        assert d["sim_params"] == sp


def test_export_predictions_mat_matches_jax(arrays, tmp_path):
    """The per-packet prediction .mat files of the MATLAB evaluator hold
    what JAX's hold."""
    from scipy.io import loadmat

    rx, h = arrays
    pred = h[:2] * 0.5
    P = np.sign(np.random.default_rng(2).standard_normal((4, 4)))
    mio.export_predictions_mat(str(tmp_path / "p"), pred, rx[:2], h[:2], P)
    jmio.export_predictions_mat(str(tmp_path / "j"), pred, rx[:2], h[:2], P)
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == files and len(files) == 4
    for name in files:
        a = loadmat(str(tmp_path / "p" / name))["all_pkts_csi_nn_out"]
        b = loadmat(str(tmp_path / "j" / name))["all_pkts_csi_nn_out"]
        for k in ("x", "y", "true_y"):
            np.testing.assert_array_equal(a[k][0, 0], b[k][0, 0])


def test_datasources_match_jax(arrays, tmp_path):
    """The registry holds JAX's names; mamimo_npz reads a port dataset
    file as JAX's reader does."""
    assert sorted(src._REGISTRY) == sorted(jsrc._REGISTRY)
    with pytest.raises(KeyError, match="unknown datasource"):
        src.get_datasource("nope")
    from mamimo_tpu_torch.channel.scattering import make_scenario
    from mamimo_tpu_torch.pipeline.dataset import scenario_generator

    ds = dataclasses.replace(_dataset(arrays, CSIDataset, CFG),
                             scenario=make_scenario(
                                 CFG, scenario_generator(0, "cpu")))
    ds.save(str(tmp_path / "d.npz"))
    got = src.get_datasource("mamimo_npz")(str(tmp_path / "d.npz"))
    want = jsrc.get_datasource("mamimo_npz")(str(tmp_path / "d.npz"))
    for k in ("rx", "h_ls", "snr_cs", "P"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sim_params"] == want["sim_params"]
    assert isinstance(got["dataset"], CSIDataset)
