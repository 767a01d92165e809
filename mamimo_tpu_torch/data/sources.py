"""Pluggable datasource registry (the port's copy of
``mamimo_tpu/data/sources.py``, on the port's ``CSIDataset``).

The reference dispatches on ``--datasource`` ∈ {matlab_maMimo,
matlab_WiFi_SISO, matlab_SpiNN_WiFi, powder, RICE_RENEW, Carlos-gnuradio}
inside one 200-line function (``massiveMIMO_dataGenerator.py:20-215``).
Here each source is a registered loader returning the common dense
schema; per SURVEY.md §2.1 the capability to keep is the *abstraction* —
``matlab_maMimo`` (and our native npz) are fully implemented, the other
testbed formats are documented adapters.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


def register_datasource(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_datasource(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown datasource {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


@register_datasource("matlab_maMimo")
def _load_matlab_mamimo(path: str):
    """Reference pickle dataset.b (or the raw .mat if given)."""
    from mamimo_tpu_torch.data.matlab_io import (
        load_pickle_dataset,
        load_reference_mat,
    )

    if path.endswith(".mat"):
        return load_reference_mat(path)
    return load_pickle_dataset(path)


@register_datasource("mamimo_npz")
def _load_native(path: str):
    """This framework's native CSIDataset npz."""
    from mamimo_tpu_torch.pipeline.dataset import CSIDataset

    ds = CSIDataset.load(path)
    return {
        "rx": ds.rx,
        "h_ls": ds.h_ls,
        "snr_cs": ds.snr_cs,
        "P": ds.pilot_matrix(),
        "sim_params": {
            "FFTLength": ds.cfg.fft_length,
            "CPLen": ds.cfg.cp_length,
            "nTX": ds.cfg.num_tx,
            "nRX": ds.cfg.num_rx,
        },
        "dataset": ds,
    }


def _simple_xy_loader(path: str, sim_params: dict):
    """Shared shape for the SISO-style pickle formats: X/y real+imag
    arrays, no pilot indirection (massiveMIMO_dataGenerator.py:57-113)."""
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    x = d["X"]["real"] + 1j * d["X"]["imag"]
    y = d["y"]["real"] + 1j * d["y"]["imag"]
    return {
        "rx": x.astype(np.complex64)[..., None],
        "h_ls": y.astype(np.complex64)[:, :, None, None],
        "snr_cs": None,
        "P": np.ones((1, 1), np.float32),
        "sim_params": sim_params,
    }


@register_datasource("matlab_WiFi_SISO")
def _load_wifi_siso(path: str):
    """512-FFT WiFi SISO capture (massiveMIMO_dataGenerator.py:57-83)."""
    return _simple_xy_loader(path, {
        "FFTLength": 512, "CPLen": 128, "numSym": 2, "symOffset": 128,
        "nTX": 1, "nRX": 1, "lenLTF": 1280, "nSubCarr": 416,
    })


@register_datasource("matlab_SpiNN_WiFi")
def _load_spinn_wifi(path: str):
    """64-FFT SpiNN WiFi capture (massiveMIMO_dataGenerator.py:85-113)."""
    return _simple_xy_loader(path, {
        "FFTLength": 64, "numSym": 2, "nTX": 1, "nRX": 1, "nSubCarr": 52,
    })


@register_datasource("Carlos-gnuradio")
def _load_carlos(path: str):
    """GNU Radio capture (massiveMIMO_dataGenerator.py:193-210)."""
    return _simple_xy_loader(path, {
        "FFTLength": 64, "numSym": 1, "nTX": 1, "nRX": 1,
    })


@register_datasource("powder")
def _load_powder(path: str):
    """POWDER testbed capture (massiveMIMO_dataGenerator.py:115-127):
    complex X/y arrays + embedded simParams."""
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    return {
        "rx": np.asarray(d["X"], np.complex64)[..., None],
        "h_ls": np.asarray(d["y"], np.complex64)[:, :, None, None],
        "snr_cs": None,
        "P": np.asarray(d.get("P", np.ones((1, 1)))),
        "sim_params": dict(d["simParams"]),
    }


@register_datasource("RICE_RENEW")
def _load_rice_renew(path: str):
    """RICE RENEW massive-MIMO capture
    (massiveMIMO_dataGenerator.py:129-191): per-client frames with
    zero-frame filtering, fftshift + null-subcarrier removal on labels."""
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    chan_est = d["chan_est"]
    lts_rx = d["lts_RX"]
    n_cli, bs_atx, n_frames = (chan_est.shape[1], chan_est.shape[2],
                               chan_est.shape[3])
    fft_len = chan_est.shape[4]
    if fft_len != 64:
        raise NotImplementedError("RICE_RENEW loader assumes FFT 64")
    nz = list(range(6, 32)) + list(range(33, 59))
    xs, ys = [], []
    for cli in range(n_cli):
        frame_ok = np.zeros(n_frames, bool)
        for f_ in range(n_frames):
            if any(np.count_nonzero(chan_est[0, cli, a, f_, :])
                   for a in range(bs_atx)):
                frame_ok[f_] = True
        ixs = np.nonzero(frame_ok)[0]
        for a in range(bs_atx):
            xs.append(np.squeeze(lts_rx[0, cli, a, ixs, :]))
            y = np.squeeze(chan_est[0, cli, a, ixs, :])
            ys.append(np.fft.fftshift(y, axes=1)[:, nz])
    x = np.concatenate(xs).astype(np.complex64)
    y = np.concatenate(ys).astype(np.complex64)
    return {
        "rx": x[..., None],
        "h_ls": y[:, :, None, None],
        "snr_cs": None,
        "P": np.ones((1, 1), np.float32),
        "sim_params": {
            "FFTLength": 64, "numSym": 1, "nTX": 1, "nRX": 64,
            "nSubCarr": y.shape[1], "lenLTF": x.shape[1],
        },
    }
