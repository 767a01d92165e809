"""Interop with the reference's on-disk formats (the port's copy of
``mamimo_tpu/data/matlab_io.py``; NumPy, h5py and SciPy only, no tensor).

Round-trips both directions so a user of the reference can move data in
or out of this framework:

* ``load_reference_mat``: read the MATLAB v7.3/HDF5 packet files written
  by ``generate_maMIMO_LTF.m:661-666`` (``usr_data`` cell + ``P`` +
  ``prm``);
* ``load_pickle_dataset`` / ``save_pickle_dataset``: the pickle
  ``dataset.b`` schema of ``create_massiveMIMO_CSIest_dnn_dataset.py:125``
  ({'X': (N,2) [hash,iTx], 'y': {'real','imag'}, 'LTF': {hash: planes},
  'P', 'simParams'});
* ``export_predictions_mat``: per-packet
  ``test_csi_predictions_{real,imag}_<k>.mat`` files exactly as the
  MATLAB evaluator expects them (massiveMIMO_CSI_prediction_DNN.py:401-409
  → BER_test_maMIMO_LTF.m:198-219).
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, Optional

import numpy as np


def _h5_complex(arr) -> np.ndarray:
    """MATLAB v7.3 complex arrays load as structured ('real','imag')."""
    a = np.asarray(arr)
    if a.dtype.names and "real" in a.dtype.names:
        return a["real"] + 1j * a["imag"]
    return a


def load_reference_mat(path: str, user: int = 0):
    """Load a reference packet .mat (v7.3) into dense arrays.

    Returns dict with:
      rx     (B, len_ltf, num_rx) complex64  — received LTFs
      h_ls   (B, C, num_tx, num_rx) complex64 — stored LS estimates
      snr_cs (B, num_rx) float32
      P      (num_tx, num_tx) float32
      sim_params dict (FFTLength, CPLen, nTX, nRX, ...)

    h5py is imported here, not with the module: a machine without it
    (the card's) reads every other format.
    """
    import h5py

    with h5py.File(path, "r") as f:
        usr = f["usr_data"]
        # MATLAB cell: usr_data{u, k} -> refs at [k-1, u]
        data_x = _h5_complex(f[usr[0, user]])       # (nRx, len, B)
        data_y = _h5_complex(f[usr[1, user]])       # (nRx, nTx, C, B)
        snr = np.asarray(f[usr[2, user]])           # (nRx?, 1, B)-ish
        P = np.asarray(f["P"]).T                    # transposed by h5 layout
        prm = f["prm"]
        fft_len = int(np.asarray(prm["FFTLength"])[0, 0])
        cp_len = int(np.asarray(prm["CyclicPrefixLength"])[0, 0])

    rx = np.transpose(data_x, (2, 1, 0)).astype(np.complex64)
    h_ls = np.transpose(data_y, (3, 2, 1, 0)).astype(np.complex64)
    snr = np.squeeze(snr)
    if snr.ndim == 1:
        snr = np.broadcast_to(snr[:, None], (rx.shape[0], rx.shape[2]))
    elif snr.shape[0] != rx.shape[0]:
        snr = snr.T
    sim_params = {
        "FFTLength": fft_len,
        "CPLen": cp_len,
        "numSym": rx.shape[1] / (fft_len + cp_len),
        "symOffset": cp_len,
        "nTX": h_ls.shape[2],
        "nRX": h_ls.shape[3],
    }
    return {
        "rx": rx,
        "h_ls": h_ls,
        "snr_cs": np.asarray(snr, np.float32),
        "P": np.asarray(P, np.float32),
        "sim_params": sim_params,
    }


def save_pickle_dataset(
    rx: np.ndarray,
    h_ls: np.ndarray,
    P: np.ndarray,
    sim_params: Dict,
    path: str,
    seed: Optional[int] = None,
) -> None:
    """Write the reference's pickle ``dataset.b`` schema
    (create_massiveMIMO_CSIest_dnn_dataset.py:39-126): per-(pkt,Rx) LTFs
    deduplicated under random 32-bit hashes, (N,2) [hash, iTx] index
    array, (N, C) real/imag label arrays."""
    B, _, n_rx = rx.shape
    _, n_sub, n_tx, _ = h_ls.shape
    rng = random.Random(seed)
    ltf: Dict[int, Dict[str, np.ndarray]] = {}
    n = B * n_rx * n_tx
    X = np.zeros((n, 2), dtype=int)
    y_re = np.zeros((n, n_sub))
    y_im = np.zeros((n, n_sub))
    for p in range(B):
        for i_rx in range(n_rx):
            while True:
                h = rng.getrandbits(32)
                if h not in ltf:
                    ltf[h] = {
                        "real": np.real(rx[p, :, i_rx]).astype(np.float64),
                        "imag": np.imag(rx[p, :, i_rx]).astype(np.float64),
                    }
                    break
            for i_tx in range(n_tx):
                k = p * (n_rx * n_tx) + i_rx * n_tx + i_tx
                X[k] = [h, i_tx]
                y_re[k] = np.real(h_ls[p, :, i_tx, i_rx])
                y_im[k] = np.imag(h_ls[p, :, i_tx, i_rx])
    dataset = {
        "X": X,
        "y": {"real": y_re, "imag": y_im},
        "LTF": ltf,
        "P": np.asarray(P),
        "simParams": dict(sim_params),
    }
    with open(path, "wb") as f:
        pickle.dump(dataset, f)


def load_pickle_dataset(path: str):
    """Load a reference ``dataset.b`` pickle into dense arrays.

    Resolves the hash-indirected LTFs (the per-sample dict lookups of
    massiveMIMO_dataGenerator.py:309-311) into a dense
    (B, len_ltf, num_rx) array, assuming the converter's sample order.

    Returns the same dict schema as load_reference_mat.
    """
    with open(path, "rb") as f:
        d = pickle.load(f)
    sp = d["simParams"]
    n_tx, n_rx = int(sp["nTX"]), int(sp["nRX"])
    X, y = d["X"], d["y"]
    n = X.shape[0]
    assert n % (n_tx * n_rx) == 0
    B = n // (n_tx * n_rx)
    n_sub = y["real"].shape[1]
    len_ltf = next(iter(d["LTF"].values()))["real"].shape[0]
    rx = np.zeros((B, len_ltf, n_rx), np.complex64)
    h_ls = np.zeros((B, n_sub, n_tx, n_rx), np.complex64)
    for p in range(B):
        for i_rx in range(n_rx):
            k0 = p * (n_rx * n_tx) + i_rx * n_tx
            h = X[k0, 0]
            rx[p, :, i_rx] = (
                np.asarray(d["LTF"][h]["real"])
                + 1j * np.asarray(d["LTF"][h]["imag"])
            )
            for i_tx in range(n_tx):
                k = k0 + i_tx
                h_ls[p, :, i_tx, i_rx] = y["real"][k] + 1j * y["imag"][k]
    return {
        "rx": rx,
        "h_ls": h_ls,
        "snr_cs": None,
        "P": np.asarray(d["P"]),
        "sim_params": sp,
    }


def export_predictions_mat(
    outdir: str,
    pred: np.ndarray,       # (B, C, num_tx, num_rx) complex
    rx: np.ndarray,         # (B, len_ltf, num_rx) complex
    h_ls: np.ndarray,       # (B, C, num_tx, num_rx) complex (true_y)
    P: np.ndarray,          # (num_tx, num_tx)
) -> None:
    """Per-packet prediction export for the MATLAB evaluator
    (massiveMIMO_CSI_prediction_DNN.py:401-409): one .mat per packet and
    plane with {x: inputs+pilot, y: predictions, true_y: labels}, rows
    ordered (iRx-1)*nTX + iTx."""
    from scipy.io import savemat

    os.makedirs(outdir, exist_ok=True)
    B, C, n_tx, n_rx = pred.shape
    bs = n_tx * n_rx
    for p in range(B):
        for plane, op in (("real", np.real), ("imag", np.imag)):
            x = np.zeros((bs, rx.shape[1] + n_tx))
            yp = np.zeros((bs, C))
            ty = np.zeros((bs, C))
            for i_rx in range(n_rx):
                for i_tx in range(n_tx):
                    row = i_rx * n_tx + i_tx
                    x[row, : rx.shape[1]] = op(rx[p, :, i_rx])
                    x[row, rx.shape[1]:] = P[:, i_tx]
                    yp[row] = op(pred[p, :, i_tx, i_rx])
                    ty[row] = op(h_ls[p, :, i_tx, i_rx])
            savemat(
                os.path.join(
                    outdir, f"test_csi_predictions_{plane}_{p + 1}.mat"
                ),
                {"all_pkts_csi_nn_out": {"x": x, "y": yp, "true_y": ty}},
                do_compression=True,
            )
