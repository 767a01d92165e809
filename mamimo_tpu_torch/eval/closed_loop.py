"""Closed-loop evaluation of CSI estimators (the port's copy of
``mamimo_tpu/eval/closed_loop.py``).

Replaces ``BER_test_maMIMO_LTF.m``: for each packet of a test dataset and
each estimator source in {LS, LMMSE, DNN, perfect}, run the full data
transmission (OMP precoding → coded QPSK → channel → decode) and record
BER, RMS EVM, NMSE against the perfect estimate, and beamforming gain.

As in the JAX package, the LS/LMMSE/perfect estimates come from the
dataset, and the data leg's channel is regenerated from the packet's
own generator (``CSIDataset.packet_generator``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mamimo_tpu_torch.channel.scattering import ChannelRealization, Scenario
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.metrics import nmse_subk
from mamimo_tpu_torch.pipeline.dataset import CSIDataset
from mamimo_tpu_torch.pipeline.datatx import (
    DataTxDraws,
    data_tx_from_draws,
    draw_data_tx,
)
from mamimo_tpu_torch.pipeline.sounding import channel_from_draws, draw_channel
from mamimo_tpu_torch.utils.numerics import full_f32_matmul
from mamimo_tpu_torch.utils.seeds import seeded_generator

# the spawn key of the closed loop's data-leg generators: seeded from
# (seed, p) like a dataset's packets, in a stream of their own
EVAL_STREAM = 3


@dataclasses.dataclass
class ClosedLoopMetrics:
    """Per-packet metric arrays for one estimator source (the metrics.mat
    contents, BER_test_maMIMO_LTF.m:652-668)."""

    ber: np.ndarray       # (B,)
    evm: np.ndarray       # (B,)
    nmse: np.ndarray      # (B,) NMSE_subk vs perfect CSI
    bf_gain: np.ndarray   # (B,)

    def summary(self) -> Dict[str, float]:
        return {
            "ber": float(np.mean(self.ber)),
            "evm": float(np.mean(self.evm)),
            "nmse": float(np.mean(self.nmse)),
            "nmse_db": float(10 * np.log10(np.mean(self.nmse) + 1e-30)),
            "bf_gain": float(np.mean(self.bf_gain)),
        }


def nmse_vs_snr(ds: CSIDataset, predictions: Optional[np.ndarray] = None,
                device=None) -> Dict[str, np.ndarray]:
    """The sounding-only NMSE of each estimator source against the oracle
    CSI, per packet: {"ls", "lmmse" (if the dataset has it), "dnn" (if
    ``predictions``, (B, C, T, R) complex, are given)}. Computed on
    ``device``: None means the card, and raises without one."""
    dev = resolve_device("cuda" if device is None else device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.complex64), device=dev)

    ref = put(ds.h_perfect)
    srcs = {"ls": ds.h_ls, "lmmse": ds.h_mmse, "dnn": predictions}
    with full_f32_matmul():
        return {k: nmse_subk(ref, put(v)).cpu().numpy()
                for k, v in srcs.items() if v is not None}


def eval_generator(seed: int, p: int, device) -> torch.Generator:
    """The data-leg generator of packet p in ``evaluate_closed_loop``
    (JAX's ``fold_in(PRNGKey(seed), p)``): seeded from (seed, p) alone,
    shared by every source of the packet."""
    return seeded_generator(device, seed, p, stream=EVAL_STREAM)


def closed_loop_chunk(ds: CSIDataset, packets, csi, seed: int = 1234,
                      fft_size: int | None = None, device=None):
    """The closed loop of some packets of ``ds`` under several CSI
    sources, as one batch: csi (P, n_src, C, T, R) for the P packets
    ``packets``. Each packet's channel is regenerated from
    ``ds.packet_generator(p)`` (the channel draws alone), its data-leg
    draws come from ``eval_generator(seed, p)``; both are shared by the
    packet's sources. Returns the DataTxResult, each tensor (P, n_src,
    ...), on ``device`` (None: the card)."""
    cfg = ds.cfg
    dev = resolve_device("cuda" if device is None else device)
    packets = list(packets)
    scen = Scenario(*(torch.as_tensor(t).to(dev) for t in ds.scenario))
    # the channel draws come from the generator on the device the dataset
    # was drawn on (the card's and the CPU's streams differ)
    sd = draw_channel(cfg, [ds.packet_generator(p) for p in packets])
    chan = channel_from_draws(cfg, scen, sd._replace(
        **{k: None if v is None else v.to(dev)
           for k, v in sd._asdict().items()}))
    chan = ChannelRealization(*(t[:, None] for t in chan))
    draws = draw_data_tx(cfg, [eval_generator(seed, p, dev)
                               for p in packets])
    draws = DataTxDraws(*(t[:, None] for t in draws))
    idx = np.asarray(packets)
    return data_tx_from_draws(
        cfg, scen, chan, torch.as_tensor(csi, device=dev),
        torch.as_tensor(ds.noise_db[idx], device=dev)[:, None],
        torch.as_tensor(ds.snr_cs[idx], device=dev)[:, None], draws,
        fft_size=fft_size,
        # SINR-mode datasets were sounded at preamp gain 0; the data leg
        # follows (ds.noise_db is the absolute noise + interference floor)
        gain_db=0.0 if ds.noise_mode == "sinr" else None)


def evaluate_closed_loop(ds: CSIDataset,
                         predictions: Optional[np.ndarray] = None,
                         sources: tuple = ("ls", "lmmse", "dnn", "perfect"),
                         max_packets: Optional[int] = None,
                         fft_size: int | None = None, seed: int = 1234,
                         chunk: int = 32,
                         device=None) -> Dict[str, ClosedLoopMetrics]:
    """Run the closed loop over a test dataset, batched: one batch of
    (packet × source) per ``chunk`` packets (``closed_loop_chunk``), the
    channel and the data-leg draws of a packet shared by its sources, as
    the reference's single rng stream shares them.

    Slice index p is re-drawn as packet p of ``ds.seed``: on a dataset cut
    by ``extract_packets(reverse=True)`` that is another packet than the
    one sounded, as in the JAX package.

    Args:
      ds: test dataset (must carry h_mmse if 'lmmse' is requested).
      predictions: (B, C, Nt, Nr) DNN CSI (required for 'dnn').
      max_packets: evaluate only the first N packets.
      chunk: packets per batch (bounds peak memory: each packet carries
        about n_src × fft × Nt complex workspaces).
      device: where it runs; None means the card (raises without one).

    Returns: {source: ClosedLoopMetrics}
    """
    dev = resolve_device("cuda" if device is None else device)
    n = ds.num_packets if max_packets is None else min(max_packets,
                                                        ds.num_packets)
    pools = {"ls": ds.h_ls, "lmmse": ds.h_mmse, "dnn": predictions,
             "perfect": ds.h_perfect}
    srcs = [s for s in sources if pools[s] is not None]
    # (n, n_src, C, Nt, Nr) host stack, moved to the device per chunk
    csi_host = np.stack([np.asarray(pools[s][:n], np.complex64)
                         for s in srcs], axis=1)
    ber, evm, bf = (np.zeros((n, len(srcs))) for _ in range(3))
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        r = closed_loop_chunk(ds, range(start, stop), csi_host[start:stop],
                              seed=seed, fft_size=fft_size, device=dev)
        ber[start:stop] = r.ber.cpu().numpy()
        evm[start:stop] = r.evm.cpu().numpy()
        bf[start:stop] = r.bf_gain.cpu().numpy()

    def put(a):
        return torch.as_tensor(np.asarray(a[:n], np.complex64), device=dev)

    ref = put(ds.h_perfect)
    out = {}
    with full_f32_matmul():
        for i, s in enumerate(srcs):
            out[s] = ClosedLoopMetrics(
                ber=ber[:, i], evm=evm[:, i],
                nmse=nmse_subk(ref, put(pools[s])).cpu().numpy(),
                bf_gain=bf[:, i])
    return out
