"""Dataset generation on the card and its container (the port's copy of
``mamimo_tpu/pipeline/dataset.py``).

Replaces the reference's pipeline of files (MATLAB
``generate_maMIMO_LTF`` → .mat → ``create_massiveMIMO_CSIest_dnn_dataset.py``
→ pickle) with one generator whose output arrays land in host memory.

Sample ordering contract (that of the reference converter,
create_massiveMIMO_CSIest_dnn_dataset.py:62):

    sample_ix = pkt * (num_rx * num_tx) + i_rx * num_tx + i_tx

Randomness: the scenario comes from a ``torch.Generator`` seeded with
``seed`` alone, and packet p from its own generator seeded from (seed,
p) alone (``packet_generator``), so a packet does not depend on the
chunk size and can be regenerated alone (the prm.seed_p contract,
generate_maMIMO_LTF.m:33-41). With num_users > 1 the users' scenarios
come one after another from that generator and user u's packet p from
(seed, p, 1000 + u) (``pipeline/multiuser.py``); the data leg of
``with_ber`` from (seed, p, 7777). The numbers are not JAX's: the JAX
package folds these integers into PRNG keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from mamimo_tpu_torch.channel.scattering import Scenario, make_scenario
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.ltf import _hadamard_np, gen_preamble
from mamimo_tpu_torch.pipeline.sounding import draw_sounding, sound_from_draws
from mamimo_tpu_torch.utils.numerics import fetch_tree_async
from mamimo_tpu_torch.utils.seeds import seeded_generator

FIELDS = ("rx", "h_ls", "h_perfect", "h_mmse", "snr_cs", "noise_db", "tau",
          "chan_delay")


# the extra seed integer of a packet's data-leg generator (``with_ber``),
# the 7777 that JAX folds into the packet's key
DATA_LEG_STREAM = 7777


def packet_generator(seed: int, p: int, device) -> torch.Generator:
    """Packet p's generator on ``device``, seeded from (seed, p) alone
    through numpy's SeedSequence (63 bits)."""
    return seeded_generator(device, seed, p)


def scenario_generator(seed: int, device) -> torch.Generator:
    """The generator of the experiment's scenario: ``seed`` alone."""
    return torch.Generator(device=device).manual_seed(seed)


def _packet_generator(cfg: SimConfig, seed: int, p: int, user: int,
                      device) -> torch.Generator:
    """The sounding generator of packet p: ``packet_generator``, or user
    ``user``'s (``multiuser.user_packet_generator``) with num_users > 1."""
    if cfg.num_users > 1:
        from mamimo_tpu_torch.pipeline.multiuser import user_packet_generator

        return user_packet_generator(seed, p, user, device)
    if user != 0:
        raise ValueError(f"user {user} of a single-user configuration")
    return packet_generator(seed, p, device)


@dataclasses.dataclass
class CSIDataset:
    """A generated sounding dataset (the ``usr_data`` + pickle
    ``dataset.b`` equivalent, kept as dense host arrays)."""

    cfg: SimConfig
    rx: np.ndarray           # (B, len_ltf, num_rx) complex64 received LTFs
    h_ls: np.ndarray         # (B, C, num_tx, num_rx) complex64 LS labels
    h_perfect: np.ndarray    # (B, C, num_tx, num_rx) oracle CSI
    snr_cs: np.ndarray       # (B, num_rx) realized sounding SNR [dB]
    noise_db: np.ndarray     # (B,) applied noise power [dB]
    tau: np.ndarray          # (B, n_scatterers) path delays [s]
    chan_delay: np.ndarray   # (B,) int32
    snr_target: float
    seed: int
    scenario: Scenario
    h_mmse: Optional[np.ndarray] = None   # (B, C, num_tx, num_rx) or None
    user: int = 0
    noise_mode: str = "snr"               # the receiver convention used
    device: str = "cuda"                  # where the packets were drawn
    ber: Optional[np.ndarray] = None      # (B,) data-leg BER (with_ber)

    @property
    def num_packets(self) -> int:
        return self.rx.shape[0]

    @property
    def num_samples(self) -> int:
        return self.num_packets * self.cfg.num_tx * self.cfg.num_rx

    def decompose_index(self, idx):
        """sample index -> (packet, i_tx, i_rx), vector-safe."""
        per_pkt = self.cfg.num_tx * self.cfg.num_rx
        p = idx // per_pkt
        rem = idx % per_pkt
        return p, rem % self.cfg.num_tx, rem // self.cfg.num_tx

    def pilot_matrix(self) -> np.ndarray:
        return _hadamard_np(self.cfg.num_tx).copy()

    def rx_planes(self, dtype=np.float32) -> np.ndarray:
        """The received preambles in the canonical serving layout: flat
        rx-major planes (2, B·num_rx, len_ltf), [0] real, [1] imaginary,
        sample s = packet·num_rx + rx antenna: the input of
        ``CSIPredictor.estimate_full``."""
        b, L, r = self.rx.shape
        rxm = np.transpose(self.rx, (0, 2, 1)).reshape(b * r, L)
        return np.stack([np.real(rxm), np.imag(rxm)]).astype(dtype)

    def packet_generator(self, p: int, device=None) -> torch.Generator:
        """Packet p's generator, in the state generation drew it from (on
        ``device``, default the device the dataset was drawn on: the card's
        and the CPU's streams differ). ``draw_sounding(cfg, [gen],
        noise_mode)`` then ``sound_from_draws`` on ``scenario`` regenerate
        the packet (user ``user``'s packet with num_users > 1)."""
        return _packet_generator(self.cfg, self.seed, p, self.user,
                                 self.device if device is None else device)

    def extract_packets(self, n: int, reverse: bool = True) -> "CSIDataset":
        """The first (or last) n packets (``extract_pkt.m``; the BER
        evaluator takes the last n, BER_test_maMIMO_LTF.m:5)."""
        sl = (slice(self.num_packets - n, self.num_packets) if reverse
              else slice(0, n))
        return dataclasses.replace(self, **{
            f: getattr(self, f)[sl] for f in FIELDS + ("ber",)
            if getattr(self, f) is not None})

    def save(self, path: str) -> None:
        """An .npz file that the JAX package's ``CSIDataset.load`` reads
        too (and this ``load`` reads the JAX package's)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        scen = {f"scenario_{k}": np.asarray(torch.as_tensor(v).cpu())
                for k, v in self.scenario._asdict().items()}
        np.savez_compressed(
            path,
            rx=self.rx, h_ls=self.h_ls, h_perfect=self.h_perfect,
            snr_cs=self.snr_cs, noise_db=self.noise_db, tau=self.tau,
            chan_delay=self.chan_delay,
            h_mmse=(self.h_mmse if self.h_mmse is not None
                    else np.zeros(0, np.complex64)),
            meta=np.frombuffer(json.dumps(
                {"cfg": json.loads(self.cfg.to_json()),
                 "snr_target": self.snr_target, "seed": self.seed,
                 "user": self.user, "noise_mode": self.noise_mode,
                 "device": self.device}).encode(), dtype=np.uint8),
            **scen)

    def save_raw(self, path: str) -> None:
        """Write the raw container the native C++ loader streams from
        (``data.native_loader.write_raw``): byte for byte the JAX
        package's file for the same arrays."""
        from mamimo_tpu_torch.data.native_loader import write_raw

        write_raw(path, self.rx, self.h_ls)

    @classmethod
    def load(cls, path: str) -> "CSIDataset":
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        scen = Scenario(**{k[len("scenario_"):]: torch.as_tensor(z[k])
                           for k in z.files if k.startswith("scenario_")})
        return cls(
            cfg=SimConfig(**meta["cfg"]),
            **{f: z[f] for f in FIELDS if f != "h_mmse"},
            snr_target=meta["snr_target"], seed=meta["seed"], scenario=scen,
            h_mmse=z["h_mmse"] if z["h_mmse"].size else None,
            user=int(meta.get("user", 0)),
            noise_mode=meta.get("noise_mode", "snr"),
            device=meta.get("device", "cuda"))


def generate_dataset(cfg: SimConfig, seed: int, num_packets: int,
                     snr_db: float, with_mmse: bool = False,
                     noise_mode: str = "snr", chunk: int = 32,
                     fft_size: int | None = None,
                     scenario: Scenario | None = None, user: int = 0,
                     with_ber: bool = False, interference_dbm: float = -55.0,
                     mmse_estimator: str = "cg", mmse_n_iter: int = 16,
                     fetch_dtype: str = "f32", device=None) -> CSIDataset:
    """Generate a sounding dataset on the card.

    One experiment = one fixed user placement (the scenario, drawn from
    ``seed`` unless given) and per-packet channel realizations
    (generate_maMIMO_LTF.m:33-51). Packets are sounded ``chunk`` at a
    time as one batch (``sound_from_draws``; the frequency response of a
    chunk is chunk × 16 MB at BS32). Chunk k's work is queued before
    chunk k−1's arrays are read: its results are copied into pinned host
    memory without blocking (``fetch_tree_async``), so the host draws and
    queues the next chunk while the card computes.

    Args:
      user: with cfg.num_users > 1, which user's dataset to emit (the
        converter's --user flag): the user's scenario of the experiment's
        users and its per-user packets.
      with_ber: also run the data-transmission leg per packet with the
        LS CSI and record its BER (the isOnlyCSI=false path,
        generate_maMIMO_LTF.m:403-640 + usr_data{u,5}), at FFT length
        2·fft_size (default ``default_fft_size(cfg, data_leg=True)``),
        from the packet's own data-leg generator: every other field
        equals a run without it.
      fetch_dtype: 'f32' (exact) or 'bf16': the complex arrays cross to
        the host as bf16 planes (half the bytes, about −50 dB); refused
        at snr_db >= 60 (noiseless labels), ValueError.
      device: where it runs; None means the card (cuda), and raises
        without one.
      Other options as ``sound_from_draws``.
    """
    if fetch_dtype not in ("f32", "bf16"):
        raise ValueError(f"fetch_dtype {fetch_dtype!r}: 'f32' or 'bf16'")
    if fetch_dtype == "bf16" and snr_db >= 60.0:
        raise ValueError("a bf16 fetch would quantize noiseless labels "
                         "(snr_db >= 60); use 'f32'")
    dev = resolve_device("cuda" if device is None else device)
    if scenario is not None:
        scen = Scenario(*(torch.as_tensor(t).to(dev) for t in scenario))
    elif cfg.num_users > 1:
        from mamimo_tpu_torch.pipeline.multiuser import (
            index_user,
            make_scenarios,
        )

        scen = index_user(make_scenarios(cfg, scenario_generator(seed, dev)),
                          user)
    else:
        scen = make_scenario(cfg, scenario_generator(seed, dev))
    preamble = torch.as_tensor(gen_preamble(cfg, cfg.num_tx), device=dev)
    fdt = torch.bfloat16 if fetch_dtype == "bf16" else None
    if with_ber:
        from mamimo_tpu_torch.config import default_fft_size
        from mamimo_tpu_torch.pipeline.datatx import (
            data_tx_from_draws,
            draw_data_tx,
        )

        # the data leg carries the preamble and the data frame
        data_fft = (default_fft_size(cfg, data_leg=True) if fft_size is None
                    else 2 * fft_size)

    outs, pending = [], None
    for start in range(0, num_packets, chunk):
        pkts = range(start, min(start + chunk, num_packets))
        gens = [_packet_generator(cfg, seed, p, user, dev) for p in pkts]
        res, chan = sound_from_draws(
            cfg, scen, draw_sounding(cfg, gens, noise_mode), snr_db,
            preamble=preamble, with_mmse=with_mmse, noise_mode=noise_mode,
            fft_size=fft_size, interference_dbm=interference_dbm,
            mmse_estimator=mmse_estimator, mmse_n_iter=mmse_n_iter)
        ber = None
        if with_ber:
            draws = draw_data_tx(cfg, [seeded_generator(dev, seed, p,
                                                         DATA_LEG_STREAM)
                                       for p in pkts])
            ber = data_tx_from_draws(
                cfg, scen, chan, res.h_ls, res.noise_db, res.snr_cs, draws,
                fft_size=data_fft,
                # SINR-mode sounding runs at preamp gain 0: the data leg
                # too (generate_maMIMO_LTF_SINR.m:466,488-491)
                gain_db=0.0 if noise_mode == "sinr" else None).ber
        if not with_mmse:
            res = res._replace(h_mmse=None)
        fetched = fetch_tree_async((res, ber), fdt)
        if pending is not None:
            outs.append(pending())
        pending = fetched
    if pending is not None:
        outs.append(pending())

    def cat(name):
        return np.concatenate([getattr(o[0], name) for o in outs], axis=0)

    return CSIDataset(
        cfg=cfg, **{f: cat(f) for f in FIELDS if f != "h_mmse"},
        h_mmse=cat("h_mmse") if with_mmse else None,
        snr_target=float(snr_db), seed=seed, scenario=scen, user=user,
        noise_mode=noise_mode, device=str(dev),
        ber=np.concatenate([o[1] for o in outs]) if with_ber else None)
