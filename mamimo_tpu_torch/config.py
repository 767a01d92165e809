"""Typed, frozen configuration: the port's own copy of the reference
configuration (``mamimo_tpu/config.py``).

Two hashable dataclasses that replace the reference pipeline's bash env
vars (``setenv.sh:2-25``), the 33-flag argparse
(``massiveMIMO_CSI_prediction_DNN.py:4-34``) and the MATLAB ``prm``
struct (``generate_maMIMO_LTF.m:88-115``). Field names, defaults and JSON
form are identical to the JAX package's, so one checkpoint's config files
load in both.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SimConfig:
    """Physical-layer / scenario parameters (the reference's ``prm``).

    Defaults reproduce the paper's BS32 single-user configuration
    (``generate_maMIMO_LTF.m:21-115``).
    """

    # --- antennas / users (generate_maMIMO_LTF.m:22-26) ---
    num_users: int = 1
    num_tx: int = 32          # BS transmit antennas (power of 2)
    num_rx: int = 4           # receive antennas at the (single) user
    num_sts: int = 1          # independent data streams

    # --- modulation / framing (generate_maMIMO_LTF.m:30-31,108-115) ---
    bits_per_subcarrier: int = 2   # 2 = QPSK
    num_data_symbols: int = 10
    code_rate_den: int = 3         # convolutional code rate 1/code_rate_den
    num_tails: int = 6             # K-1 termination tail bits

    # --- RF / channel (generate_maMIMO_LTF.m:88-92) ---
    fc: float = 28e9               # carrier frequency [Hz]
    chan_srate: float = 100e6      # channel sample rate [Hz]
    noise_figure: float = 8.0      # only used by the NF-based noise branch
    n_rays: int = 500              # steering dictionary size for OMP
    n_scatterers: int = 100        # N_chan_taps (generate_maMIMO_LTF.m:9)
    max_range: float = 1000.0      # user placed within this range of the BS
    scat_radius_frac: float = 0.1  # scatterer box half-size = frac * range
    c_light: float = 299792458.0

    # --- array geometry: 'auto' | 'ula' | 'ura' ---
    tx_geometry: str = "auto"
    rx_geometry: str = "auto"

    # --- channel model: 'scattering' | 'fir' | 'cdl_nlos' | 'cdl_los' ---
    channel_model: str = "scattering"
    fir_taps: int = 512                # FIR length for 'fir' [samples]
    cdl_delay_spread: float = 100e-9   # CDL delay-spread scaling [s]
    cdl_k_factor_db: float = 9.0       # Ricean K for the 'cdl_los' profile

    # --- OFDM grid (generate_maMIMO_LTF.m:96-102) ---
    fft_length: int = 256
    cp_length: int = 64
    num_carriers: int = 234
    num_pad_sym: int = 3           # zero-pad symbols for channel delay

    # ------------------------------------------------------------------
    # Derived constants (all cached; the dataclass stays hashable).
    # ------------------------------------------------------------------

    @cached_property
    def lam(self) -> float:
        """Carrier wavelength [m]."""
        return self.c_light / self.fc

    @cached_property
    def sym_len(self) -> int:
        return self.fft_length + self.cp_length

    @cached_property
    def num_pad_zeros(self) -> int:
        # generate_maMIMO_LTF.m:115
        return self.num_pad_sym * self.sym_len

    @cached_property
    def null_indices(self) -> Tuple[int, ...]:
        """0-based guard + DC bins (MATLAB [1:7 129 251:256],
        generate_maMIMO_LTF.m:99)."""
        n = self.fft_length
        return tuple(range(7)) + (n // 2,) + tuple(range(n - 6, n))

    @cached_property
    def pilot_indices(self) -> Tuple[int, ...]:
        """0-based pilot bins (MATLAB [26 54 90 118 140 168 204 232],
        generate_maMIMO_LTF.m:100)."""
        return (25, 53, 89, 117, 139, 167, 203, 231)

    @cached_property
    def carrier_locations(self) -> Tuple[int, ...]:
        """0-based data-carrier bins (generate_maMIMO_LTF.m:101-102)."""
        non_data = set(self.null_indices) | set(self.pilot_indices)
        locs = tuple(k for k in range(self.fft_length) if k not in non_data)
        assert len(locs) == self.num_carriers
        return locs

    @cached_property
    def used_sc(self) -> int:
        """Number of non-null subcarriers (data + pilots) = 242."""
        return self.fft_length - len(self.null_indices)

    @cached_property
    def len_ltf(self) -> int:
        """Time-domain sounding preamble length: one LTF OFDM symbol per
        Tx antenna (32*320 = 10240)."""
        return self.num_tx * self.sym_len

    @cached_property
    def num_frm_bits(self) -> int:
        # numSTS·(numDataSymbols·numCarriers·bitsPerSubCarrier·codeRate)
        # − numTails (generate_maMIMO_LTF.m:110-111)
        return (
            self.num_sts * self.num_data_symbols * self.num_carriers
            * self.bits_per_subcarrier
        ) // self.code_rate_den - self.num_tails

    @cached_property
    def mod_order(self) -> int:
        return 2 ** self.bits_per_subcarrier

    # ------------------------------------------------------------------

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SimConfig":
        return cls(**json.loads(s))


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters.

    Defaults mirror the paper pipeline invocation
    (``full_pipeline_maMIMO_DNNEst.sh:40`` →
    ``--nn 1024 1024 --bs 256 --epochs 1000 --method default_SNR --useBN``)
    and the in-code defaults at ``massiveMIMO_CSI_prediction_DNN.py:15-31``.
    The fields the port does not read yet (the training-loop and
    RNG options) are kept so that a checkpoint's ``tcfg`` round-trips.
    """

    hidden: Tuple[int, ...] = (1024, 1024)
    lr: float = 1e-4
    batch_size: int = 256
    epochs: int = 1000
    dropout: float = 0.15
    use_bn: bool = True
    val_train_ratio: float = 0.15
    val_same_train: bool = False
    # on-the-fly AWGN SNR levels, drawn uniformly per batch
    # (massiveMIMO_CSI_prediction_DNN.py:303)
    awgn_snr_levels: Tuple[float, ...] = (30.0, 20.0, 10.0, 0.0, -10.0, -20.0)
    method: str = "default_snr"        # 'default' disables the AWGN layer
    early_stop_patience: int = 25      # :285
    plateau_patience: int = 20         # :286
    plateau_factor: float = 0.1
    min_lr_factor: float = 0.01        # min_lr = lr * min_lr_factor
    bn_momentum: float = 0.99          # Keras BatchNormalization defaults
    bn_eps: float = 1e-3
    seed: int = 0
    # training matmul operand dtype: 'f32' or 'bf16' (f32 accumulation)
    matmul_dtype: str = "f32"
    # AWGN draw of the training step: 'rbg' | 'rbg_clt' | 'threefry'
    awgn_rng: str = "rbg_clt"
    # Adam first-moment storage dtype: 'f32' | 'bf16'
    opt_dtype: str = "f32"
    steps_per_call: int = 1
    ckpt_backend: str = "npz"          # 'npz' | 'orbax' (train/ckpt.py)
    # per-sample input normalization: 'none' or 'rms'
    # (massiveMIMO_dataGenerator.py:506-519)
    input_norm: str = "none"
    # input-manipulation options mirrored from the reference CLI
    in_fraction: int = 1               # --inFraction
    decimate: str = "none"             # 'none' | 'max' | 'avg'
    test_drop_input: bool = False      # --testDropInput
    input_dropout: float = 0.15        # dropout_test_param (:165)
    dims: Tuple[str, ...] = ("real", "imag")  # --onlyReal/--onlyImag

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        for k in ("hidden", "awgn_snr_levels", "dims"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


def default_fft_size(cfg: SimConfig, data_leg: bool = False) -> int:
    """Smallest power-of-two FFT covering the padded signal for the
    frequency-domain channel application (sounding preamble + tail pad;
    the data leg additionally carries the priming preamble + data frame,
    helperApplyMUChannel.m:26-35)."""
    n = cfg.len_ltf + cfg.num_pad_zeros
    if data_leg:
        n += cfg.num_pad_zeros + (cfg.num_sts + cfg.num_data_symbols) \
            * cfg.sym_len
    size = 1
    while size < n:
        size *= 2
    return size


def carrier_bins(cfg: SimConfig) -> np.ndarray:
    """Signed DFT bin index for each data carrier.

    Grid position p (0-based, fftshifted layout where p = fft/2 is DC)
    corresponds to DFT bin p - fft/2.
    """
    return np.asarray(cfg.carrier_locations, np.int32) - cfg.fft_length // 2
