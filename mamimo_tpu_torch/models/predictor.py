"""Deployment inference wrapper (the port's ``CSIPredictor``, counterpart
of ``mamimo_tpu/models/predictor.py``): load a trained checkpoint and
serve channel estimates, with the per-experiment pre/post-processing of
``inference.py:6-68``.

``estimate_full`` is the serving call. On the card it runs the two
hand-written kernels (LS, then the fused factored DNN) on bfloat16
planes; on the CPU it runs their float32 plain versions, as the JAX
package's CPU branch does. ``all_pairs(int8=True)`` serves the int8
quantized DNN (``models/quant.py``), whose three products per plane run
the int8 GEMM kernel on the card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    _factored_all_pairs,
    params_from_jax,
    predict_all_pairs_planes,
    predict_complex,
    tree_leaves,
)
from mamimo_tpu_torch.models.quant import (
    predict_all_pairs_planes_int8,
    prepare_int8_serving,
    quantize_params_int8,
)
from mamimo_tpu_torch.ops.estimate import ls_estimate_planes, ls_planes_constants
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    fused_factored_planes,
    predict_all_pairs_planes_kernel,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import ls_planes_v2, ls_sm90_constants
from mamimo_tpu_torch.train.ckpt import load_checkpoint
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises if it names CUDA and no GPU is
    present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU "
                           "is available")
    return dev


class CSIPredictor:
    """Load a trained model directory and serve complex CSI predictions."""

    def __init__(self, model_path: str, experiment: str = "matlab_maMimo",
                 device="cuda", verbose: bool = False):
        self.path = model_path
        self.experiment = experiment
        self.device = resolve_device(device)
        ck = load_checkpoint(os.path.join(model_path, "best"))
        self.cfg: SimConfig = ck["cfg"]
        self.tcfg: TrainConfig = ck["tcfg"]
        self.params, self.bn_state = params_from_jax(
            ck["params"], ck["bn_state"], device=self.device)
        self._prepared = None
        self._ls_consts = None
        self._qparams = None
        if verbose:
            n = sum(t.numel() for t in tree_leaves(self.params))
            print(f"[CSIPredictor] loaded {model_path}: {n} params on "
                  f"{self.device}")

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _kernel_weights(self):
        """BN/pilot-folded bf16 weights and the LS kernel's DFT matrix,
        made once per predictor (the float32 folds in full float32)."""
        if self._prepared is None:
            with full_f32_matmul():
                self._prepared = prepare_factored_weights(
                    self.cfg, self.tcfg, self.params, self.bn_state)
            self._ls_consts = ls_sm90_constants(self.cfg, self.device)
        return self._prepared, self._ls_consts

    def _int8_weights(self):
        """The int8 serving tree (split W1 signal/pilot scales, folded
        BN, the kernel's transposed weights and the pilot-row product),
        made once per predictor in full float32."""
        if self._qparams is None:
            with full_f32_matmul():
                self._qparams = prepare_int8_serving(
                    self.cfg, quantize_params_int8(
                        self.tcfg, self.params, self.bn_state,
                        sig_len=self.cfg.len_ltf))
        return self._qparams

    def serve_planes(self, planes: torch.Tensor):
        """The device side of estimate_full: planes (2, S, len_ltf) on
        this predictor's device → (ls2, y2), each (2, S, num_tx,
        num_carriers) float32 planes on the device.

        CUDA: the planes are cast to bf16 once, then the LS kernel and the
        two fused factored DNN kernels run. CPU: float32 plain versions.
        """
        cfg, tcfg = self.cfg, self.tcfg
        if self.on_cuda:
            prepared, consts = self._kernel_weights()
            pl16 = planes.to(torch.bfloat16)
            ls2 = ls_planes_v2(cfg, pl16, consts)
            y2 = fused_factored_planes(cfg, tcfg, prepared, pl16)
            return ls2, y2
        if self._ls_consts is None:
            self._ls_consts = ls_planes_constants(cfg, device=self.device)
        h = ls_estimate_planes(cfg, planes, self._ls_consts)
        ls2 = torch.stack([h.real, h.imag])
        y2 = _factored_all_pairs(cfg, tcfg, self.params, self.bn_state, planes)
        return ls2, y2

    def estimate_full(self, rx_planes_flat: np.ndarray):
        """The serving call: LS + DNN estimates of every (sample, tx,
        carrier) from the canonical flat planes (2, S, len_ltf) float32,
        S = packets·num_rx.

        Returns:
          (h_ls, h_dnn): each (S, num_tx, num_carriers) complex64 numpy.
        """
        x = torch.as_tensor(np.asarray(rx_planes_flat, np.float32),
                            device=self.device)
        ls2, y2 = self.serve_planes(x)
        return tuple(torch.complex(a[0], a[1]).cpu().numpy()
                     for a in (ls2, y2))

    def all_pairs_planes(self, rx_planes: torch.Tensor,
                         int8: bool = False) -> torch.Tensor:
        """The device side of all_pairs: rx-major planes (2, B, num_rx,
        len_ltf) on this predictor's device → (B, num_rx, num_tx,
        num_carriers) complex64 on the device."""
        if int8:
            return predict_all_pairs_planes_int8(
                self.cfg, self.tcfg, self._int8_weights(), rx_planes)
        if self.on_cuda:
            prepared, _ = self._kernel_weights()
            return predict_all_pairs_planes_kernel(self.cfg, self.tcfg,
                                                   prepared, rx_planes)
        return predict_all_pairs_planes(self.cfg, self.tcfg, self.params,
                                        self.bn_state, rx_planes)

    def all_pairs(self, rx_planes: np.ndarray,
                  int8: bool = False) -> np.ndarray:
        """All-pairs DNN CSI from rx-major planes (2, B, num_rx, len_ltf)
        float32 → (B, num_rx, num_tx, num_carriers) complex64.

        int8=False — CUDA: the fused factored kernels (bf16 operands);
        CPU: float32. int8=True — the quantized DNN (int8 weights folded
        once per predictor, dynamic per-row activation scales); CUDA: its
        products run the int8 GEMM kernel; CPU: its exact plain version.
        """
        x = torch.as_tensor(np.asarray(rx_planes, np.float32),
                            device=self.device)
        return self.all_pairs_planes(x, int8).cpu().numpy()

    def inference(self, input_batch: np.ndarray, pilot: np.ndarray):
        """input_batch: (B, len_ltf) complex; pilot: (B, num_tx).

        Returns the post-processed (B, out) complex prediction."""
        x = self.preprocess_data(input_batch)
        sig = torch.as_tensor(np.asarray(x, np.complex64), device=self.device)
        pil = torch.as_tensor(np.asarray(pilot, np.float32),
                              device=self.device)
        with full_f32_matmul():
            y = predict_complex(self.cfg, self.tcfg, self.params,
                                self.bn_state, sig, pil)
        return self.postprocess_data(y.cpu().numpy())

    # ------------------------------------------------------------------
    def preprocess_data(self, input_batch: np.ndarray) -> np.ndarray:
        if self.experiment == "RICE_RENEW":
            if input_batch.dtype != np.complex128:
                raise TypeError(
                    "[CSIPredictor] input batch must be complex128 for "
                    "RICE_RENEW (inference.py:41-43)")
        return input_batch

    def postprocess_data(self, out: np.ndarray) -> np.ndarray:
        if self.experiment == "RICE_RENEW":
            # reinsert null subcarriers and undo the fftshift
            # (inference.py:52-66; assumes FFT 64 / 52 active tones)
            if out.shape[1] != 52:
                raise ValueError(
                    "[CSIPredictor] RICE_RENEW output must have 52 tones")
            b = out.shape[0]
            tmp = np.concatenate(
                [np.zeros((b, 6), out.dtype), out[:, :26],
                 np.zeros((b, 1), out.dtype), out[:, 26:],
                 np.zeros((b, 5), out.dtype)], axis=1)
            return np.fft.ifftshift(tmp, axes=1)
        return out
