"""The estimation paths of the TPU bench (the port of
``mamimo_tpu/bench.py::make_estimation_fn`` and
``make_estimation_fn_planes``).

``make_estimation_fn`` returns one callable on time-major complex
preambles (B, len_ltf, num_rx), or on flat float32 planes with
``from_planes``, → (h_ls, h_dnn), each (B, C, num_tx, num_rx). The bench
times it as ``pallas_full`` (``ESTIMATION_PATHS``): with ``use_pallas``
the per-pair LS kernel (``ls_estimate_pallas``) and the fused MLP on the
materialized input (``mlp_infer_layer1``, ``mlp_infer_tail``, once per
plane); without it the float32 ``ls_estimate_matmul`` and
``predict_all_pairs``, or with ``use_bf16`` the fused factored DNN
kernels.

``make_estimation_fn_planes`` returns one callable, planes (2, S,
len_ltf) bfloat16 → (h_ls, h_dnn), chosen by the JAX function's keyword
options. The four paths the bench times on bf16 planes (all with
``input_bf16=True``), and the kernels each launches on the card
(``PATHS``):

- ``pallas_ls_bf16in`` — ``ls_pallas``: ``ls_planes_v1``,
  ``factored_sig_proj``, ``factored_tail``;
- ``pallas_ls_serving_bf16in`` — ``ls_pallas, serving_planes``: the same;
- ``int8_dnn_bf16in`` — ``dnn_int8``: ``matmul_int8``;
- ``pallas_ls_int8_bf16in`` — ``ls_pallas, dnn_int8``: ``ls_planes_v1``,
  ``matmul_int8``.

Without ``ls_pallas`` the LS half is the plain ``ls_estimate_planes``;
the bf16 DNN half is the fused factored kernels (the kernel form of the
``_factored_all_pairs`` that the JAX path runs in XLA); the int8 DNN half
is ``models/quant.py``. The serving form returns the LS kernel's raw
padded (hr, hi) and the DNN's (2, S, num_tx, C) planes, all bfloat16, as
the JAX path does. The float32-input options (``use_bf16``, ``ls_bf16``)
are ``CSIPredictor`` calls in the port and are not taken here.

The JAX module's timing harness (``_chained_step``,
``_chained_step_invariant``, ``_time_fn``, and ``make_estimation_fn``'s
``chained`` option) is not ported: it exists because the TPU runtime's
``block_until_ready`` could return before the work ran and identical
calls could be answered from a cache. On the card CUDA events around the
returned callable time it directly (``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    plane,
    predict_all_pairs,
    preprocess_signal,
    require_full_input,
)
from mamimo_tpu_torch.models.predictor import full_f32_matmul
from mamimo_tpu_torch.models.quant import (
    predict_all_pairs_planes_flat_int8,
    prepare_int8_serving,
    quantize_params_int8,
)
from mamimo_tpu_torch.ops.estimate import (
    ls_estimate_matmul,
    ls_estimate_planes,
    ls_matmul_constants,
    ls_planes_constants,
)
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    fused_factored_planes,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_estimate_pallas,
    ls_planes_pallas,
    ls_sm90_constants,
)
from mamimo_tpu_torch.ops.kernels.mlp_infer import (
    mlp_infer_pallas,
    prepare_mlp_infer_weights,
)
from mamimo_tpu_torch.ops.ltf import pilot_p_matrix

# the bench's names of the bf16-input planes paths and their options
PATHS = {
    "pallas_ls_bf16in": {"ls_pallas": True},
    "pallas_ls_serving_bf16in": {"ls_pallas": True, "serving_planes": True},
    "int8_dnn_bf16in": {"dnn_int8": True},
    "pallas_ls_int8_bf16in": {"ls_pallas": True, "dnn_int8": True},
}

# the bench's name of the per-pair path of make_estimation_fn
ESTIMATION_PATHS = {
    "pallas_full": {"use_pallas": True, "from_planes": True},
}


def _planes_to_time_major(planes: torch.Tensor, num_rx: int) -> torch.Tensor:
    """Flat (2, S, L) planes → (B, L, num_rx) complex64 (a transposed
    view of one complex copy)."""
    rx = torch.complex(planes[0].float(), planes[1].float())     # (S, L)
    s, L = rx.shape
    return rx.view(s // num_rx, num_rx, L).transpose(1, 2)


def make_estimation_fn(cfg: SimConfig, tcfg: TrainConfig, params, bn_state,
                       use_pallas: bool = False, use_bf16: bool = False,
                       from_planes: bool = False):
    """One estimation step: raw preambles → (LS estimate, DNN estimate),
    on the device of ``params`` (the port's stacked float32 parameters).
    Weights are folded once here, outside the step.

    - ``use_pallas``: the per-pair LS kernel, then the fused MLP kernels
      on the materialized input, one plane at a time: row (b, r, t) is
      [signal of (b, r) ‖ pilot P.T[t]], built directly in bf16 (the
      kernels round x to bf16; one (B·num_rx·num_tx, in_dim) buffer,
      reused by the two planes);
    - default: the float32 ``ls_estimate_matmul`` and factored
      ``predict_all_pairs`` (full float32 on the card);
    - ``use_bf16``: the float32 LS, and the DNN through the fused
      factored kernels (bf16 operands).

    Returns:
      fn(rx) → (h_ls, h_dnn), each (B, num_carriers, num_tx, num_rx)
      complex64; rx is (B, len_ltf, num_rx) complex64, or with
      ``from_planes`` flat planes (2, B·num_rx, len_ltf) float32, on the
      device of ``params`` (else ValueError).
    """
    dev = params["out"]["w"].device
    nt, nrx, C = cfg.num_tx, cfg.num_rx, cfg.num_carriers
    with full_f32_matmul():
        if use_pallas:
            prepared = prepare_mlp_infer_weights(tcfg, params, bn_state)
            pil = pilot_p_matrix(nt, device=dev).T.to(torch.bfloat16)
            kconsts = ls_sm90_constants(cfg, dev) \
                if dev.type == "cuda" else None
        elif use_bf16:
            factored = prepare_factored_weights(cfg, tcfg, params, bn_state)
    lsc = None if use_pallas else ls_matmul_constants(cfg, device=dev)

    def materialized_dnn(rx):
        b = rx.shape[0]
        sig = rx.transpose(1, 2).reshape(b * nrx, cfg.len_ltf)
        k_sig = preprocess_signal(cfg, tcfg, sig.real).shape[-1]
        x = torch.empty((b * nrx, nt, k_sig + nt), dtype=torch.bfloat16,
                        device=dev)
        x[:, :, k_sig:] = pil
        ys = []
        for d, part in enumerate((sig.real, sig.imag)):
            x[:, :, :k_sig] = preprocess_signal(cfg, tcfg, part)[:, None, :]
            ys.append(mlp_infer_pallas(
                tcfg, plane(prepared, d), None,
                x.view(b * nrx * nt, -1)))
        y = torch.complex(ys[0], ys[1]).view(b, nrx, nt, C)
        return y.permute(0, 3, 2, 1)

    def factored_dnn(rx):
        require_full_input(tcfg)
        b = rx.shape[0]
        sig = rx.transpose(1, 2).reshape(b * nrx, cfg.len_ltf)
        planes = torch.empty((2, b * nrx, cfg.len_ltf), dtype=torch.bfloat16,
                             device=dev)
        planes[0], planes[1] = sig.real, sig.imag
        y2 = fused_factored_planes(cfg, tcfg, factored, planes)
        y = torch.complex(y2[0], y2[1]).view(b, nrx, nt, C)
        return y.permute(0, 3, 2, 1)

    def estimate(rx):
        if rx.device != dev:
            raise ValueError(f"rx is on {rx.device}, the parameters on {dev}")
        if from_planes:
            rx = _planes_to_time_major(rx, nrx)
        if use_pallas:
            return ls_estimate_pallas(cfg, rx, consts=kconsts), \
                materialized_dnn(rx)
        with full_f32_matmul():
            h_ls = ls_estimate_matmul(cfg, rx, lsc)
            if use_bf16:
                return h_ls, factored_dnn(rx)
            return h_ls, predict_all_pairs(cfg, tcfg, params, bn_state, rx)

    return estimate


def make_estimation_fn_planes(cfg: SimConfig, tcfg: TrainConfig, params,
                              bn_state, *, input_bf16: bool = False,
                              ls_pallas: bool = False, dnn_int8: bool = False,
                              serving_planes: bool = False):
    """One estimation step on flat bf16 planes, on the device of
    ``params`` (the port's stacked float32 parameters). Weights are
    folded once here, outside the step.

    Returns:
      fn(planes (2, S, len_ltf) bfloat16) → (h_ls, h_dnn): each (S,
      num_tx, num_carriers) complex64; with serving_planes (and not
      dnn_int8) h_ls is the raw (hr, hi) bfloat16 pair and h_dnn the
      (2, S, num_tx, num_carriers) bfloat16 planes.
    """
    if not input_bf16:
        raise ValueError("only the bf16-input planes paths are ported; "
                         "CSIPredictor serves float32 planes")
    dev = params["out"]["w"].device
    kconsts = ls_sm90_constants(cfg, dev) if dev.type == "cuda" else None
    pconsts = ls_planes_constants(cfg, device=dev)

    def ls(planes):
        if ls_pallas:
            return ls_planes_pallas(cfg, planes, kconsts)
        return ls_estimate_planes(cfg, planes, pconsts)

    def check(planes):
        if planes.dtype != torch.bfloat16:
            raise TypeError(f"the bf16-input paths take bfloat16 planes, "
                            f"got {planes.dtype}")

    if dnn_int8:
        with full_f32_matmul():
            qparams = prepare_int8_serving(cfg, quantize_params_int8(
                tcfg, params, bn_state, sig_len=cfg.len_ltf))

        def estimate_int8(planes):
            check(planes)
            return ls(planes), predict_all_pairs_planes_flat_int8(
                cfg, tcfg, qparams, planes)

        return estimate_int8

    with full_f32_matmul():
        prepared = prepare_factored_weights(cfg, tcfg, params, bn_state)

    if serving_planes:
        def estimate_serving(planes):
            check(planes)
            h_ls = ls_planes_pallas(cfg, planes, kconsts, raw=True,
                                    out_dtype=torch.bfloat16)
            y2 = fused_factored_planes(cfg, tcfg, prepared, planes)
            return h_ls, y2.to(torch.bfloat16)

        return estimate_serving

    def estimate(planes):
        check(planes)
        y2 = fused_factored_planes(cfg, tcfg, prepared, planes)
        return ls(planes), torch.complex(y2[0], y2[1])

    return estimate
