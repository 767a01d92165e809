"""The bf16-input estimation paths on flat planes (the port of
``mamimo_tpu/bench.py::make_estimation_fn_planes``).

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
``_chained_step_invariant``, ``_time_fn``) is not ported: it exists
because the TPU runtime's ``block_until_ready`` could return before the
work ran and identical calls could be answered from a cache. On the card
CUDA events around the returned callable time it directly
(``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.predictor import full_f32_matmul
from mamimo_tpu_torch.models.quant import (
    predict_all_pairs_planes_flat_int8,
    prepare_int8_serving,
    quantize_params_int8,
)
from mamimo_tpu_torch.ops.estimate import ls_estimate_planes, ls_planes_constants
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    fused_factored_planes,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_kernel_constants,
    ls_planes_pallas,
)

# the bench's names of the bf16-input planes paths and their options
PATHS = {
    "pallas_ls_bf16in": {"ls_pallas": True},
    "pallas_ls_serving_bf16in": {"ls_pallas": True, "serving_planes": True},
    "int8_dnn_bf16in": {"dnn_int8": True},
    "pallas_ls_int8_bf16in": {"ls_pallas": True, "dnn_int8": True},
}


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
    kconsts = ls_kernel_constants(cfg, dev) if dev.type == "cuda" else None
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
