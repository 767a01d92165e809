"""The port's counterpart of ``__graft_entry__.py::entry``: the serving
step of the flagship model at full BS32 size, for a one-call check that
it runs.

``dryrun_multichip`` (the DP+TP training step over a mesh) needs the
sharded training step and waits for it (ROADMAP.md).
"""

from __future__ import annotations

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import init_stacked
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    fused_factored_planes,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_planes_v2,
    ls_sm90_constants,
)
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def entry(device=None):
    """The fused preamble → (LS, DNN) estimation step of BS32, with
    seeded random weights.

    On the card: the LS kernel ``ls_planes_v2`` with its bf16 store and
    the fused factored DNN kernels, their output cast to bf16 (the JAX
    entry's TPU path: LS v2 with ``out_dtype=bfloat16`` and the bf16
    factored DNN). On the CPU, the kernels' plain versions.

    Args:
      device: where the step runs; None means cuda:0 (raises without a
        CUDA device).

    Returns:
      (fn, (planes,)): planes (2, 16, len_ltf) float32 normal (4 packets),
      and fn(planes) → (h_ls, h_dnn), each (2, S, num_tx, num_carriers)
      bfloat16 planes.
    """
    dev = resolve_device("cuda:0" if device is None else device)
    cfg, tcfg = SimConfig(), TrainConfig()
    params, bn_state = init_stacked(torch.Generator().manual_seed(0), cfg,
                                    tcfg, device=dev)
    consts = ls_sm90_constants(cfg, dev) if dev.type == "cuda" else None
    with full_f32_matmul():
        prepared = prepare_factored_weights(cfg, tcfg, params, bn_state)

    def fn(planes):
        pl16 = planes.to(torch.bfloat16)
        h_ls = ls_planes_v2(cfg, pl16, consts, out_dtype=torch.bfloat16)
        h_dnn = fused_factored_planes(cfg, tcfg, prepared, pl16)
        return h_ls, h_dnn.to(torch.bfloat16)

    g = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((2, 4 * cfg.num_rx, cfg.len_ltf), generator=g,
                         device=dev)
    return fn, (planes,)
