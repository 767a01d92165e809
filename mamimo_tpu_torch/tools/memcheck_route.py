#!/usr/bin/env python3
"""The bf16 two-GEMM route at widths whose last 256-column tile is half
past the layer (H2 % 256 = 128), small, for a memory checker.

    PYTORCH_NO_CUDA_MEMORY_CACHING=1 compute-sanitizer --tool memcheck \\
        python3 mamimo_tpu_torch/tools/memcheck_route.py

Runs, on the card at S = 16 requests of BS32 rows (512 rows a plane):
``factored_dense``'s hidden layer of 640 units and ``factored_rows_tail``
(its last hidden layer of 640 units and the output) of a (1536, 640,
640) model, and ``mlp_infer_tail`` at 1152 units, each on its two-GEMM
walk (``csrc/mm_sm90.cuh``, ``rows_gemm_kernel``), then synchronizes and
prints one line. With the caching allocator off every tensor is its own
device allocation, so a read past a bias or affine vector lands outside
it, where the memory checker reports it. Builds nothing that the
package has not built (``_build``). Card only.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("memcheck_route: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, plane
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        factored_dense,
        factored_rows_tail,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        mlp_infer_tail,
        prepare_mlp_infer_weights,
    )

    cfg, dev, bf16 = SimConfig(), torch.device("cuda", 0), torch.bfloat16
    m = 16 * cfg.num_tx
    g = torch.Generator(device=dev).manual_seed(3)
    tw = TrainConfig(hidden=(1536, 640, 640))
    p, b = init_stacked(torch.Generator().manual_seed(1), cfg, tw,
                        device=dev)
    prep = prepare_factored_weights(cfg, tw, p, b)
    h = torch.relu(torch.randn((2, m, 1536), generator=g,
                               device=dev)).to(bf16)
    h2 = factored_dense(prep, 2, h)                    # 640 units
    y = factored_rows_tail(prep, h2, cfg.num_carriers)  # 640, then out
    tw = TrainConfig(hidden=(1152, 1152))
    p, b = init_stacked(torch.Generator().manual_seed(2), cfg, tw,
                        device=dev)
    pm = plane(prepare_mlp_infer_weights(tw, p, b), 0)
    ym = mlp_infer_tail(pm, torch.relu(torch.randn(
        (m, 1152), generator=g, device=dev)).to(bf16))
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(y).all() and torch.isfinite(ym).all())
    print(f"memcheck_route: factored_dense (640), factored_rows_tail "
          f"(640, output), mlp_infer_tail (1152) ran, outputs "
          f"{'finite' if ok else 'NOT finite'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
