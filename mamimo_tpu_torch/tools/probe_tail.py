#!/usr/bin/env python3
"""Where the fused factored tail kernel spends its time, on the card.

    python3 mamimo_tpu_torch/tools/probe_tail.py

Two measurements at the full BS32 width (H = 1024, num_tx = 32,
234 carriers), random seeded weights, CUDA events:

1. blocks in flight: the kernel at S = 64, 128, 256 and 4096 rows
   (64 to 4096 blocks). If its time per wave of 132 blocks stays flat,
   the limit is inside each SM, not a resource the SMs share (L2, HBM);
2. ablations: the kernel built with ``-DTAIL_CUT=<bits>`` (see
   ``csrc/mlp_tail.cuh``), each cutting one phase out (building h,
   the whole ring loop, the layer-3 products, all products), timed at
   S = 4096. The differences split the kernel's time by phase.

The cut builds compute wrong answers by design and are never used
outside this probe. PERF.md section 5 cites this probe's phase split;
keep it while it does.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CUTS = {                 # TAIL_CUT bits of csrc/mlp_tail.cuh
    "no h build": 1,
    "no ring loop": 2,
    "no layer-3 mma": 4,
    "no mma": 4 | 8,
}


def _time_ms(fn, iters=10):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_tail: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _TAIL_KEYS,
        _ff_lib,
        factored_tail,
        prepare_factored_weights,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    _build.build_all()
    cfg, tcfg = SimConfig(), TrainConfig()
    C, nt, H = cfg.num_carriers, cfg.num_tx, tcfg.hidden[0]
    params, bn = init_stacked(torch.Generator().manual_seed(0), cfg, tcfg,
                              device="cuda")
    prep = prepare_factored_weights(cfg, tcfg, params, bn)
    g = torch.Generator(device="cuda").manual_seed(1)

    print("blocks in flight:")
    for s in (64, 128, 256, 4096):
        sp = torch.randn((2, s, H), generator=g, device="cuda")
        ms = _time_ms(lambda: factored_tail(prep, sp, C))
        blocks = 2 * nt * -(-s // 64)
        waves = -(-blocks // 132)
        print(f"  S={s}: {blocks} blocks, {waves} waves, {ms:.4f} ms, "
              f"{ms / waves * 1e3:.1f} us per wave")

    print("ablations at S=4096:")
    s = 4096
    sp = torch.randn((2, s, H), generator=g, device="cuda")
    out = torch.empty((2, s, nt, C), device="cuda")
    args = [sp.data_ptr(), *(prep[k].data_ptr() for k in _TAIL_KEYS),
            out.data_ptr(), s, nt, H, C]
    libs = {"full": _ff_lib()}
    libs.update({name: _ff_lib((f"TAIL_CUT={bits}",))
                 for name, bits in CUTS.items()})
    for name, lib in libs.items():
        def run(lib=lib):
            rc = lib.factored_tail_launch(
                *args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        print(f"  {name}: {_time_ms(run):.4f} ms  [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
