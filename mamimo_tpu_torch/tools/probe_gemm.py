#!/usr/bin/env python3
"""The two layer-1 GEMM kernels (csrc/gemm_sm90.cuh) across shapes, on
the card, each beside one bf16 ``torch.matmul`` of the same operands.

    python3 mamimo_tpu_torch/tools/probe_gemm.py

``mlp_infer_layer1`` (bias, ReLU and affine epilogue, bf16 h1) at M =
8192, 32768 and 131072 rows with K = 10272 (the materialized input) and
10240 (a 64-multiple), H1 = 1024; ``factored_sig_proj`` (f32 output) at
S = 4096 and 16384, L = 10240, H = 1024. Seeded random operands, CUDA
events, kernel and matmul timed in turns (kernel, matmul, matmul,
kernel); prints each time, its TFLOP/s and the card's name and power
limit. The matmul writes bf16 and has no epilogue: it is a yardstick,
not the same function. The card's clocks sag over a run, so compare
only within one line.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MLP_SHAPES = ((8192, 10272), (32768, 10272), (131072, 10272),
              (131072, 10240))
SIG_ROWS = (4096, 16384)
H = 1024


def _time_ms(fn, iters):
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


def _turns(kernel, matmul, iters):
    """(kernel ms, matmul ms), each the better of two turns."""
    k1, m1 = _time_ms(kernel, iters), _time_ms(matmul, iters)
    m2, k2 = _time_ms(matmul, iters), _time_ms(kernel, iters)
    return min(k1, k2), min(m1, m2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mamimo_tpu_torch.ops.kernels.fused_factored import factored_sig_proj
    from mamimo_tpu_torch.ops.kernels.mlp_infer import mlp_infer_layer1

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    m_max, k_max = max(m for m, _ in MLP_SHAPES), max(k for _, k in MLP_SHAPES)
    xbuf = torch.randn((m_max * k_max,), generator=g, device=dev).to(bf16)
    print(f"probe_gemm on {smi}")
    for m, k in MLP_SHAPES:
        x = xbuf[:m * k].view(m, k)
        kp = -(-k // 32) * 32
        w1 = torch.zeros((kp, H), device=dev)
        w1[:k] = 0.02 * torch.randn((k, H), generator=g, device=dev)
        w1 = w1.to(bf16)
        p = {"w1": w1, "w1t": w1.T.contiguous(),
             "b1": torch.zeros(H, device=dev), "s1": torch.ones(H, device=dev),
             "t1": torch.zeros(H, device=dev)}
        iters = max(3, 20 * 8192 // m)
        ms, mm = _turns(lambda: mlp_infer_layer1(p, x),
                        lambda: torch.matmul(x, w1[:k]), iters)
        tf = 2.0 * m * k * H / 1e9
        print(f"  mlp_infer_layer1 ({m}, {k}) @ ({k}, {H}): {ms:.4f} ms "
              f"({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
              f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)
    for s in SIG_ROWS:
        L = 10240
        x = xbuf[:2 * s * L].view(2, s, L)
        w = (0.02 * torch.randn((2, L, H), generator=g, device=dev)).to(bf16)
        wt = w.transpose(1, 2).contiguous()
        iters = max(3, 20 * 4096 // s)
        ms, mm = _turns(lambda: factored_sig_proj(x, w, wt),
                        lambda: torch.matmul(x, w), iters)
        tf = 2.0 * 2 * s * L * H / 1e9
        print(f"  factored_sig_proj (2, {s}, {L}) @ (2, {L}, {H}): "
              f"{ms:.4f} ms ({tf / ms:.0f} TFLOP/s); matmul {mm:.4f} ms "
              f"({tf / mm:.0f} TFLOP/s)  [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
