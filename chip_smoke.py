#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases (each prints one line, any
failure ends the run with a non-zero exit code):

1. card     — device name, and name + power limit from nvidia-smi;
2. build    — nvcc builds every kernel of mamimo_tpu_torch/csrc (one
              process per source, all at once);
3. kernels  — each hand-written kernel against its plain PyTorch version
              on the same inputs, at the full BS32 width (Nt=32, Nr=4,
              hidden 1024/1024, len_ltf 10240), S = 256 rows; then at
              S = 28 and on a small config (Nt=8, hidden 128, S = 11),
              where the last tiles are partly empty;
4. physics  — the sounding preamble through random flat channels, no
              noise: the served LS must recover every channel on every
              carrier;
5. serving  — a glorot-initialized model (seeded torch.Generator) saved
              as an npz checkpoint, loaded by CSIPredictor on the card,
              answers 3 requests of 64 packets; every kernel's launch
              count must have risen during those requests;
6. timing   — each kernel, its plain version and a library yardstick at
              the bench shape (1024 packets, S = 4096), CUDA events.

Prints a JSON line of per-kernel numbers before the last line, which is
{"ok": true, "device": {...}}. Needs a CUDA GPU and the repository's
sources; exits non-zero without either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM bf16 dense tensor cores
S_CHECK = 256                      # rows of the kernel checks (64 packets)
BENCH_PACKETS = 1024               # the bench shape: S = 4096


def nmse_db(got, ref) -> float:
    """NMSE of numpy arrays (real or complex) in dB, in float64."""
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                               / np.sum(np.abs(ref) ** 2)))


def check(name: str, got, ref, limit_db: float) -> dict:
    """Hold a kernel's output to its reference: NMSE <= limit_db and all
    values finite; raises otherwise."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    db, err = nmse_db(got, ref), float(np.abs(got - ref).max())
    print(f"  {name}: NMSE {db:.2f} dB (limit {limit_db} dB), "
          f"max|err| {err:.3e}, max|ref| {np.abs(ref).max():.3e}")
    if not db <= limit_db:
        raise AssertionError(f"{name}: NMSE {db:.2f} dB > {limit_db} dB")
    # an exact match has NMSE -inf, which JSON cannot hold
    return {"nmse_db": db if db > float("-inf") else None,
            "max_abs_err": err}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
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


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def make_model(cfg, tcfg, seed: int, device):
    """Glorot weights from a seeded generator, rounded to bf16 values so
    the float32 references and the bf16 kernels share them, and a
    non-trivial BN state (so the folded affines matter)."""
    import torch

    from mamimo_tpu_torch.models.mlp import init_stacked, tree_map

    g = torch.Generator().manual_seed(seed)
    params, bn = init_stacked(g, cfg, tcfg)
    for lyr in params["dense"] + [params["out"]]:
        lyr["w"] = lyr["w"].to(torch.bfloat16).float()
        lyr["b"] = 0.05 * torch.randn(lyr["b"].shape, generator=g)
    for i, b in enumerate(params["bn"]):
        b["scale"] = 0.5 + torch.rand(b["scale"].shape, generator=g)
        b["bias"] = 0.1 * torch.randn(b["bias"].shape, generator=g)
        bn["mean"][i] = 0.1 * torch.randn(bn["mean"][i].shape, generator=g)
        bn["var"][i] = 0.5 + 1.5 * torch.rand(bn["var"][i].shape, generator=g)
    to = lambda t: t.to(device)                              # noqa: E731
    return tree_map(to, params), tree_map(to, bn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "mamimo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no mamimo_tpu_torch sources",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import _factored_all_pairs
    from mamimo_tpu_torch.models.predictor import CSIPredictor
    from mamimo_tpu_torch.ops.estimate import ls_estimate_planes, ls_planes_constants
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _tail_plain,
        factored_sig_proj,
        factored_tail,
        fused_factored_planes,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        ls_kernel_constants,
        ls_planes_pallas_v2_constants,
        ls_planes_v2,
    )
    from mamimo_tpu_torch.ops.ltf import gen_preamble, preamble_scale
    from mamimo_tpu_torch.train.ckpt import save_checkpoint

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. card ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1 card] {name}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi)

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            print(f"  {src}: {line.strip()}")

    # 3. kernels against their plain versions --------------------------
    def check_kernels(cfg, tcfg, s, seed, tag):
        """Each kernel against its plain version on the same bf16 inputs
        and a seeded model; returns the model and the per-kernel
        results."""
        params, bn = make_model(cfg, tcfg, seed=seed, device=dev)
        prep = prepare_factored_weights(cfg, tcfg, params, bn)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        x16 = torch.randn((2, s, cfg.len_ltf), generator=g,
                          device=dev).to(torch.bfloat16)
        x32 = x16.float()
        print(f"[3 kernels] {tag}: Nt {cfg.num_tx}, hidden {tcfg.hidden}, "
              f"S = {s}")
        res = {}
        ls2 = ls_planes_v2(cfg, x16, ls_kernel_constants(cfg, dev))
        h = ls_estimate_planes(cfg, x32, ls_planes_constants(cfg, device=dev))
        res["ls_planes_v2"] = check(
            "ls_planes_v2 vs ls_estimate_planes (f32)",
            ls2, torch.stack([h.real, h.imag]), -45.0)
        sp = factored_sig_proj(x16, prep["w1"])
        res["factored_sig_proj"] = check(
            "factored_sig_proj vs f32 x @ W1 (same bf16 operands)",
            sp, x32 @ prep["w1"].float(), -70.0)
        y = factored_tail(prep, sp, cfg.num_carriers)
        res["factored_tail"] = check(
            "factored_tail vs its plain version (same sig_proj)",
            y, _tail_plain(prep, sp, cfg.num_carriers), -40.0)
        check("fused DNN vs f32 _factored_all_pairs (bf16-valued weights)",
              fused_factored_planes(cfg, tcfg, prep, x16),
              _factored_all_pairs(cfg, tcfg, params, bn, x32), -40.0)
        torch.cuda.synchronize()
        return params, bn, prep, res

    cfg, tcfg = SimConfig(), TrainConfig()
    params, bn, prep, res = check_kernels(cfg, tcfg, S_CHECK, 0,
                                          "BS32, full width")
    # ragged edges: rows past the last full tile of each kernel
    check_kernels(cfg, tcfg, 7 * cfg.num_rx, 10, "BS32, 7 packets")
    check_kernels(SimConfig(num_tx=8, num_rx=2), TrainConfig(hidden=(128, 128)),
                  11, 20, "small config, odd S")
    consts = ls_kernel_constants(cfg, dev)
    f32_consts = ls_planes_constants(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)

    # 4. physics: noiseless preamble through flat channels -------------
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(str(Path(tmp) / "best"), cfg, tcfg, params, bn)
        pred = CSIPredictor(tmp, device="cuda")
    nb, nt, nr = 64, cfg.num_tx, cfg.num_rx
    gc = torch.Generator().manual_seed(2)
    H = torch.complex(torch.randn((nb, nt, nr), generator=gc),
                      torch.randn((nb, nt, nr), generator=gc)).numpy()
    pre = gen_preamble(cfg)                                 # (L, Nt)
    rx = pre[None] @ H                                      # (B, L, Nr)
    rxm = rx.transpose(0, 2, 1).reshape(nb * nr, cfg.len_ltf)
    planes = np.stack([rxm.real, rxm.imag]).astype(np.float32)
    h_ls, _ = pred.estimate_full(planes)                    # (S, Nt, C)
    want = np.broadcast_to(
        (H.transpose(0, 2, 1).reshape(nb * nr, nt)
         * preamble_scale(cfg, nt))[:, :, None], h_ls.shape)
    err = nmse_db(h_ls, want)
    worst = max(nmse_db(h_ls[..., c], want[..., c])
                for c in range(cfg.num_carriers))
    print(f"[4 physics] {nb} packets, flat channels, no noise: served LS "
          f"NMSE {err:.2f} dB, worst carrier {worst:.2f} dB (limit -40 dB "
          f"on every carrier)")
    if not worst <= -40.0:
        raise AssertionError(f"physics: a carrier's LS NMSE is {worst:.2f} dB "
                             f"> -40 dB")

    # 5. serving: the main path, counted --------------------------------
    counted = (ls_planes_v2, factored_sig_proj, factored_tail)
    for k in counted:
        k.launches = 0
    gr = torch.Generator().manual_seed(3)
    reqs = [torch.randn((2, 64 * nr, cfg.len_ltf), generator=gr).numpy()
            for _ in range(3)]
    outs = [pred.estimate_full(r) for r in reqs]
    launches = {k.__name__: k.launches for k in counted}
    shape = (64 * nr, nt, cfg.num_carriers)
    for h_ls, h_dnn in outs:
        for a in (h_ls, h_dnn):
            if a.shape != shape or a.dtype.name != "complex64":
                raise AssertionError(f"served {a.shape} {a.dtype}, "
                                     f"want {shape} complex64")
            if not np.isfinite(a).all():
                raise AssertionError("served non-finite values")
    # the first answer against the float32 plain versions on the f32 input
    x0 = torch.from_numpy(reqs[0]).to(dev)
    h0 = ls_estimate_planes(cfg, x0, f32_consts).cpu().numpy()
    d0 = _factored_all_pairs(cfg, tcfg, params, bn, x0).cpu()
    d0 = (d0[0] + 1j * d0[1]).numpy()
    served = {}
    for nm, got, ref in (("h_ls", outs[0][0], h0), ("h_dnn", outs[0][1], d0)):
        db = served[nm] = nmse_db(got, ref)
        if not db <= -40.0:
            raise AssertionError(f"served {nm}: NMSE {db:.2f} dB > -40 dB")
    print(f"[5 serving] 3 requests x 64 packets -> {shape} complex64 x2, "
          f"finite; vs f32 plain: h_ls {served['h_ls']:.2f} dB, "
          f"h_dnn {served['h_dnn']:.2f} dB; launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")

    # 6. timing at the bench shape --------------------------------------
    S = BENCH_PACKETS * nr
    H1 = tcfg.hidden[0]
    L, C = cfg.len_ltf, cfg.num_carriers
    xb16 = torch.randn((2, S, L), generator=g, device=dev).to(torch.bfloat16)
    xb32 = xb16.float()
    print(f"[6 timing] S = {S} ({BENCH_PACKETS} packets), {smi}")
    rows = []

    # LS: kernel, plain (f32), library (bf16 matmul DFT-select + despread)
    bv2, _ = ls_planes_pallas_v2_constants(cfg, 1, torch.bfloat16, dev)
    cp_ = bv2.shape[1] // 2
    pm = f32_consts[2]

    def ls_library():
        t = torch.matmul(xb16.view(2, S * nt, cfg.sym_len), bv2).float()
        zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
        zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
        z = torch.stack([zr, zi]).view(2, S, nt, C)
        return torch.matmul(pm, z)

    # the kernel reads only the fft samples of each symbol, never the CP
    ls_bytes = (2 * S * nt * cfg.fft_length * 2 + consts.numel() * 2
                + 2 * S * nt * C * 4)
    ls_flops = 2.0 * (S * nt) * (2 * cfg.fft_length) * (2 * C)
    rows.append(("ls_planes_v2", "mamimo_tpu_torch/csrc/ls_v2.cu",
                 "mamimo_tpu/ops/pallas/fused_ls.py:424",
                 lambda: ls_planes_v2(cfg, xb16, consts),
                 lambda: ls_estimate_planes(cfg, xb32, f32_consts),
                 ls_library, ls_bytes, ls_flops))

    spb = factored_sig_proj(xb16, prep["w1"])
    w1f = prep["w1"].float()
    sp_bytes = 2 * S * L * 2 + prep["w1"].numel() * 2 + 2 * S * H1 * 4
    sp_flops = 2.0 * 2 * S * L * H1
    rows.append(("factored_sig_proj", "mamimo_tpu_torch/csrc/fused_factored.cu",
                 "mamimo_tpu/ops/pallas/fused_factored.py:169",
                 lambda: factored_sig_proj(xb16, prep["w1"]),
                 lambda: torch.matmul(xb32, w1f),
                 lambda: torch.matmul(xb16, prep["w1"]), sp_bytes, sp_flops))

    H2 = tcfg.hidden[1]

    def tail_library():
        p = prep
        hh = (torch.relu(spb[:, :, None, :] + p["hb"][:, None])
              * p["a1"][:, None] + p["c1"][:, None]).to(torch.bfloat16)
        h2 = torch.relu(torch.matmul(hh, p["w2"][:, None]) + p["b2"][:, None])
        h2 = (h2 * p["a2"][:, None] + p["c2"][:, None]).to(torch.bfloat16)
        return torch.matmul(h2, p["w3"][:, None])[..., :C]

    tail_bytes = (2 * S * H1 * 4 + sum(prep[k].numel() * prep[k].element_size()
                                       for k in ("hb", "a1", "c1", "w2", "b2",
                                                 "a2", "c2", "w3", "b3"))
                  + 2 * S * nt * C * 4)
    tail_flops = 2.0 * 2 * S * nt * (H1 * H2 + H2 * C)
    rows.append(("factored_tail", "mamimo_tpu_torch/csrc/fused_factored.cu",
                 "mamimo_tpu/ops/pallas/fused_factored.py:169",
                 lambda: factored_tail(prep, spb, C),
                 lambda: _tail_plain(prep, spb, C),
                 tail_library, tail_bytes, tail_flops))

    kernels = []
    for (kname, src, repl, kern, plain, lib, nbytes, flops) in rows:
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(lib)
        bms, by = bound_ms(nbytes, flops)
        print(f"  {kname}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
              f"{bms / ms * 100:.1f}% of it); plain {plain_ms:.4f} ms; "
              f"library {lib_ms:.4f} ms  [{smi}]")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname],
            "max_abs_err": res[kname]["max_abs_err"],
            "nmse_db": res[kname]["nmse_db"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
        })

    # the whole serving call on the device (planes in, both estimates out)
    xf = xb32.contiguous()
    full_ms = time_ms(lambda: pred.serve_planes(xf), iters=10)
    n_est = S * nt
    print(f"  estimate_full device time: {full_ms:.4f} ms for {n_est} "
          f"estimates = {n_est / full_ms * 1e3:.6g} estimates/s  [{smi}]")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels, "serving": {
        "S": S, "estimate_full_ms": full_ms,
        "estimates_per_s": n_est / full_ms * 1e3,
        "served_nmse_db": served, "physics_ls_nmse_db": err,
        "physics_worst_carrier_nmse_db": worst},
        "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
