#!/usr/bin/env python3
"""The train-parity gate of the training throughput knobs, on the card
(the port of ``scripts/run_train_parity_tpu.py``).

    python3 mamimo_tpu_torch/tools/train_parity.py [--variants f32,bf16]

Generates the JAX script's corpus recipe (BS32, seed 21, 1000 noiseless
packets at 120 dB), trains the BS32 model on it under each variant with
``fit`` (batch 256, 16 steps a ``.multi`` call, 60 epochs, seed 0, the
default AWGN method) and compares each variant's best validation MSE per
plane with the f32 run's (``parity_db``, 10·log10 of the ratio), as the
JAX script does, and the f32 run with the JAX package's recorded f32
best val MSE (``results/train_parity.json``; a gap above 0.3 dB on either
plane is reported as a miss). Variants:

  f32              float32 products (TF32 off), torch.randn AWGN, f32 Adam
  bf16             bf16 product operands
  f32_rbg          the 'rbg' AWGN choice (torch.randn in the port too)
  bf16_rbg_mubf16  bf16 products + 'rbg' + bf16 Adam first moment
  f32_rbgclt       the Irwin-Hall byte-sum AWGN ('rbg_clt')

A suffix ``_seedN`` trains a variant from seed N (the initial weights,
the batch order and the noise; default 0): ``f32_seed1,f32_seed2`` give
the spread of the f32 run itself.

The user placement is the one JAX's seed 21 draws
(``JAX_SEED21_PLACEMENT``, its range, azimuth and elevation, held to
JAX's ``make_scenario`` by ``tests/test_torch_fit.py``); the packets are
then drawn by the port's per-packet generators. The JAX comparison is
made only at the recorded recipe (BS32, 1000 packets, 60 epochs).
Resumable per variant: a variant already in ``--out`` (same config,
packets and epochs) is skipped, and each fit resumes from its own
workdir, ``<workdir>/BS<nt>x<nr>_<packets>p_<epochs>e/<variant>``, so
another recipe never resumes this one's checkpoints. A fit that runs no
epoch (its workdir already at the end) is refused, not recorded. Writes
``--out`` after every variant, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX_RECORD = ROOT / "results" / "train_parity.json"
GAP_LIMIT_DB = 0.3
# the placement the JAX package draws for seed 21 (make_scenario on the
# first half of split(PRNGKey(21))): range (m), azimuth, elevation (deg),
# float32 values
JAX_SEED21_PLACEMENT = {"mobile_range": 32.0,
                        "mobile_az": 91.28870391845703,
                        "mobile_el": 43.45656967163086}


def log(m: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def variant_config(name: str, epochs: int):
    """The TrainConfig of a variant (the JAX script's mapping, and
    ``_seedN`` for the training seed)."""
    from mamimo_tpu_torch.config import TrainConfig

    name, _, seed = name.partition("_seed")
    awgn = "threefry"
    if "_rbgclt" in name:
        awgn = "rbg_clt"
    elif "_rbg" in name:
        awgn = "rbg"
    return TrainConfig(epochs=epochs, seed=int(seed or 0), steps_per_call=16,
                       matmul_dtype=name.split("_")[0], awgn_rng=awgn,
                       opt_dtype="bf16" if "_mubf16" in name else "f32")


def jax_placement(cfg, device):
    """The port's Scenario of the JAX package's seed-21 placement."""
    import torch

    from mamimo_tpu_torch.channel.scattering import scenario_from_draws

    p = JAX_SEED21_PLACEMENT
    return scenario_from_draws(
        cfg, torch.tensor(int(p["mobile_range"]), device=device),
        torch.tensor(p["mobile_az"], dtype=torch.float32, device=device),
        torch.tensor(p["mobile_el"], dtype=torch.float32, device=device),
        device)


def resumed_epoch(workdir: str) -> int:
    """The epoch a resumed fit in workdir starts from (0 when new)."""
    meta = os.path.join(workdir, "last.json")
    if not os.path.exists(meta):
        return 0
    with open(meta) as f:
        return int(json.load(f).get("extra", {}).get("epoch", 0))


def card(device) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packets", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--num-tx", type=int, default=32)
    ap.add_argument("--num-rx", type=int, default=4)
    ap.add_argument("--workdir", default="runs/train_parity_h100")
    ap.add_argument("--out", default="results/train_parity_h100.json")
    ap.add_argument("--variants",
                    default="f32,bf16,f32_rbg,bf16_rbg_mubf16,f32_rbgclt")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch

    from mamimo_tpu_torch.config import SimConfig
    from mamimo_tpu_torch.models.predictor import resolve_device
    from mamimo_tpu_torch.pipeline.dataset import generate_dataset
    from mamimo_tpu_torch.train import fit

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SimConfig(num_tx=args.num_tx, num_rx=args.num_rx)
    out = {"config": f"BS{args.num_tx}", "num_rx": args.num_rx,
           "packets": args.packets, "epochs": args.epochs,
           "corpus": {"seed": 21, "snr_db": 120.0, "placement": "jax"},
           "device": card(dev), "runs": {}}
    recipe = f"{out['config']}x{args.num_rx}_{args.packets}p_{args.epochs}e"
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if (prev.get("config"), prev.get("num_rx", 4), prev.get("packets"),
                prev.get("epochs"), prev.get("corpus", {}).get("placement")
            ) == (out["config"], args.num_rx, args.packets, args.epochs,
                  "jax"):
            out["runs"].update(prev.get("runs", {}))
    todo = [v for v in args.variants.split(",") if v not in out["runs"]]
    log(f"{out['device']}; variants to run: {todo}")

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)

    if todo:
        t0 = time.perf_counter()
        ds = generate_dataset(cfg, seed=21, num_packets=args.packets,
                              snr_db=120.0, chunk=50,
                              scenario=jax_placement(cfg, dev), device=dev)
        out["corpus"]["mobile_range_m"] = float(ds.scenario.mobile_range)
        out["corpus"]["tau_mean_s"] = float(ds.tau.mean())
        gen_s = time.perf_counter() - t0
        log(f"corpus: {ds.num_packets} packets in {gen_s:.1f} s")
    for name in todo:
        tcfg = variant_config(name, args.epochs)
        wd = os.path.join(args.workdir, recipe, name)
        start = resumed_epoch(wd)
        t0 = time.perf_counter()
        res = fit(cfg, tcfg, ds, workdir=wd, resume=True, device=dev)
        dt = time.perf_counter() - t0
        ran = res.epochs_ran - start
        if ran <= 0:
            raise SystemExit(f"{name}: the fit in {wd} ran no epoch (it "
                             f"resumed at epoch {start}); not recorded")
        per_pkt = cfg.num_tx * cfg.num_rx
        n_val = int(np.floor(ds.num_packets * tcfg.val_train_ratio))
        steps = (ds.num_packets - n_val) * per_pkt // tcfg.batch_size
        out["runs"][name] = {
            "best_val_mse": [float(v) for v in res.best_val],
            "epochs_ran": res.epochs_ran, "resumed_from_epoch": start,
            "wall_s": dt, "s_per_epoch": dt / ran,
            "steps_per_epoch": steps,
            "steps_per_s": steps * ran / dt,
            "tcfg": json.loads(tcfg.to_json()),
            "final_loss": [res.history["loss_real"][-1],
                           res.history["loss_imag"][-1]],
            "device": out["device"]["nvidia_smi"]}
        log(f"{name}: best val {res.best_val.tolist()} ({res.epochs_ran} "
            f"epochs, {dt:.1f} s)")
        write()

    runs = out["runs"]
    if "f32" in runs:
        f32 = np.asarray(runs["f32"]["best_val_mse"])
        out["parity_db"] = {
            k: [float(10 * np.log10(v)) for v in
                np.asarray(r["best_val_mse"]) / f32]
            for k, r in runs.items() if k != "f32"}
        if JAX_RECORD.exists() and (
                args.num_tx, args.num_rx, args.packets, args.epochs) == (
                    32, 4, 1000, 60):
            with open(JAX_RECORD) as f:
                jax_f32 = np.asarray(json.load(f)["runs"]["f32"]
                                     ["best_val_mse"])
            gap = 10 * np.log10(f32 / jax_f32)
            out["vs_jax_f32"] = {
                "jax_best_val_mse": jax_f32.tolist(),
                "port_best_val_mse": f32.tolist(),
                "gap_db": gap.tolist(), "limit_db": GAP_LIMIT_DB,
                "within_limit": bool(np.all(np.abs(gap) <= GAP_LIMIT_DB))}
    write()
    log(f"parity vs f32 (dB per plane): {out.get('parity_db')}; vs the JAX "
        f"package's f32: {out.get('vs_jax_f32')} -> {args.out}")
    print(json.dumps({k: out.get(k) for k in ("device", "parity_db",
                                              "vs_jax_f32")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
