"""Command-line interface of the port (the counterpart of
``mamimo_tpu/cli.py``): the same subcommands, flags and outputs, plus
``--device``, which defaults to the card:

    python3 -m mamimo_tpu_torch.cli gen      — generate a sounding dataset
    python3 -m mamimo_tpu_torch.cli train    — train the CSI denoiser
    python3 -m mamimo_tpu_torch.cli test     — predict + export + NMSE report
    python3 -m mamimo_tpu_torch.cli sweep    — metrics vs SNR (+ closed loop,
                                               + multi-user JSDM)
    python3 -m mamimo_tpu_torch.cli pipeline — gen → train → sweep
    python3 -m mamimo_tpu_torch.cli convert  — reference .mat/.b ↔ native npz
    python3 -m mamimo_tpu_torch.cli bench    — throughput benchmark

``train --dp/--tp`` trains over a ``data`` (× ``model``) mesh of the first
dp·tp visible cards, or, with ``--device``, of dp·tp ranks on that one
device (``--device cpu`` in the tests).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda; the run "
                        "fails without one)")


def _add_sim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-tx", type=int, default=32)
    p.add_argument("--num-rx", type=int, default=4)
    p.add_argument("--scatterers", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--channel-model", default="scattering",
                   choices=["scattering", "fir", "cdl_nlos", "cdl_los"])
    p.add_argument("--cdl-delay-spread", type=float, default=100e-9,
                   help="CDL delay-spread scaling in seconds")


def _sim_cfg(args):
    from mamimo_tpu_torch.config import SimConfig

    return SimConfig(num_tx=args.num_tx, num_rx=args.num_rx,
                     n_scatterers=args.scatterers,
                     channel_model=args.channel_model,
                     cdl_delay_spread=args.cdl_delay_spread)


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--nn", type=int, nargs="+", default=[1024, 1024])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--no-bn", action="store_true")
    p.add_argument("--method", default="default_snr",
                   choices=["default", "default_snr"])
    p.add_argument("--val-train-ratio", type=float, default=0.15)
    p.add_argument("--val-same-train", action="store_true")
    p.add_argument("--in-fraction", type=int, default=1)
    p.add_argument("--decimate", default="none",
                   choices=["none", "max", "avg"])
    p.add_argument("--only-real", action="store_true")
    p.add_argument("--only-imag", action="store_true")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per .multi call")
    p.add_argument("--ckpt-backend", default="npz",
                   choices=["npz", "orbax"])


def _train_cfg(args):
    from mamimo_tpu_torch.config import TrainConfig

    dims = ("real", "imag")
    if args.only_real:
        dims = ("real",)
    elif args.only_imag:
        dims = ("imag",)
    return TrainConfig(
        hidden=tuple(args.nn), lr=args.lr, batch_size=args.bs,
        epochs=args.epochs, dropout=args.dropout, use_bn=not args.no_bn,
        method=args.method, val_train_ratio=args.val_train_ratio,
        val_same_train=args.val_same_train, in_fraction=args.in_fraction,
        decimate=args.decimate, seed=args.seed, dims=dims,
        steps_per_call=args.steps_per_call,
        ckpt_backend=args.ckpt_backend,
    )


def cmd_gen(args) -> None:
    from mamimo_tpu_torch.pipeline.dataset import generate_dataset

    cfg = _sim_cfg(args)
    ds = generate_dataset(
        cfg, seed=args.seed, num_packets=args.packets, snr_db=args.snr,
        with_mmse=args.mmse, noise_mode=args.noise_mode, chunk=args.chunk,
        interference_dbm=args.interference_dbm,
        mmse_estimator=args.mmse_estimator, mmse_n_iter=args.mmse_iters,
        fetch_dtype=args.fetch_dtype, device=args.device,
    )
    ds.save(args.out)
    print(f"[gen] wrote {args.out}: {ds.num_packets} packets @ "
          f"{args.snr} dB ({ds.num_samples} samples)")


def _train_mesh(dp: int, tp: int, device):
    """The ``data`` (× ``model``) mesh of ``train --dp/--tp``: the first
    dp·tp visible cards, or dp·tp ranks on ``device``; None for 1 × 1."""
    from mamimo_tpu_torch.models.predictor import resolve_device
    from mamimo_tpu_torch.parallel.mesh import make_mesh

    if dp <= 1 and tp <= 1:
        return None
    axes = {"data": dp}
    if tp > 1:
        axes["model"] = tp
    n = dp * tp
    if device is None:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(f"--dp {dp} --tp {tp} needs {n} cards, "
                               f"{count} visible; pass --device to put the "
                               f"ranks on one device")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = [resolve_device(device)] * n
    return make_mesh(axes, devices=devices)


def cmd_train(args) -> None:
    from mamimo_tpu_torch.pipeline.dataset import CSIDataset
    from mamimo_tpu_torch.train import fit

    mesh = _train_mesh(args.dp, args.tp, args.device)
    ds = CSIDataset.load(args.dataset)
    tcfg = _train_cfg(args)
    val_ds = CSIDataset.load(args.val) if args.val else None
    res = fit(ds.cfg, tcfg, ds, val_ds=val_ds, workdir=args.workdir,
              resume=args.resume, host_stream=args.host_stream,
              mesh=mesh, device=args.device)
    print(f"[train] done: {res.epochs_ran} epochs, "
          f"best val = {res.best_val.tolist()} -> {args.workdir}")


def cmd_test(args) -> None:
    from mamimo_tpu_torch.data.matlab_io import export_predictions_mat
    from mamimo_tpu_torch.eval.closed_loop import nmse_vs_snr
    from mamimo_tpu_torch.pipeline.dataset import CSIDataset
    from mamimo_tpu_torch.train.ckpt import load_checkpoint
    from mamimo_tpu_torch.train.loop import evaluate_dataset

    ds = CSIDataset.load(args.dataset)
    ck = load_checkpoint(os.path.join(args.modeldir, "best"))
    pred, mse = evaluate_dataset(
        ds.cfg, ck["tcfg"], ck["params"], ck["bn_state"], ds,
        drop_input=args.test_drop_input, drop_seed=args.seed,
        device=args.device)
    print(f"[test] per-plane MSE vs labels: {mse.tolist()}")
    nm = nmse_vs_snr(ds, pred, device=args.device)
    for k, v in nm.items():
        print(f"[test] {k} NMSE = {10 * np.log10(np.mean(v)):.2f} dB")
    os.makedirs(args.workdir, exist_ok=True)
    np.savez_compressed(os.path.join(args.workdir, "predictions.npz"),
                        pred=pred)
    if args.export_mat:
        export_predictions_mat(args.workdir, pred, ds.rx, ds.h_ls,
                               ds.pilot_matrix())
    if args.plots:
        from mamimo_tpu_torch.eval.plots import (
            plot_mimo_channel,
            plot_predictions,
        )

        plot_predictions(args.workdir, pred, ds.h_ls)
        plot_mimo_channel(os.path.join(args.workdir, "channel_dnn.png"),
                          pred[0])
        plot_mimo_channel(os.path.join(args.workdir, "channel_ls.png"),
                          ds.h_ls[0])
    if args.exec_time:
        # the DNN of every (tx, rx) pair of one packet, timed and traced
        # (the --execTime harness, massiveMIMO_CSI_prediction_DNN.py:
        # 441-475); on the card the fused factored DNN kernels
        import torch

        from mamimo_tpu_torch.models.predictor import CSIPredictor
        from mamimo_tpu_torch.utils.profiling import time_inference

        pr = CSIPredictor(args.modeldir, device=args.device or "cuda")
        planes = np.stack([ds.rx[:1].real, ds.rx[:1].imag]).transpose(
            0, 1, 3, 2)                               # (2, 1, R, L)
        x = torch.as_tensor(np.ascontiguousarray(planes, np.float32),
                            device=pr.device)
        stats = time_inference(
            pr.all_pairs_planes, (x,), iters=10,
            logdir=os.path.join(args.workdir, "logs_inf"), device=pr.device)
        n_est = ds.cfg.num_tx * ds.cfg.num_rx
        print(f"[test] inference: {stats['seconds_per_call']*1e3:.3f} ms "
              f"per packet ({n_est/stats['seconds_per_call']:.0f} "
              f"estimates/s, {stats['clock']}); trace in logs_inf/")
    with open(os.path.join(args.workdir, "test_report.json"), "w") as f:
        json.dump({k: float(np.mean(v)) for k, v in nm.items()}, f)


def _make_predictor(modeldir: str, device):
    """ds -> the DNN CSI of every packet of ds (``evaluate_dataset``) from
    the ``best`` checkpoint of modeldir."""
    from mamimo_tpu_torch.train.ckpt import load_checkpoint
    from mamimo_tpu_torch.train.loop import evaluate_dataset

    ck = load_checkpoint(os.path.join(modeldir, "best"))

    def predictor(ds):
        pred, _ = evaluate_dataset(ds.cfg, ck["tcfg"], ck["params"],
                                   ck["bn_state"], ds, device=device)
        return pred

    return predictor


def _user_models(args, cfg):
    """The per-user DNN source of a multi-user sweep: one ``best``
    checkpoint per user under <modeldir>/u0/, u1/, ..., each trained at
    the sweep's signal dimensions, all with one TrainConfig. Returns
    ([(params, bn_state)] per user, tcfg); SystemExit naming what is
    wrong."""
    from mamimo_tpu_torch.train.ckpt import load_checkpoint

    cks = []
    for u in range(args.num_users):
        udir = os.path.join(args.modeldir, f"u{u}", "best")
        if not os.path.exists(udir + ".json"):
            raise SystemExit(
                f"[sweep] --num-users={args.num_users} needs a per-user "
                f"checkpoint at {udir}.json (cli train on "
                "generate_dataset(user=u) corpora)")
        cks.append(load_checkpoint(udir))
    for u, c in enumerate(cks):
        mism = [f"{k}={getattr(c['cfg'], k)}!={getattr(cfg, k)}"
                for k in ("num_tx", "num_rx", "num_carriers")
                if getattr(c["cfg"], k) != getattr(cfg, k)]
        if mism:
            raise SystemExit(f"[sweep] u{u} checkpoint dims do not match "
                             f"the sweep config: {', '.join(mism)}")
        if c["tcfg"] != cks[0]["tcfg"]:
            raise SystemExit(f"[sweep] u{u} TrainConfig differs from u0's: "
                             "the per-user models must share one tcfg")
    return [(c["params"], c["bn_state"]) for c in cks], cks[0]["tcfg"]


def cmd_sweep(args) -> None:
    from mamimo_tpu_torch.eval.snr_sweep import (
        plot_sweep,
        run_mu_snr_sweep,
        run_snr_sweep,
    )

    cfg = _sim_cfg(args)
    if args.num_users > 1:
        # the multi-user closed loop: JSDM precoding, per-user decoding
        cfg = cfg.replace(num_users=args.num_users)
        if args.closed_loop:
            raise SystemExit("[sweep] --closed-loop is not supported with "
                             "--num-users>1 (the MU sweep IS the closed "
                             "loop)")
        models, tcfg, sources = None, None, ("ls", "lmmse", "perfect")
        if args.modeldir:
            models, tcfg = _user_models(args, cfg)
            sources = ("ls", "lmmse", "dnn", "perfect")
        res = run_mu_snr_sweep(cfg, snr_levels=args.snr,
                               num_packets=args.packets, seed=args.seed,
                               sources=sources, chunk=args.chunk or 8,
                               dnn_models=models, tcfg=tcfg,
                               device=args.device)
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "mu_sweep.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        print(f"[sweep] wrote {path}")
        return
    predictor = (_make_predictor(args.modeldir, args.device)
                 if args.modeldir else None)
    res = run_snr_sweep(cfg, snr_levels=args.snr, num_packets=args.packets,
                        seed=args.seed, predictor=predictor,
                        closed_loop=args.closed_loop,
                        max_cl_packets=args.cl_packets,
                        chunk=args.chunk or 16, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    res.save(os.path.join(args.out, "sweep.json"))
    plots = plot_sweep(res, args.out)
    print(f"[sweep] wrote {args.out}/sweep.json"
          + (" + plots" if plots else " (no matplotlib: no plots)"))


def cmd_pipeline(args) -> None:
    """The whole pipeline: train-set generation → train → per-SNR test
    sets → sweep (full_pipeline_maMIMO_DNNEst.sh)."""
    from mamimo_tpu_torch.eval.snr_sweep import plot_sweep, run_snr_sweep
    from mamimo_tpu_torch.pipeline.dataset import generate_dataset
    from mamimo_tpu_torch.train import fit

    cfg = _sim_cfg(args)
    tcfg = _train_cfg(args)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"[pipeline] generating {args.train_packets} train packets "
          f"(noiseless SNR=120)...")
    train_ds = generate_dataset(cfg, seed=args.seed,
                                num_packets=args.train_packets, snr_db=120.0,
                                chunk=args.chunk, device=args.device)
    print("[pipeline] training...")
    fit(cfg, tcfg, train_ds, workdir=args.workdir, device=args.device)
    # test on the training placement with fresh channel and noise seeds
    # (the reference's shared-scenario rng(67) contract)
    sweep = run_snr_sweep(
        cfg, snr_levels=args.snr, num_packets=args.packets,
        seed=args.seed + 1,
        predictor=_make_predictor(args.workdir, args.device),
        closed_loop=args.closed_loop, max_cl_packets=args.cl_packets,
        chunk=args.chunk, scenario=train_ds.scenario, device=args.device)
    outdir = os.path.join(args.workdir, "test_results")
    os.makedirs(outdir, exist_ok=True)
    sweep.save(os.path.join(outdir, "sweep.json"))
    plot_sweep(sweep, outdir)
    print(f"[pipeline] complete -> {outdir}")


def cmd_convert(args) -> None:
    from mamimo_tpu_torch.data.sources import get_datasource

    d = get_datasource(args.datasource)(args.input)
    if args.to == "pickle":
        from mamimo_tpu_torch.data.matlab_io import save_pickle_dataset

        save_pickle_dataset(d["rx"], d["h_ls"], d["P"], d["sim_params"],
                            args.out, seed=args.seed)
    else:
        np.savez_compressed(args.out, rx=d["rx"], h_ls=d["h_ls"],
                            P=d["P"],
                            sim_params=json.dumps(d["sim_params"]))
    print(f"[convert] {args.input} ({args.datasource}) -> {args.out}")


def cmd_bench(args) -> None:
    from mamimo_tpu_torch.bench import run_bench

    run_bench(batch_packets=args.batch, iters=args.iters,
              profile_dir=args.profile_dir, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mamimo_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate sounding dataset")
    _add_sim_args(g)
    g.add_argument("--packets", type=int, default=500)
    g.add_argument("--snr", type=float, default=120.0)
    g.add_argument("--mmse", action="store_true")
    g.add_argument("--noise-mode", default="snr",
                   choices=["snr", "sinr", "nf"])
    g.add_argument("--interference-dbm", type=float, default=-55.0,
                   help="'sinr'-mode interference power "
                        "(generate_maMIMO_LTF_SINR.m hard-codes -55)")
    g.add_argument("--mmse-estimator", default="cg",
                   choices=["cg", "direct", "dense", "eig"],
                   help="LMMSE form for --mmse: 'cg' (production, "
                        "fixed-trip-count) or the exact 'direct'/"
                        "'dense'/'eig' solves (e.g. for noiseless "
                        "label generation)")
    g.add_argument("--mmse-iters", type=int, default=16,
                   help="CG trip count (--mmse-estimator cg)")
    g.add_argument("--chunk", type=int, default=16)
    g.add_argument("--fetch-dtype", default="f32", choices=["f32", "bf16"],
                   help="bf16 halves the device->host corpus drain "
                        "bytes (-50 dB quantization, below any "
                        "operating noise floor; refused for noiseless "
                        "label generation)")
    g.add_argument("-o", "--out", required=True)
    _add_device_arg(g)
    g.set_defaults(fn=cmd_gen)

    t = sub.add_parser("train", help="train the CSI denoiser")
    t.add_argument("-x", "--dataset", required=True)
    t.add_argument("-y", "--val", default="")
    t.add_argument("-d", "--workdir", required=True)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--resume", action="store_true",
                   help="continue from <workdir>/last checkpoint")
    t.add_argument("--host-stream", action="store_true",
                   help="stream batches via the native C++ loader")
    t.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh size (ranks)")
    t.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (ranks)")
    _add_train_args(t)
    _add_device_arg(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("test", help="predict + export + NMSE report")
    e.add_argument("-x", "--dataset", required=True)
    e.add_argument("--modeldir", required=True)
    e.add_argument("-d", "--workdir", required=True)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--export-mat", action="store_true",
                   help="write reference-format prediction .mat files")
    e.add_argument("--test-drop-input", action="store_true")
    e.add_argument("--plots", action="store_true",
                   help="prediction-vs-truth PNGs + channel images")
    e.add_argument("--exec-time", action="store_true",
                   help="profiled inference timing (--execTime equiv)")
    _add_device_arg(e)
    e.set_defaults(fn=cmd_test)

    s = sub.add_parser("sweep", help="metrics vs SNR")
    _add_sim_args(s)
    s.add_argument("--snr", type=float, nargs="+",
                   default=[-25, -20, -15, -10, -5, 0, 5, 10])
    s.add_argument("--packets", type=int, default=500)
    s.add_argument("--modeldir", default="")
    s.add_argument("--closed-loop", action="store_true")
    s.add_argument("--cl-packets", type=int, default=50)
    s.add_argument("--chunk", type=int, default=None,
                   help="packets per compiled chunk (default 16; 8 for "
                        "--num-users>1 — the vmapped MU program is "
                        "~num_users x larger)")
    s.add_argument("--num-users", type=int, default=1,
                   help=">1 runs the multi-user JSDM closed-loop sweep")
    s.add_argument("-o", "--out", required=True)
    _add_device_arg(s)
    s.set_defaults(fn=cmd_sweep)

    pl = sub.add_parser("pipeline", help="gen -> train -> sweep")
    _add_sim_args(pl)
    _add_train_args(pl)
    pl.add_argument("--train-packets", type=int, default=3000)
    pl.add_argument("--packets", type=int, default=500,
                    help="test packets per SNR")
    pl.add_argument("--snr", type=float, nargs="+",
                    default=[-25, -20, -15, -10, -5, 0, 5, 10])
    pl.add_argument("--closed-loop", action="store_true")
    pl.add_argument("--cl-packets", type=int, default=50)
    pl.add_argument("--chunk", type=int, default=16)
    pl.add_argument("-d", "--workdir", required=True)
    _add_device_arg(pl)
    pl.set_defaults(fn=cmd_pipeline)

    c = sub.add_parser("convert", help="reference format interop")
    c.add_argument("-x", "--input", required=True)
    c.add_argument("--datasource", default="matlab_maMimo")
    c.add_argument("--to", default="npz", choices=["npz", "pickle"])
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("-o", "--out", required=True)
    c.set_defaults(fn=cmd_convert)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("--batch", type=int, default=64)
    b.add_argument("--iters", type=int, default=20)
    b.add_argument("--profile-dir", default="")
    _add_device_arg(b)
    b.set_defaults(fn=cmd_bench)

    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except NotImplementedError as e:
        raise SystemExit(f"[{args.cmd}] {e}") from e


if __name__ == "__main__":
    main()
