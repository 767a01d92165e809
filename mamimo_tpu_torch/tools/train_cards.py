#!/usr/bin/env python3
"""The DP+TP training step with its ranks on different cards.

    python3 mamimo_tpu_torch/tools/train_cards.py

Needs two or more CUDA cards and uses every visible one (n, 4 on a
four-card machine). ``chip_smoke.py`` runs the sharded step on virtual
ranks of one card; this script drives what only several cards exercise,
at BS32 (Nt 32, hidden 1024 x 1024, batch 1024, f32, the default
configuration's AWGN and dropout, the batch gathered on each rank from a
seeded 64-packet dataset copied to every card):

1. one process over the n cards, on ``data n`` and on ``data n/2 x
   model 2``: the sums cross the cards as ``.to`` copies;
2. n processes, one card each, joined by ``parallel.multihost.init``
   over NCCL (tcp://localhost), on the same two meshes: the sums cross
   the processes through the group (``collectives.exchange``).

For each mesh: the ms/step on the host clock (the median of 5 batches of
5 steps, every card synchronized), each card's device-busy time in a
``torch.profiler`` trace of one step (and its NCCL kernels' time); after
the timed steps the replicated state must be bit-identical (every rank
holding a piece holds the same bits as every other rank holding it,
across cards and processes); and one step of the no-draw configuration
(method 'default', dropout 0) is held to the single-card step on the
same model and batch (the loss and BN statistics to 1e-5 relative, the
Adam moments worst leaf below -35 dB). Prints one JSON line last; any
failure ends the run with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
PACKETS = 64
BATCH = 1024
BATCHES, STEPS = 5, 5
LIMITS = {"loss": 1e-5, "bn": 1e-5, "moments_db": -35.0}


def _meshes(n: int) -> list:
    return [{"data": n}, {"data": n // 2, "model": 2}]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _sync(devs):
    import torch

    for d in devs:
        torch.cuda.synchronize(d)


def _trace(fn, devs, calls: int = 3) -> dict:
    """{card index: {"busy_ms", "nccl_ms"}} per call of fn() from a
    torch.profiler trace of ``calls`` calls, synchronizing only ``devs``
    (a worker touches no other process's card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(devs)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        _sync(devs)
    cards = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        c = cards.setdefault(str(e.device_index),
                             {"busy_ms": 0.0, "nccl_ms": 0.0})
        ms = e.time_range.elapsed_us() / 1e3 / calls
        c["busy_ms"] += ms
        if "nccl" in e.name.lower():
            c["nccl_ms"] += ms
    if not cards:
        raise RuntimeError("the profiler's trace holds no device time")
    return cards


def _nmse_db(a, b) -> float:
    a, b = (np.asarray(t.detach().float().cpu().numpy(), np.float64)
            for t in (a, b))
    err = np.sum((a - b) ** 2)
    return -np.inf if err == 0 else float(10 * np.log10(err / np.sum(b * b)))


def _rel(a, b) -> float:
    a, b = (t.detach().double().cpu() for t in (a, b))
    return float((a - b).abs().max() / b.abs().max())


def _digest(t) -> str:
    import torch

    t = t.detach().cpu().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _pieces(tree) -> dict:
    """{(leaf index, piece key): {rank: digest}} of this process's ranks."""
    from mamimo_tpu_torch.models.mlp import tree_leaves

    out = {}
    for k, leaf in enumerate(tree_leaves(tree)):
        for r, t in leaf.local():
            key = f"{k}:" + ",".join(f"{b.start}-{b.stop}"
                                     for b in leaf.block(r))
            out.setdefault(key, {})[r] = _digest(t)
    return out


def _step_vs_single(cfg, mesh, data, rep, idx, dev) -> dict:
    """One no-draw step (method 'default', dropout 0) on the mesh against
    the single-card step on ``dev``, same model and batch."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.models.mlp import init_stacked, tree_leaves
    from mamimo_tpu_torch.parallel.sharded import (
        gather_tree,
        make_sharded_train_step,
        place_state,
    )
    from mamimo_tpu_torch.train.loop import (
        _gather_batch,
        make_batch_update,
        make_optimizer,
    )

    tc = TrainConfig(method="default", dropout=0.0, batch_size=BATCH)
    opt = make_optimizer(tc)
    hp, hb = init_stacked(torch.Generator().manual_seed(1), cfg, tc)
    state = place_state(mesh, hp, hb, opt.init(hp))
    _, sh = make_sharded_train_step(cfg, tc, mesh, avg_sig_pow=1.0)
    sp, sb, ss, sloss = sh.gather(*state, rep, idx, None, tc.lr)
    gb, gs = gather_tree(sb), gather_tree(ss)
    params, bn = init_stacked(torch.Generator().manual_seed(1), cfg, tc,
                              device=dev)
    update, _ = make_batch_update(cfg, tc, 1.0, opt)
    x2, pilot, y2 = _gather_batch(cfg, data, idx.to(dev))
    _, bn1, st1, loss1 = update(params, bn, opt.init(params), x2, pilot, y2,
                                None, tc.lr)
    got = {"loss": _rel(sloss, loss1),
           "bn": max(_rel(a, b) for a, b in zip(tree_leaves(gb),
                                                tree_leaves(bn1))),
           "moments_db": max(_nmse_db(a, b) for a, b in zip(
               tree_leaves(gs.mu) + tree_leaves(gs.nu),
               tree_leaves(st1.mu) + tree_leaves(st1.nu)))}
    bad = {k: v for k, v in got.items() if not v <= LIMITS[k]}
    if bad:
        raise AssertionError(f"sharded step {mesh.shape} vs the single card: "
                             f"{bad} (limits {LIMITS})")
    return got


def run_mesh(cfg, mesh, data, dev) -> dict:
    """Time one mesh's step, trace it, check its replicas and hold it to
    the single card; the process's part of the result."""
    import torch

    from mamimo_tpu_torch.bench import train_variant_config
    from mamimo_tpu_torch.parallel.sharded import (
        make_sharded_train_step,
        replicate,
    )

    tc = train_variant_config("f32", BATCH, 1)
    rep = replicate(mesh, data)
    n_samples = PACKETS * cfg.num_tx * cfg.num_rx
    idx = torch.as_tensor(np.random.default_rng(3).integers(
        0, n_samples, BATCH), device=dev)
    init_fn, sh = make_sharded_train_step(cfg, tc, mesh, avg_sig_pow=1.0)
    state = list(init_fn(torch.Generator().manual_seed(0)))
    gen = torch.Generator(device=dev).manual_seed(2)

    def one():
        state[:] = sh.gather(*state, rep, idx, gen, tc.lr)[:3]

    devs = sorted({mesh.rank_device(r) for r in mesh.local_ranks},
                  key=str)
    for _ in range(2):
        one()
    per = []
    for _ in range(BATCHES):
        _sync(devs)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            one()
        _sync(devs)
        per.append((time.perf_counter() - t0) / STEPS * 1e3)
    cards = _trace(one, devs)
    pieces = _pieces(state[0])
    pieces.update({f"bn.{k}": v for k, v in _pieces(state[1]).items()})
    check = _step_vs_single(cfg, mesh, data, rep, idx, dev)
    return {"ms_per_step": float(np.median(per)), "ms_batches": per,
            "cards": cards, "pieces": pieces, "vs_single": check}


def _identical(pieces_by_proc: list) -> tuple:
    """(True if every piece's copies agree, the number of pieces compared
    that have more than one copy)."""
    merged = {}
    for pieces in pieces_by_proc:
        for key, ranks in pieces.items():
            merged.setdefault(key, {}).update(ranks)
    shared = [v for v in merged.values() if len(v) > 1]
    return all(len(set(v.values())) == 1 for v in shared), len(shared)


def _setup(dev):
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mamimo_tpu_torch.bench import train_bench_data
    from mamimo_tpu_torch.config import SimConfig

    cfg = SimConfig()
    return cfg, train_bench_data(cfg, PACKETS, dev)


def worker(i: int, n: int, port: int) -> int:
    """One of n processes: card i, joined over NCCL; prints its result as
    a JSON line."""
    import torch

    torch.cuda.set_device(i)
    dev = torch.device("cuda", i)
    cfg, data = _setup(dev)
    from mamimo_tpu_torch.parallel import multihost
    from mamimo_tpu_torch.parallel.mesh import make_mesh

    multihost.init(f"localhost:{port}", n, i, backend="nccl")
    out = {}
    for axes in _meshes(n):
        mesh = make_mesh(axes)
        out[json.dumps(axes)] = run_mesh(cfg, mesh, data, dev)
    multihost.shutdown()
    print("TRAIN_CARDS_WORKER " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("train_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    if args.worker is not None:
        return worker(args.worker, args.n, args.port)
    n = torch.cuda.device_count()
    smi = _smi()
    names = {torch.cuda.get_device_name(i) for i in range(n)}
    print(f"[train_cards] {n} cards: {sorted(names)}; {smi}")
    dev = torch.device("cuda", 0)
    cfg, data = _setup(dev)
    from mamimo_tpu_torch.parallel.mesh import make_mesh

    result = {"cards": n, "card": smi, "one_process": {},
              "processes": {}}
    for axes in _meshes(n):
        mesh = make_mesh(axes, devices=[f"cuda:{c}" for c in range(n)])
        r = run_mesh(cfg, mesh, data, dev)
        same, shared = _identical([r.pop("pieces")])
        busy = {c: round(v["busy_ms"], 4) for c, v in r["cards"].items()}
        print(f"  one process, {axes}: {r['ms_per_step']:.4f} ms/step host "
              f"(batches {[round(x, 3) for x in r['ms_batches']]}); busy ms "
              f"per card {busy}; replicas bit-identical: {same} ({shared} "
              f"pieces held by more than one rank); vs the single card "
              f"{r['vs_single']}  [{smi}]")
        if not same:
            raise AssertionError(f"one process {axes}: replicas differ")
        result["one_process"][json.dumps(axes)] = {**r, "identical": same}

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker", str(i),
         "--n", str(n), "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=420)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    per_proc = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("TRAIN_CARDS_WORKER ")]
        if p.returncode != 0 or len(lines) != 1:
            print(out[-4000:], file=sys.stderr)
            raise AssertionError(f"worker {i} exited {p.returncode}")
        per_proc.append(json.loads(lines[0].split(" ", 1)[1]))
    for key in per_proc[0]:
        rs = [w[key] for w in per_proc]
        same, shared = _identical([r.pop("pieces") for r in rs])
        ms = [r["ms_per_step"] for r in rs]
        busy = {i: {c: round(v["busy_ms"], 4) for c, v in r["cards"].items()}
                for i, r in enumerate(rs)}
        nccl = {i: {c: round(v["nccl_ms"], 4) for c, v in r["cards"].items()}
                for i, r in enumerate(rs)}
        print(f"  {n} processes (NCCL), {key}: ms/step host per process "
              f"{[round(x, 4) for x in ms]}; busy ms per card {busy}, of "
              f"it NCCL kernels {nccl}; replicas bit-identical across the "
              f"processes: {same} ({shared} pieces held by more than one "
              f"rank); vs the single card {rs[0]['vs_single']}  [{smi}]")
        if not same:
            raise AssertionError(f"{n} processes {key}: replicas differ")
        result["processes"][key] = {"per_process": rs, "identical": same,
                                    "ms_per_step": max(ms)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
