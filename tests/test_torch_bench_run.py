"""The port's one-line bench (mamimo_tpu_torch.bench::run_bench and
``python3 -m mamimo_tpu_torch.bench``) on the CPU, at a tiny size
(BENCH_NT=8, BENCH_NR=2, 2 packets, one call a window): the line's keys,
every path timed, the CPU yardstick cached under the given root, and the
module's refusals without a CUDA device. The times of a CPU run are host
times and say nothing of the card.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mamimo_tpu_torch import bench
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import init_stacked

REPO = Path(__file__).resolve().parents[1]
PATH_NAMES = ("xla_planes", "xla_planes_bf16", "xla_planes_bf16_bf16ls",
              "xla_planes_bf16in", "xla_timemajor_bf16", "ls_planes",
              "ls_fft", "ls_matmul", "pallas_factored", "pallas_full", "ls_pallas",
              "pallas_ls_bf16in", "pallas_ls_serving_bf16in",
              "int8_dnn_bf16in", "pallas_ls_int8_bf16in",
              "pallas_ls_v2_serving_r3")
EXTRA_KEYS = {"device", "batch_packets", "best_path", "precision",
              "estimates_per_s", "baseline_cpu_estimates_per_s",
              "full_batch_ms", "achieved_tflops_dnn_path",
              "achieved_tflops_incl_ls"}


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    """One run_bench on the CPU: (printed stdout, returned dict, root)."""
    root = tmp_path_factory.mktemp("bench_root")
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_NT", "8")
    mp.setenv("BENCH_NR", "2")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = bench.run_bench(batch_packets=2, iters=1, device="cpu",
                                  repo_root=str(root),
                                  profile_dir=str(root / "trace"))
    finally:
        mp.undo()
    return out.getvalue(), res, root


def test_run_bench_prints_one_line(line):
    text, res, _ = line
    lines = text.strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert parsed == json.loads(json.dumps(res))
    assert parsed["metric"] == "channel_estimates_per_s_per_chip"
    assert parsed["unit"] == "estimates/s"
    assert set(parsed) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(parsed["extra"]) == EXTRA_KEYS
    for gone in ("dispatch_floor_ms", "steady_state_unroll",
                 "per_dispatch_estimates_per_s"):
        assert gone not in parsed["extra"]


def test_run_bench_times_every_path(line):
    _, res, _ = line
    extra = res["extra"]
    assert tuple(extra["estimates_per_s"]) == PATH_NAMES
    assert all(v > 0 for v in extra["estimates_per_s"].values())
    assert extra["best_path"] in bench.FULL_PATHS
    assert extra["best_path"] in extra["estimates_per_s"]
    n_est = 2 * 8 * 2
    assert res["value"] == pytest.approx(
        extra["estimates_per_s"][extra["best_path"]])
    assert extra["full_batch_ms"] == pytest.approx(n_est / res["value"] * 1e3)
    assert res["vs_baseline"] == pytest.approx(
        res["value"] / extra["baseline_cpu_estimates_per_s"])
    assert extra["device"] == "cpu" and extra["batch_packets"] == 2
    assert extra["precision"] in ("f32", "bf16", "int8")


def test_run_bench_caches_the_yardstick_under_the_root(line):
    _, res, root = line
    cache = Path(root) / "mamimo_tpu_torch" / "_build" / \
        ".bench_baseline_8x2.json"
    assert cache.is_file()
    got = json.loads(cache.read_text())["cpu_estimates_per_s"]
    assert got == res["extra"]["baseline_cpu_estimates_per_s"] > 0


def test_run_bench_writes_a_trace(line):
    """profile_dir: a torch.profiler Chrome trace of the timed calls."""
    _, _, root = line
    trace = json.loads((Path(root) / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_bench_paths_are_the_jax_benchs():
    """bench_paths: the 16 paths in the JAX bench's order, the full paths
    among them, and the input dtype each takes."""
    cfg, tcfg = SimConfig(num_tx=8, num_rx=2), TrainConfig(hidden=(32, 32))
    params, bn = init_stacked(torch.Generator().manual_seed(1), cfg, tcfg)
    paths = bench.bench_paths(cfg, tcfg, params, bn)
    assert tuple(paths) == PATH_NAMES
    assert set(bench.FULL_PATHS) <= set(paths)
    bf16_in = {n for n, (_, bf16) in paths.items() if bf16}
    assert bf16_in == {"xla_planes_bf16in", "pallas_ls_v2_serving_r3",
                       *bench.PATHS}


def test_time_fn_windows():
    """One warm-up call, then 5 windows of iters calls; the result is a
    time per call."""
    calls = []
    arg = torch.zeros(3)
    t = bench._time_fn(lambda a: calls.append(a), arg, iters=4)
    assert len(calls) == 1 + 5 * 4 and t >= 0.0


def test_get_baseline_reads_its_cache(tmp_path, monkeypatch):
    cfg = SimConfig(num_tx=8, num_rx=2)
    cache = tmp_path / "sub" / "b.json"
    monkeypatch.setattr(bench, "_torch_cpu_baseline",
                        lambda cfg, batch: 123.0)
    assert bench._get_baseline(cfg, str(cache)) == 123.0

    def fail(cfg, batch):
        raise AssertionError("measured again")

    monkeypatch.setattr(bench, "_torch_cpu_baseline", fail)
    assert bench._get_baseline(cfg, str(cache)) == 123.0


def test_get_baseline_failure_raises(tmp_path, monkeypatch):
    """A failed measurement raises and caches nothing (no 1.0)."""
    def fail(cfg, batch):
        raise RuntimeError("no measurement")

    monkeypatch.setattr(bench, "_torch_cpu_baseline", fail)
    cache = tmp_path / "b.json"
    with pytest.raises(RuntimeError, match="no measurement"):
        bench._get_baseline(SimConfig(num_tx=8, num_rx=2), str(cache))
    assert not cache.exists()


def test_run_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.run_bench(batch_packets=1, iters=1, print_result=False)


@pytest.mark.parametrize("args", [[], ["--train"], ["--gen"]],
                         ids=["bench", "train", "gen"])
def test_bench_module_exits_nonzero_without_cuda(args):
    """python3 -m mamimo_tpu_torch.bench prints no line and exits
    non-zero without a CUDA device, --train and --gen (ported)
    included."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "mamimo_tpu_torch.bench",
                        *args], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr
