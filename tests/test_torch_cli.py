"""The port's command line (mamimo_tpu_torch.cli) on the CPU: the
gen → train → test(+export) → convert round trip of tests/test_cli.py
with --device cpu, the report against JAX's evaluation of the same
checkpoint, the pipeline and the sweeps (closed loop, multi-user) as
subprocesses at Nt 8 and hidden (64, 64), and the options that are not
ported yet, which exit naming their slice."""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mamimo_tpu_torch.cli import build_parser, main

COMMON = ["--num-tx", "4", "--num-rx", "2", "--scatterers", "8"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT8 = ["--num-tx", "8", "--num-rx", "2", "--scatterers", "16"]


def test_cli_pipeline_roundtrip(tmp_path):
    d = str(tmp_path)
    main(["gen", *COMMON, "--packets", "8", "--snr", "120", "--chunk", "4",
          "-o", f"{d}/train.npz", "--device", "cpu"])
    assert os.path.exists(f"{d}/train.npz")

    main(["train", "-x", f"{d}/train.npz", "-d", f"{d}/model", "--nn", "32",
          "32", "--bs", "16", "--epochs", "2", "--device", "cpu"])
    assert os.path.exists(f"{d}/model/best.json")

    main(["gen", *COMMON, "--packets", "4", "--snr", "0", "--mmse",
          "--chunk", "4", "-o", f"{d}/test.npz", "--device", "cpu"])
    main(["test", "-x", f"{d}/test.npz", "--modeldir", f"{d}/model", "-d",
          f"{d}/out", "--export-mat", "--device", "cpu"])
    assert os.path.exists(f"{d}/out/predictions.npz")
    assert os.path.exists(f"{d}/out/test_csi_predictions_real_1.mat")
    rep = json.loads((tmp_path / "out" / "test_report.json").read_text())
    assert set(rep) == {"ls", "lmmse", "dnn"}

    # the report is JAX's nmse_vs_snr of JAX's evaluation of the same
    # checkpoint on the same corpus
    from mamimo_tpu.eval.closed_loop import nmse_vs_snr
    from mamimo_tpu.pipeline.dataset import CSIDataset
    from mamimo_tpu.train.ckpt import load_checkpoint
    from mamimo_tpu.train.loop import evaluate_dataset

    ds = CSIDataset.load(f"{d}/test.npz")
    ck = load_checkpoint(f"{d}/model/best")
    pred, _ = evaluate_dataset(ds.cfg, ck["tcfg"], ck["params"],
                               ck["bn_state"], ds)
    got = np.load(f"{d}/out/predictions.npz")["pred"]
    assert np.abs(got - pred).max() <= 1e-5 * np.abs(pred).max()
    want = {k: float(np.mean(v)) for k, v in nmse_vs_snr(ds, pred).items()}
    for k in want:
        assert rep[k] == pytest.approx(want[k], rel=1e-4), k

    main(["convert", "-x", f"{d}/train.npz", "--datasource", "mamimo_npz",
          "--to", "pickle", "-o", f"{d}/ref.b"])
    main(["convert", "-x", f"{d}/ref.b", "--datasource", "matlab_maMimo",
          "--to", "npz", "-o", f"{d}/back.npz"])
    z1 = np.load(f"{d}/train.npz")
    z2 = np.load(f"{d}/back.npz")
    np.testing.assert_allclose(z1["rx"], z2["rx"], atol=1e-6)


@pytest.mark.parametrize("argv,slice_name", [
    pytest.param(["train", "-x", "none.npz", "-d", "x", "--dp", "2"],
                 "none.npz",
                 id="argv2-sharded-training slice"),
    pytest.param(["train", "-x", "none.npz", "-d", "x", "--tp", "2"],
                 "none.npz",
                 id="argv3-sharded-training slice")])
def test_cli_unported_commands_name_their_slice(argv, slice_name):
    """train --dp/--tp is ported now (tests/test_torch_sharded_train.py
    trains with it): the command builds its mesh of CPU ranks and goes on
    to read the dataset, which is missing here."""
    with pytest.raises(FileNotFoundError, match=slice_name):
        main(argv + ["--device", "cpu"])


def test_cli_defaults_to_the_card(tmp_path):
    """Every subcommand but convert takes --device, default the card: gen
    without a card raises."""
    ap = build_parser()
    for cmd in (["gen", "-o", "x"], ["train", "-x", "a", "-d", "b"],
                ["test", "-x", "a", "--modeldir", "m", "-d", "b"],
                ["bench"]):
        assert ap.parse_args(cmd).device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(["gen", *COMMON, "--packets", "1", "-o",
                  str(tmp_path / "x.npz")])


def _cli(*argv, timeout=600):
    """The port's CLI as a subprocess on the CPU; returns its stdout,
    failing with its output if it exits with an error."""
    r = subprocess.run([sys.executable, "-m", "mamimo_tpu_torch.cli", *argv,
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    """``pipeline``: 8 noiseless training packets, 2 epochs of a (64, 64)
    model, then the closed-loop sweep at 10 dB on 2 test packets."""
    wd = str(tmp_path_factory.mktemp("pipeline"))
    out = _cli("pipeline", *NT8, "--nn", "64", "64", "--bs", "16",
               "--epochs", "2", "--train-packets", "8", "--packets", "2",
               "--snr", "10", "--closed-loop", "--cl-packets", "2",
               "--chunk", "4", "-d", wd)
    assert "[pipeline] complete" in out
    return wd


def _finite_series(metric, sources):
    for s in sources:
        assert metric[s] and all(np.isfinite(v) for v in metric[s]), s


def test_cli_pipeline_runs_the_closed_loop(pipeline_dir):
    res = json.loads(open(os.path.join(pipeline_dir, "test_results",
                                       "sweep.json")).read())
    assert res["snr_levels"] == [10.0]
    _finite_series(res["nmse"], ("ls", "lmmse", "dnn"))
    _finite_series(res["ber"], ("ls", "lmmse", "dnn", "perfect"))
    _finite_series(res["bf_gain"], ("ls", "perfect"))
    assert os.path.exists(os.path.join(pipeline_dir, "best.json"))


def test_cli_sweep_closed_loop(pipeline_dir, tmp_path):
    """``sweep --closed-loop`` with the pipeline's model as the DNN
    source, two SNR levels."""
    _cli("sweep", *NT8, "--snr", "0", "10", "--packets", "2",
         "--closed-loop", "--cl-packets", "2", "--modeldir", pipeline_dir,
         "--chunk", "2", "-o", str(tmp_path))
    res = json.loads((tmp_path / "sweep.json").read_text())
    assert res["snr_levels"] == [0.0, 10.0]
    _finite_series(res["ber"], ("ls", "lmmse", "dnn", "perfect"))
    _finite_series(res["evm"], ("ls", "lmmse", "dnn", "perfect"))
    assert res["nmse"]["ls"][0] > res["nmse"]["ls"][1]


def test_cli_sweep_multi_user(pipeline_dir, tmp_path):
    """``sweep --num-users 2``: without models (ls, lmmse, perfect), then
    with one checkpoint per user (the pipeline's, for both users) as the
    DNN source; the per-user checkpoint checks exit naming the fault."""
    _cli("sweep", *NT8, "--num-users", "2", "--snr", "10", "--packets", "2",
         "-o", str(tmp_path / "plain"))
    res = json.loads((tmp_path / "plain" / "mu_sweep.json").read_text())
    assert res["num_users"] == 2
    assert set(res["sources"]) == {"ls", "lmmse", "perfect"}
    for d in res["sources"].values():
        assert len(d["ber"]) == 1 and len(d["ber"][0]) == 2
        assert all(np.isfinite(v) for v in d["ber"][0] + d["evm"][0])

    models = tmp_path / "models"
    for u in range(2):
        (models / f"u{u}").mkdir(parents=True)
        for f in glob.glob(os.path.join(pipeline_dir, "best*")):
            shutil.copy(f, models / f"u{u}")
    _cli("sweep", *NT8, "--num-users", "2", "--snr", "10", "--packets", "2",
         "--modeldir", str(models), "-o", str(tmp_path / "dnn"))
    res = json.loads((tmp_path / "dnn" / "mu_sweep.json").read_text())
    assert set(res["sources"]) == {"ls", "lmmse", "dnn", "perfect"}
    assert all(np.isfinite(v) for v in res["sources"]["dnn"]["ber"][0])

    with pytest.raises(SystemExit, match="needs a per-user checkpoint"):
        main(["sweep", *NT8, "--num-users", "3", "--modeldir", str(models),
              "-o", str(tmp_path / "x"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="IS the closed loop"):
        main(["sweep", *NT8, "--num-users", "2", "--closed-loop", "-o",
              str(tmp_path / "x"), "--device", "cpu"])
