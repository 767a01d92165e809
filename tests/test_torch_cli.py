"""The port's command line (mamimo_tpu_torch.cli) on the CPU: the
gen → train → test(+export) → convert round trip of tests/test_cli.py
with --device cpu, the report against JAX's evaluation of the same
checkpoint, and the subcommands that are not ported yet, which exit
naming their slice."""

import json
import os

import numpy as np
import pytest
import torch

from mamimo_tpu_torch.cli import build_parser, main

COMMON = ["--num-tx", "4", "--num-rx", "2", "--scatterers", "8"]


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
    (["sweep", "-o", "x"], "closed-loop slice"),
    (["pipeline", "-d", "x"], "closed-loop slice"),
    (["train", "-x", "none.npz", "-d", "x", "--dp", "2"],
     "sharded-training slice"),
    (["train", "-x", "none.npz", "-d", "x", "--tp", "2"],
     "sharded-training slice")])
def test_cli_unported_commands_name_their_slice(argv, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
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
