"""The port's checkpoints and serving call against the JAX package
(mamimo_tpu_torch.train.ckpt / models.predictor), plus the guards that
keep the port free of JAX and of silent CPU fallbacks.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models.mlp import init_stacked as j_init
from mamimo_tpu.models.predictor import CSIPredictor as JPredictor
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.models.predictor import CSIPredictor, full_f32_matmul
from mamimo_tpu_torch.train import ckpt

REPO = Path(__file__).resolve().parents[1]
CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)


def _tcfgs(use_bn):
    return (TrainConfig(hidden=(128, 128), use_bn=use_bn),
            JTrainConfig(hidden=(128, 128), use_bn=use_bn))


def _jax_model(use_bn, seed):
    """JAX parameters with a non-trivial BN state."""
    _, jtcfg = _tcfgs(use_bn)
    jp, jb = jax.tree.map(np.asarray,
                          j_init(jax.random.PRNGKey(seed), JCFG, jtcfg))
    rng = np.random.default_rng(seed)
    jb = {"mean": [rng.normal(0, 0.1, m.shape).astype(np.float32)
                   for m in jb["mean"]],
          "var": [rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                  for v in jb["var"]]}
    return jp, jb


def _assert_trees_equal(a, b):
    la = mlp.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("use_bn", [True, False])
def test_checkpoint_jax_to_port(tmp_path, use_bn):
    tcfg, jtcfg = _tcfgs(use_bn)
    jp, jb = _jax_model(use_bn, seed=1)
    prefix = str(tmp_path / "best")
    jckpt.save_checkpoint(prefix, JCFG, jtcfg, jp, jb)
    ck = ckpt.load_checkpoint(prefix)
    assert ck["cfg"] == CFG and ck["tcfg"] == tcfg
    _assert_trees_equal({"params": ck["params"], "bn_state": ck["bn_state"]},
                        {"params": jp, "bn_state": jb})


@pytest.mark.parametrize("use_bn", [True, False])
def test_checkpoint_port_to_jax(tmp_path, use_bn):
    tcfg, jtcfg = _tcfgs(use_bn)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(2), CFG, tcfg)
    prefix = str(tmp_path / "best")
    ckpt.save_checkpoint(prefix, CFG, tcfg, tp, tb)
    ck = jckpt.load_checkpoint(prefix)
    assert ck["cfg"] == JCFG and ck["tcfg"] == jtcfg
    _assert_trees_equal({"params": tp, "bn_state": tb},
                        {"params": ck["params"], "bn_state": ck["bn_state"]})
    # the leaf order is jax tree_flatten order
    with np.load(prefix + ".npz") as z:
        shapes = [z[f"leaf_{i}"].shape for i in range(len(z.files) - 1)]
    want = [l.shape for l in jax.tree_util.tree_leaves(
        {"params": ck["params"], "bn_state": ck["bn_state"]})]
    assert shapes == want


def test_orbax_checkpoint_raises(tmp_path):
    prefix = str(tmp_path / "best")
    tcfg, _ = _tcfgs(True)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(3), CFG, tcfg)
    with pytest.raises(ValueError, match="not ported"):
        ckpt.save_checkpoint(prefix, CFG, tcfg, tp, tb, backend="orbax")
    ckpt.save_checkpoint(prefix, CFG, tcfg, tp, tb)
    os.remove(prefix + ".npz")
    os.makedirs(prefix + ".orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.load_checkpoint(prefix)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One JAX-written checkpoint served by both packages on the CPU."""
    d = tmp_path_factory.mktemp("model")
    _, jtcfg = _tcfgs(True)
    jp, jb = _jax_model(True, seed=4)
    jckpt.save_checkpoint(str(d / "best"), JCFG, jtcfg, jp, jb)
    return JPredictor(str(d)), CSIPredictor(str(d), device="cpu")


def test_estimate_full_matches_jax(served):
    jpred, pred = served
    flat = np.random.default_rng(5).standard_normal(
        (2, 6, CFG.len_ltf)).astype(np.float32)
    ref_ls, ref_dnn = jpred.estimate_full(flat)
    h_ls, h_dnn = pred.estimate_full(flat)
    for got, ref in ((h_ls, ref_ls), (h_dnn, ref_dnn)):
        assert got.shape == (6, CFG.num_tx, CFG.num_carriers)
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_all_pairs_and_inference_match_jax(served):
    jpred, pred = served
    rng = np.random.default_rng(6)
    planes = rng.standard_normal((2, 3, CFG.num_rx, CFG.len_ltf)
                                 ).astype(np.float32)
    ref = jpred.all_pairs(planes)
    got = pred.all_pairs(planes)
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())

    sig = (rng.standard_normal((4, CFG.len_ltf))
           + 1j * rng.standard_normal((4, CFG.len_ltf))).astype(np.complex64)
    pilot = np.eye(CFG.num_tx, dtype=np.float32)[:4]
    ref = jpred.inference(sig, pilot)
    got = pred.inference(sig, pilot)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_rice_renew_processing_matches_jax(served):
    jpred, pred = served
    out = (np.arange(3 * 52) + 1j).reshape(3, 52).astype(np.complex64)
    for p in (jpred, pred):
        p.experiment = "RICE_RENEW"
    try:
        np.testing.assert_array_equal(pred.postprocess_data(out),
                                      jpred.postprocess_data(out))
        with pytest.raises(TypeError):
            pred.preprocess_data(out)
        with pytest.raises(ValueError):
            pred.postprocess_data(out[:, :50])
    finally:
        for p in (jpred, pred):
            p.experiment = "matlab_maMimo"


def test_cuda_without_gpu_raises(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        CSIPredictor(served[1].path, device="cuda")


def test_full_f32_matmul_restores_caller_settings():
    """The predictor turns TF32 off only around its float32 products: the
    caller's settings come back after, also when the body raises."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(ValueError):
            with full_f32_matmul():
                assert [f.allow_tf32 for f in flags] == [False, False]
                raise ValueError
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_port_imports_without_jax():
    """The port imports with jax blocked, and no source of it names jax
    or the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import mamimo_tpu_torch, mamimo_tpu_torch.models.predictor, "
            "mamimo_tpu_torch.models.quant, mamimo_tpu_torch.bench, "
            "mamimo_tpu_torch.entry, "
            "mamimo_tpu_torch.ops.kernels, mamimo_tpu_torch.train, "
            "mamimo_tpu_torch.train.loop, "
            "mamimo_tpu_torch.ops.kernels.mlp_infer, "
            "mamimo_tpu_torch.ops.kernels.fused_ls, "
            "mamimo_tpu_torch.ops.estimate, mamimo_tpu_torch.models.mlp, "
            "mamimo_tpu_torch.utils.numerics, "
            "mamimo_tpu_torch.channel.scattering, "
            "mamimo_tpu_torch.pipeline.sounding, "
            "mamimo_tpu_torch.pipeline.dataset, mamimo_tpu_torch.ops.ofdm, "
            "mamimo_tpu_torch.channel.noise, mamimo_tpu_torch.channel.cdl, "
            "mamimo_tpu_torch.parallel.mesh, mamimo_tpu_torch.parallel.halo, "
            "mamimo_tpu_torch.parallel.rdma_halo, "
            "mamimo_tpu_torch.parallel.sharded; "
            "bad = [m for m in sys.modules if m == 'mamimo_tpu' "
            "or m.startswith('mamimo_tpu.')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    sources = list((REPO / "mamimo_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    for src in sources:
        text = src.read_text()
        for bad in ("import jax", "from jax", "mamimo_tpu.",
                    "import mamimo_tpu\n", "from mamimo_tpu import"):
            assert bad not in text, f"{src}: {bad!r}"
