"""The port's int8 GEMM and int8 quantized DNN against the JAX package
(mamimo_tpu_torch.ops.kernels.int8_mm / models.quant / the int8 path of
models.predictor).

Weights come from the JAX init_stacked (with a non-trivial BN state),
move to the port through params_from_jax, and inputs are made with
numpy; both packages then run the same arrays. The CUDA GEMM kernel
(csrc/int8_mm.cu) runs only on the card, where chip_smoke.py holds it to
the exact plain version tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.models import quant as jquant
from mamimo_tpu.models.predictor import CSIPredictor as JPredictor
from mamimo_tpu.ops.pallas.int8_mm import matmul_pallas as j_matmul_pallas
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp, quant
from mamimo_tpu_torch.models.predictor import CSIPredictor
from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_int8, matmul_pallas

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
L = CFG.len_ltf


def nmse_db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                         / np.sum(np.abs(ref) ** 2))


def _models(use_bn, seed):
    """JAX parameters (numpy leaves) with non-trivial biases and BN
    state, and the port's copy of them."""
    tcfg = TrainConfig(hidden=(128, 128), use_bn=use_bn)
    jtcfg = JTrainConfig(hidden=(128, 128), use_bn=use_bn)
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), JCFG, jtcfg))
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)               # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    tp, tb = mlp.params_from_jax(jp, jb)
    return (tcfg, tp, tb), (jtcfg, jp, jb)


@pytest.fixture(scope="module")
def bn_model():
    return _models(True, seed=0)


def _flat(s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, L)).astype(np.float32)


# ----------------------------------------------------------------------
# the int8 GEMM
# ----------------------------------------------------------------------

def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def test_matmul_matches_jax_exactly():
    """Ragged M (100 rows, 32-row blocks on the JAX side), N = 40: the
    plain version equals the JAX kernel in interpret mode exactly, in
    both the (K, N) and the transposed (N, K) form."""
    rng = np.random.default_rng(0)
    a, b = _int8(rng, (100, 256)), _int8(rng, (256, 40))
    ref = np.asarray(j_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                     block_m=32))
    assert ref.dtype == np.int32
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = matmul_pallas(ta, tb)
    assert got.dtype == torch.int32 and tuple(got.shape) == (100, 40)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(matmul_int8(ta, tb.T.contiguous()).numpy(),
                                  ref)


@pytest.mark.parametrize("sign", ["all_plus", "mixed"])
def test_matmul_no_int8_wrap(sign):
    """K = 2048 with every entry ±127: sums up to 2048·127² need int32;
    anything that accumulates in int8 (torch.matmul of two int8 CPU
    tensors does) fails here."""
    rng = np.random.default_rng(1)
    shape_a, shape_b = (24, 2048), (2048, 16)
    if sign == "all_plus":
        a, b = np.full(shape_a, 127, np.int8), np.full(shape_b, 127, np.int8)
    else:
        a = (127 * rng.choice([-1, 1], shape_a)).astype(np.int8)
        b = (127 * rng.choice([-1, 1], shape_b)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = matmul_pallas(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matmul_other_dtypes_raise(dtype):
    """The int8 GEMM raises for bf16 and f32 operands, on the CPU too;
    matmul_pallas takes them (its bf16 and f32 modes, a float32 result;
    tests/test_torch_f32_modes.py holds them to JAX's kernel)."""
    a, b = torch.ones((4, 32), dtype=dtype), torch.ones((32, 8), dtype=dtype)
    with pytest.raises(TypeError, match="int8"):
        matmul_int8(a, b.T)
    got = matmul_pallas(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.full((4, 8), 32.0))


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------

def test_quant_rows_codes_equal_jax():
    """Per-row codes and scales of rows whose scales span 0.01 … 100
    equal JAX's bit for bit (both round half to even)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((256, 1024))
         * np.logspace(-2, 2, 256)[:, None]).astype(np.float32)
    jq, js = jquant._quant_rows(jnp.asarray(x))
    q, s = quant._quant_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _assert_qtrees_match(tq, jq):
    """int8 leaves equal exactly; float leaves within rtol 1e-6."""
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = mlp.tree_leaves(tq)
    assert len(tl) == len(jl)
    for t, (path, j) in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        if j.dtype == np.int8:
            assert t.dtype == torch.int8, path
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0,
                                       err_msg=str(path))


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("split", [True, False])
def test_quantize_params_equal_jax(use_bn, split):
    """The folded int8 tree equals JAX's leaf for leaf, with and without
    the sig_len split of W1 and with and without BN."""
    (tcfg, tp, tb), (jtcfg, jp, jb) = _models(use_bn, seed=3)
    sig_len = L if split else None
    jq = jquant.quantize_params_int8(jtcfg, jp, jb, sig_len=sig_len)
    tq = quant.quantize_params_int8(tcfg, tp, tb, sig_len=sig_len)
    _assert_qtrees_match(tq, jq)
    assert tq["w1_pil"].shape[1] == (CFG.num_tx if split else 0)


# ----------------------------------------------------------------------
# the int8 DNN
# ----------------------------------------------------------------------

@pytest.mark.parametrize("split", [True, False])
def test_int8_dnn_matches_jax(bn_model, split):
    """Flat and rx-major int8 all-pairs inference against JAX at ≤ −50 dB
    (codes and integer sums match; only the order of the float32
    dequantisation differs), also through prepare_int8_serving's
    transposed weights and precomputed pilot rows."""
    (tcfg, tp, tb), (jtcfg, jp, jb) = bn_model
    sig_len = L if split else None
    jq = jquant.quantize_params_int8(jtcfg, jp, jb, sig_len=sig_len)
    tq = quant.quantize_params_int8(tcfg, tp, tb, sig_len=sig_len)
    x = _flat(12, seed=4)
    ref = np.asarray(jquant.predict_all_pairs_planes_flat_int8(
        JCFG, jtcfg, jq, jnp.asarray(x)))
    for q in (tq, quant.prepare_int8_serving(CFG, tq)):
        got = quant.predict_all_pairs_planes_flat_int8(
            CFG, tcfg, q, torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape and got.dtype == np.complex64
        assert nmse_db(got, ref) <= -50.0
    rx = x.reshape(2, 6, CFG.num_rx, L)
    ref4 = np.asarray(jquant.predict_all_pairs_planes_int8(
        JCFG, jtcfg, jq, jnp.asarray(rx)))
    got4 = quant.predict_all_pairs_planes_int8(CFG, tcfg, tq,
                                               torch.from_numpy(rx)).numpy()
    assert got4.shape == (6, CFG.num_rx, CFG.num_tx, CFG.num_carriers)
    assert nmse_db(got4, ref4) <= -50.0


@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_int8_dnn_vs_f32_and_scale_invariance(bn_model, scale):
    """Against the port's float32 factored path at ≤ −25 dB (the JAX
    test's bound), at the input's scale and 100× it: dynamic activation
    scales track the input (a static scheme would clip)."""
    (tcfg, tp, tb), _ = bn_model
    tq = quant.quantize_params_int8(tcfg, tp, tb)
    x = scale * torch.from_numpy(_flat(32, seed=5))
    got = quant.predict_all_pairs_planes_flat_int8(CFG, tcfg, tq, x)
    ref = mlp.predict_all_pairs_planes_flat(CFG, tcfg, tp, tb, x)
    assert nmse_db(got.numpy(), ref.numpy()) < -25.0


def test_predictor_int8_matches_jax(tmp_path, bn_model):
    """CSIPredictor(device="cpu").all_pairs(x, int8=True) against JAX's
    CSIPredictor on the same npz checkpoint, at ≤ −50 dB; the folded
    weights are made once and kept."""
    _, (jtcfg, jp, jb) = bn_model
    jckpt.save_checkpoint(str(tmp_path / "best"), JCFG, jtcfg, jp, jb)
    jpred, pred = JPredictor(str(tmp_path)), CSIPredictor(str(tmp_path),
                                                          device="cpu")
    rx = _flat(8, seed=6).reshape(2, 4, CFG.num_rx, L)
    ref = jpred.all_pairs(rx, int8=True)
    got = pred.all_pairs(rx, int8=True)
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert nmse_db(got, ref) <= -50.0
    q = pred._qparams
    assert "pil_proj" in q and q["dense"][0]["wq_t"].shape == (2, 128, L)
    pred.all_pairs(rx, int8=True)
    assert pred._qparams is q
