"""The port's fused MLP on the materialized input
(mamimo_tpu_torch.ops.kernels.mlp_infer) and its factored all-pairs
counterpart (models.mlp::predict_all_pairs) against the JAX package on
the CPU.

Weights come from the JAX init_stacked with a non-trivial BN state (so
the folded affines matter), move to the port through params_from_jax,
and inputs are made with numpy. The JAX kernel runs in interpret mode;
the port's wrappers run their plain versions (the CUDA kernels run only
on the card, chip_smoke.py). Tolerances: float32 products at a relative
2e-4 (the JAX package's own bound, tests/test_pallas.py); bf16 products
at a relative 1e-2 (both packages round the same operands to bf16, so
they differ only where a sum's order flips a rounding; the JAX package
holds its bf16 kernel to 2e-2 of the float32 model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.pallas import mlp_infer as jmi
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi

CFG = SimConfig(num_tx=8, num_rx=2)


@pytest.fixture(scope="module")
def model(small_cfg, tcfg):
    """JAX and port parameters of one stacked model with non-trivial BN
    statistics, scales and biases."""
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(3), small_cfg, tcfg))
    rng = np.random.default_rng(3)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    jp["out"] = {"w": jp["out"]["w"],
                 "b": f32(rng.normal(0, 0.05, jp["out"]["b"].shape))}
    ptcfg = TrainConfig(hidden=tuple(tcfg.hidden))
    return ptcfg, tcfg, (jp, jb), mlp.params_from_jax(jp, jb)


def _plane(tree, d):
    return jax.tree.map(lambda a: a[d], tree)


def _x(rows, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (rows, CFG.len_ltf + CFG.num_tx))).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("use_bn", [True, False])
def test_fold_bn_matches_jax(model, use_bn):
    ptcfg, jtcfg, (jp, jb), (tp, tb) = model
    if not use_bn:
        jp, tp = {**jp, "bn": []}, {**tp, "bn": []}
    for d in range(2):
        got = mi.fold_bn_into_dense(ptcfg, mlp.plane(tp, d), mlp.plane(tb, d))
        ref = jmi.fold_bn_into_dense(jtcfg, _plane(jp, d), _plane(jb, d))
        for g_list, r_list in zip(got, ref):
            assert len(g_list) == len(r_list)
            for g, r in zip(g_list, r_list):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
def test_mlp_infer_matches_jax_interpret(model, dot):
    """With bf16 products the JAX-style params and the prepared (bf16)
    tree give the same answer."""
    ptcfg, jtcfg, (jp, jb), (tp, tb) = model
    x = _x(50, 4)
    tdot, jdot = getattr(torch, dot), getattr(jnp, dot)
    ref = jmi.mlp_infer_pallas(jtcfg, _plane(jp, 1), _plane(jb, 1),
                               jnp.asarray(x), block_b=32, block_k=256,
                               dot_dtype=jdot, interpret=True)
    got = mi.mlp_infer_pallas(ptcfg, mlp.plane(tp, 1), mlp.plane(tb, 1),
                              torch.from_numpy(x), dot_dtype=tdot)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < (2e-4 if dot == "float32" else 1e-2)
    if dot == "bfloat16":
        prep = mlp.plane(mi.prepare_mlp_infer_weights(ptcfg, tp, tb), 1)
        got_p = mi.mlp_infer_pallas(ptcfg, prep, None, torch.from_numpy(x))
        np.testing.assert_array_equal(got_p.numpy(), got.numpy())


def test_layer_wrappers_compose_to_plain(model):
    """On the CPU the two kernel wrappers run the plain pieces: h1 is
    bf16, and layer 1 then the tail is mlp_infer_pallas (bf16)."""
    ptcfg, _, _, (tp, tb) = model
    prep = mlp.plane(mi.prepare_mlp_infer_weights(ptcfg, tp, tb), 0)
    x = torch.from_numpy(_x(37, 5))
    h1 = mi.mlp_infer_layer1(prep, x)
    # hidden 64 is padded to the kernels' 128-wide tile; the padded units
    # are 0
    assert h1.dtype == torch.bfloat16 and tuple(h1.shape) == (37, 128)
    assert not bool(h1[:, 64:].any())
    y = mi.mlp_infer_tail(prep, h1)
    assert torch.equal(y, mi.mlp_infer_pallas(ptcfg, prep, None, x))
    assert prep["w1"].shape[0] == 2592 and prep["w3"].shape[1] == 256


def test_predict_complex_pallas_matches_jax(model, small_cfg):
    ptcfg, jtcfg, (jp, jb), (tp, tb) = model
    rng = np.random.default_rng(6)
    sig = (rng.standard_normal((24, CFG.len_ltf))
           + 1j * rng.standard_normal((24, CFG.len_ltf))).astype(np.complex64)
    pil = np.asarray(rng.choice([-1.0, 1.0], (24, CFG.num_tx)), np.float32)
    ref = jmi.predict_complex_pallas(small_cfg, jtcfg, jp, jb,
                                     jnp.asarray(sig), jnp.asarray(pil))
    got = mi.predict_complex_pallas(CFG, ptcfg, tp, tb, torch.from_numpy(sig),
                                    torch.from_numpy(pil))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 1e-2
    prep = mi.prepare_mlp_infer_weights(ptcfg, tp, tb)
    got_p = mi.predict_complex_pallas(CFG, ptcfg, prep, None,
                                      torch.from_numpy(sig),
                                      torch.from_numpy(pil))
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())


def test_predict_all_pairs_matches_jax(model, small_cfg):
    ptcfg, jtcfg, (jp, jb), (tp, tb) = model
    rng = np.random.default_rng(8)
    shape = (3, CFG.len_ltf, CFG.num_rx)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = jmlp.predict_all_pairs(small_cfg, jtcfg, jp, jb, jnp.asarray(rx))
    got = mlp.predict_all_pairs(CFG, ptcfg, tp, tb, torch.from_numpy(rx))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 2e-4


def test_float32_dots_reach_the_float32_kernel(model, monkeypatch):
    """dot_dtype=float32 routed to the CUDA kernels launches their float32
    mode (shown without a card: the wrapper's device test is made to
    answer CUDA and the library records each launch): layer 1 gets the
    float32 x itself (no bf16 copy) and the float32 w1t, the tail the
    float32 h1 layer 1 wrote, both with mode 2, each counted."""
    import contextlib
    import types

    ptcfg, _, _, (tp, tb) = model
    calls = []

    class _Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or 0

    monkeypatch.setattr(mi, "on_cuda", lambda *t: True)
    monkeypatch.setattr(mi, "_mlp_lib", _Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    x = torch.from_numpy(_x(4, 7))
    before = (mi.mlp_infer_layer1.launches_f32, mi.mlp_infer_tail.launches_f32)
    y = mi.mlp_infer_pallas(ptcfg, mlp.plane(tp, 0), mlp.plane(tb, 0), x,
                            dot_dtype=torch.float32)
    (f1, a1), (f2, a2) = calls
    assert (f1, f2) == ("mlp_layer1_launch", "mlp_tail_launch")
    assert a1[0] == x.data_ptr() and a1[-2] == 2 and a2[-2] == 2
    assert y.dtype == torch.float32 and tuple(y.shape) == (4, CFG.num_carriers)
    assert (mi.mlp_infer_layer1.launches_f32,
            mi.mlp_infer_tail.launches_f32) == (before[0] + 1, before[1] + 1)


def test_three_hidden_layers_refused():
    tcfg = TrainConfig(hidden=(32, 32, 32))
    tp, tb = mlp.init_csi_mlp(torch.Generator().manual_seed(0), CFG, tcfg)
    with pytest.raises(ValueError, match="2 hidden layers"):
        mi.mlp_infer_pallas(tcfg, tp, tb, torch.from_numpy(_x(2, 0)))
