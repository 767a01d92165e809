"""The port's CSI MLP and fused factored DNN wrapper against the JAX
package, in float32 (mamimo_tpu_torch.models.mlp /
ops.kernels.fused_factored).

Weights come from the JAX init_stacked, move to the port through
params_from_jax, and inputs are made with numpy; both packages then run
the same arrays. The CUDA kernels run only on the card (chip_smoke.py);
here the wrappers' CPU path (the kernels' plain versions) is held to the
JAX kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.ltf import pilot_p_matrix as j_pilot
from mamimo_tpu.ops.pallas.fused_factored import (
    fused_factored_planes as j_fused,
    prepare_factored_weights as j_prepare,
)
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    _tail_plain as factored_tail_plain,
    factored_sig_proj,
    factored_tail,
    fused_factored_planes,
    predict_all_pairs_planes_kernel,
    prepare_factored_weights,
)

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)


def _models(use_bn, seed, hidden=(128, 128)):
    """JAX and port parameters of one model; the BN state is made
    non-trivial so the folded affines are exercised."""
    tcfg = TrainConfig(hidden=hidden, use_bn=use_bn)
    jtcfg = JTrainConfig(hidden=hidden, use_bn=use_bn)
    jp, jb = jmlp.init_stacked(jax.random.PRNGKey(seed), JCFG, jtcfg)
    jp, jb = jax.tree.map(np.asarray, (jp, jb))
    rng = np.random.default_rng(seed)
    jb = {"mean": [rng.normal(0, 0.1, m.shape).astype(np.float32)
                   for m in jb["mean"]],
          "var": [rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                  for v in jb["var"]]}
    jp["bn"] = [{"scale": rng.uniform(0.5, 1.5, l["scale"].shape
                                      ).astype(np.float32),
                 "bias": rng.normal(0, 0.1, l["bias"].shape
                                    ).astype(np.float32)}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": rng.normal(0, 0.05, l["b"].shape
                                                 ).astype(np.float32)}
                   for l in jp["dense"]]
    tp, tb = mlp.params_from_jax(jp, jb)
    return tcfg, jtcfg, (jp, jb), (tp, tb)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _planes(s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, CFG.len_ltf)).astype(np.float32)


def test_init_matches_reference_structure():
    tcfg = TrainConfig(hidden=(128, 64))
    jtcfg = JTrainConfig(hidden=(128, 64))
    g = torch.Generator().manual_seed(0)
    tp, tb = mlp.init_stacked(g, CFG, tcfg)
    jp, jb = jmlp.init_stacked(jax.random.PRNGKey(0), JCFG, jtcfg)
    tl = mlp.tree_leaves({"params": tp, "bn_state": tb})
    jl = jax.tree_util.tree_leaves({"params": jp, "bn_state": jb})
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    for t, j in zip(tl, jl):
        assert t.dtype == torch.float32
        if j.ndim == 3:                  # glorot weights: same bound
            lim = np.sqrt(6.0 / (j.shape[1] + j.shape[2]))
            assert float(t.abs().max()) <= lim
            assert float(t.std()) == pytest.approx(lim / np.sqrt(3), rel=0.05)
        else:                            # BN and biases: same constants
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the seed fixes the draw
    g2 = torch.Generator().manual_seed(0)
    tp2, _ = mlp.init_stacked(g2, CFG, tcfg)
    assert torch.equal(tp2["dense"][0]["w"], tp["dense"][0]["w"])


@pytest.mark.parametrize("use_bn", [True, False])
def test_factored_all_pairs_matches_jax(use_bn):
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(use_bn, seed=1)
    x = _planes(5, seed=2)
    ref = jmlp._factored_all_pairs(JCFG, jtcfg, jp, jb, jnp.asarray(x))
    got = mlp._factored_all_pairs(CFG, tcfg, tp, tb, torch.from_numpy(x))
    _close(got, ref, 1e-4)

    rx = x.reshape(2, 5, 1, CFG.len_ltf)[:, :4].reshape(2, 2, 2, -1)
    ref = jmlp.predict_all_pairs_planes(JCFG, jtcfg, jp, jb, jnp.asarray(rx))
    got = mlp.predict_all_pairs_planes(CFG, tcfg, tp, tb, torch.from_numpy(rx))
    _close(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("use_bn", [True, False])
def test_concat_input_forward_matches_jax(use_bn):
    """csi_mlp_apply (eval) on materialized [sig ‖ pilot] inputs and the
    deployment predict_complex."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(use_bn, seed=3)
    rng = np.random.default_rng(4)
    sig = (rng.standard_normal((6, CFG.len_ltf))
           + 1j * rng.standard_normal((6, CFG.len_ltf))).astype(np.complex64)
    pilot = np.asarray(j_pilot(8))[:, rng.integers(0, 8, 6)].T.copy()

    x = np.asarray(jmlp.preprocess_input(JCFG, jtcfg, jnp.asarray(sig.real),
                                         jnp.asarray(pilot)))
    xt = mlp.preprocess_input(CFG, tcfg, torch.from_numpy(sig.real.copy()),
                              torch.from_numpy(pilot))
    np.testing.assert_array_equal(xt.numpy(), x)
    p0 = jax.tree.map(lambda a: a[0], (jp, jb))
    ref, _ = jmlp.csi_mlp_apply(jtcfg, p0[0], p0[1], jnp.asarray(x))
    got, _ = mlp.csi_mlp_apply(tcfg, mlp.plane(tp, 0), mlp.plane(tb, 0), xt)
    _close(got, ref, 1e-4)

    ref = jmlp.predict_complex(JCFG, jtcfg, jp, jb, jnp.asarray(sig),
                               jnp.asarray(pilot))
    got = mlp.predict_complex(CFG, tcfg, tp, tb, torch.from_numpy(sig),
                              torch.from_numpy(pilot))
    _close(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("use_bn", [True, False])
def test_prepared_weights_and_fused_wrapper_match_jax_kernel(use_bn):
    """prepare_factored_weights + the fused wrapper's CPU path against the
    JAX fused kernel in interpret mode at dot_dtype=f32 (the tolerance of
    tests/test_fused_factored.py)."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(use_bn, seed=5)
    jprep = j_prepare(JCFG, jtcfg, jax.tree.map(jnp.asarray, jp),
                      jax.tree.map(jnp.asarray, jb), dot_dtype=jnp.float32)
    prep = prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=torch.float32)
    for k in jprep:
        _close(prep[k].numpy(), jprep[k], 1e-6)

    s = 6
    x = _planes(s, seed=6)
    ref = np.asarray(j_fused(JCFG, jtcfg, jprep, jnp.asarray(x), block_s=64,
                             block_k=512, dot_dtype=jnp.float32,
                             out_dtype=jnp.float32))     # (2, ntx, S, C)
    got = fused_factored_planes(CFG, tcfg, prep, torch.from_numpy(x))
    _close(got.numpy(), ref.transpose(0, 2, 1, 3), 2e-4)
    # the two kernels' wrappers compose to the same
    sp = factored_sig_proj(torch.from_numpy(x), prep["w1"])
    np.testing.assert_array_equal(
        factored_tail(prep, sp, CFG.num_carriers).numpy(), got.numpy())
    # and the all-pairs form of it equals the plain f32 model
    rx = torch.from_numpy(x).reshape(2, 3, 2, -1)
    _close(predict_all_pairs_planes_kernel(CFG, tcfg, prep, rx).numpy(),
           mlp.predict_all_pairs_planes(CFG, tcfg, tp, tb, rx).numpy(), 2e-4)


@pytest.mark.parametrize("use_bn, hidden", [(True, (64, 64)),
                                            (False, (96, 40))])
def test_prepared_weights_pad_hidden_widths_to_the_kernel_tile(use_bn,
                                                               hidden):
    """Hidden widths that are no multiple of 128 are zero-padded to one
    when the weights are prepared (the kernels' tile); the padded units
    stay 0, so the fused wrapper equals JAX's plain all-pairs model."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(use_bn, seed=11, hidden=hidden)
    prep = prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=torch.float32)
    h1, h2 = hidden
    # the float32 tree's K-major weights: their TF32 parts (at dim 1)
    assert tuple(prep["w1t_tf32"].shape) == (2, 2, 128, CFG.len_ltf)
    assert tuple(prep["w2t_tf32"].shape) == (2, 2, 128, 128)
    assert tuple(prep["w3t_tf32"].shape) == (2, 2, 256, 128)
    for k in ("w1", "hb", "a1", "c1"):
        assert prep[k].shape[-1] == 128 and not bool(prep[k][..., h1:].any())
    for k in ("b2", "a2", "c2"):
        assert prep[k].shape[-1] == 128 and not bool(prep[k][..., h2:].any())
    assert not bool(prep["w2"][:, h1:].any())
    assert not bool(prep["w2"][:, :, h2:].any())
    assert not bool(prep["w3"][:, h2:].any())

    x = _planes(6, seed=12)
    rx = x.reshape(2, 3, 2, -1)
    ref = np.asarray(jmlp.predict_all_pairs_planes(
        JCFG, jtcfg, jax.tree.map(jnp.asarray, jp),
        jax.tree.map(jnp.asarray, jb), jnp.asarray(rx)))
    got = predict_all_pairs_planes_kernel(CFG, tcfg, prep,
                                          torch.from_numpy(rx)).numpy()
    _close(got, ref, 2e-4)


def test_bf16_prepared_weights_stay_close():
    """bf16 weights and operands (what the card runs) stay within bf16
    rounding of the float32 model: the plain version rounds operands
    exactly where the kernels do."""
    tcfg, _, _, (tp, tb) = _models(True, seed=7)
    prep = prepare_factored_weights(CFG, tcfg, tp, tb)
    assert prep["w1"].dtype == torch.bfloat16
    assert prep["hb"].dtype == torch.float32
    x = torch.from_numpy(_planes(4, seed=8))
    ref = mlp._factored_all_pairs(CFG, tcfg, tp, tb, x).numpy()
    got = fused_factored_planes(CFG, tcfg, prep, x.to(torch.bfloat16)).numpy()
    nmse = np.sum((got - ref) ** 2) / np.sum(ref ** 2)
    assert 10 * np.log10(nmse) < -40


@pytest.mark.parametrize("tcfg", [TrainConfig(hidden=(128, 128), decimate="max"),
                                  TrainConfig(hidden=(128, 128), in_fraction=2)])
def test_factored_forms_refuse_reduced_input(tcfg):
    """The factored forms share layer 1 across heads and need the whole
    LTF as signal input; other input pipelines raise ValueError."""
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(0), CFG, tcfg)
    x = torch.from_numpy(_planes(2, seed=0))
    with pytest.raises(ValueError, match="default input"):
        mlp._factored_all_pairs(CFG, tcfg, tp, tb, x)
    with pytest.raises(ValueError, match="default input"):
        prepare_factored_weights(CFG, tcfg, tp, tb)


def test_fused_kernels_take_three_hidden_layers():
    """Three hidden layers, once refused: prepare_factored_weights folds
    every layer (w2, w3 hidden, w4 the output) and the plain tail after
    layer 1 matches JAX's bf16 factored heads within the bf16 DNN
    tolerance of the depth-2 tests (−40 dB)."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(True, seed=12,
                                              hidden=(64, 64, 64))
    prep = prepare_factored_weights(CFG, tcfg, tp, tb)
    assert tuple(prep["w3"].shape) == (2, 128, 128)
    assert tuple(prep["w4"].shape) == (2, 128, 256)
    assert tuple(prep["w4t"].shape) == (2, 256, 128)
    x = _planes(4, seed=13)
    sp = factored_sig_proj(torch.from_numpy(x).to(torch.bfloat16),
                           prep["w1"])
    got = factored_tail_plain(prep, sp, CFG.num_carriers).numpy()
    ref = np.asarray(jmlp._factored_all_pairs(
        JCFG, jtcfg, jp, jb, jnp.asarray(x).astype(jnp.bfloat16),
        dtype=jnp.bfloat16).astype(jnp.float32))
    assert got.shape == ref.shape
    nmse = np.sum((got - ref) ** 2) / np.sum(ref ** 2)
    assert 10 * np.log10(nmse) < -40


def test_training_mode_not_ported():
    """Training mode, once refused, is ported: one plane's train-mode
    forward with dropout 0 (batch BN statistics, biased variance, the
    Keras running update) against JAX's, outputs and new statistics to
    1e-5 relative."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = _models(True, seed=9)
    tcfg = tcfg.replace(dropout=0.0)
    jtcfg = jtcfg.replace(dropout=0.0)
    x = np.random.default_rng(10).standard_normal(
        (12, CFG.len_ltf + 8)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], (jp, jb))
    ref, ref_bn = jmlp.csi_mlp_apply(jtcfg, p0[0], p0[1], jnp.asarray(x),
                                     train=True, rng=jax.random.PRNGKey(0))
    got, got_bn = mlp.csi_mlp_apply(tcfg, mlp.plane(tp, 0), mlp.plane(tb, 0),
                                    torch.from_numpy(x), train=True)
    _close(got, ref, 1e-5)
    for k in ("mean", "var"):
        for g, r in zip(got_bn[k], ref_bn[k]):
            _close(g, r, 1e-5)
