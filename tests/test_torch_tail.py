"""The MLP tail kernels' operands and plain versions on the CPU (the port's
ops.kernels.fused_factored::factored_tail and
ops.kernels.mlp_infer::mlp_infer_tail).

The CUDA tails (csrc/tail_sm90.cuh) read W2 and W3 K-major from the
prepared ``w2t`` and ``w3t``; here those are held to JAX's layer-2/3
weights, the wrappers' kernel branch is shown to refuse them missing or
ill-shaped before any launch, and the plain versions are held to JAX's
fused kernels in interpret mode at the tails' edges: 1 row, a ragged row
count, hidden width 128. Tolerances: exact for the weight copies (a
transpose and the same bf16 rounding); a relative 2e-4 for float32
products (the JAX package's own bound, tests/test_pallas.py) and 1e-2 for
bf16 products (both packages round the same operands to bf16 and differ
only where a sum's order flips a rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.pallas import fused_factored as jff
from mamimo_tpu.ops.pallas import mlp_infer as jmi
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.util import tf32_split

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
BF16 = torch.bfloat16
C = CFG.num_carriers


@pytest.fixture(scope="module")
def model():
    """JAX and port parameters of one stacked model (hidden 128/128) with
    a non-trivial BN state, so the folded affines matter."""
    jtcfg = JTrainConfig(hidden=(128, 128))
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(21), JCFG, jtcfg))
    rng = np.random.default_rng(21)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    return (TrainConfig(hidden=(128, 128)), jtcfg, (jp, jb),
            mlp.params_from_jax(jp, jb))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _as(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dot_dtype", [torch.float32, BF16])
def test_factored_w2t_w3t_are_the_transposes_of_jax_layers23(model,
                                                            dot_dtype):
    tcfg, _, (jp, _), (tp, tb) = model
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=dot_dtype)
    # a float32 tree carries the K-major weights as their TF32 parts
    # (w2t_tf32, w3t_tf32: parts at dim 1) in place of w2t and w3t
    f32 = dot_dtype == torch.float32
    sfx, parts = ("_tf32", (2,)) if f32 else ("", ())
    w2t, w3t = prep["w2t" + sfx], prep["w3t" + sfx]
    kmajor = tf32_split if f32 else (lambda t: t)
    assert f32 != ("w2t" in prep) and f32 != ("w3t" in prep)
    assert tuple(w2t.shape) == (2, *parts, 128, 128)
    assert tuple(w3t.shape) == (2, *parts, 256, 128)
    for t in (w2t, w3t):
        assert t.dtype == dot_dtype and t.is_contiguous()
    for d in range(2):
        w2 = _as(jp["dense"][1]["w"][d], dot_dtype)
        w3 = _as(jp["out"]["w"][d], dot_dtype)
        w3k = torch.zeros((256, 128), dtype=dot_dtype)
        w3k[:C] = w3.T
        assert torch.equal(w2t[d], kmajor(w2.T))
        assert torch.equal(w3t[d], kmajor(w3k))
        # the older keys are unchanged: W2 and the padded W3 as they were
        assert torch.equal(prep["w2"][d], w2)
        assert torch.equal(prep["w3"][d, :, :C], w3)
        assert not bool(prep["w3"][d, :, C:].any())
        assert torch.equal(w3t[d], kmajor(prep["w3"][d].T))


def test_mlp_w2t_w3t_are_the_transposes_of_jax_layers23(model):
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    prep = mi.prepare_mlp_infer_weights(tcfg, tp, tb)
    assert tuple(prep["w2t"].shape) == (2, 128, 128)
    assert tuple(prep["w3t"].shape) == (2, 256, 128)
    for d in range(2):
        ws, _, _, _ = jmi.fold_bn_into_dense(
            jtcfg, *jax.tree.map(lambda a: a[d], (jp, jb)))
        w2, w3 = _as(ws[1], BF16), _as(ws[2], BF16)
        assert torch.equal(prep["w2t"][d], w2.T)
        assert torch.equal(prep["w3t"][d, :C], w3.T)
        assert not bool(prep["w3t"][d, C:].any())
        assert torch.equal(prep["w2"][d], w2)
        assert torch.equal(prep["w3"][d, :, :C], w3)
        assert not bool(prep["w3"][d, :, C:].any())
        one = mlp.plane(prep, d)
        assert torch.equal(one["w2t"], one["w2"].T)
        assert torch.equal(one["w3t"], one["w3"].T)


def _drop(tree, key, bad):
    """tree without `key` (bad None) or with a zero tensor of shape bad."""
    out = dict(tree)
    if bad is None:
        del out[key]
    else:
        out[key] = torch.zeros(bad, dtype=BF16)
    return out


@pytest.mark.parametrize("key, bad", [
    ("w2t", None), ("w3t", None), ("w2t", (2, 128, 256)),
    ("w3t", (2, 234, 128))])
def test_factored_tail_kernel_branch_refuses_bad_kmajor_weights(
        monkeypatch, model, key, bad):
    """The CUDA branch's checks run before any launch (shown without a
    card: the wrapper's device test is made to answer CUDA)."""
    tcfg, _, _, (tp, tb) = model
    prep = _drop(ff.prepare_factored_weights(CFG, tcfg, tp, tb), key, bad)
    monkeypatch.setattr(ff, "on_cuda", lambda *t: True)
    with pytest.raises(ValueError, match=rf"prepared\['{key}'\]"):
        ff.factored_tail(prep, torch.zeros((2, 3, 128)), C)


@pytest.mark.parametrize("key, bad", [
    ("w2t", None), ("w3t", None), ("w2t", (128, 64)), ("w3t", (128, 256))])
def test_mlp_infer_tail_kernel_branch_refuses_bad_kmajor_weights(
        monkeypatch, model, key, bad):
    tcfg, _, _, (tp, tb) = model
    prep = _drop(mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), 0),
                 key, bad)
    monkeypatch.setattr(mi, "on_cuda", lambda *t: True)
    with pytest.raises(ValueError, match=rf"prepared\['{key}'\]"):
        mi.mlp_infer_tail(prep, torch.zeros((3, 128), dtype=BF16))


def _planes(s, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (2, s, CFG.len_ltf))).astype(np.float32)


@pytest.mark.parametrize("s", [1, 7])
@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
def test_factored_tail_plain_matches_jax_kernel(model, s, dot):
    """The tail's plain version, on the layer-1 wrapper's sig_proj, against
    JAX's fused kernel (interpret mode) at 1 and 7 samples (a ragged
    block) and hidden width 128."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    tdot, jdot = getattr(torch, dot), getattr(jnp, dot)
    jprep = jff.prepare_factored_weights(
        JCFG, jtcfg, jax.tree.map(jnp.asarray, jp),
        jax.tree.map(jnp.asarray, jb), dot_dtype=jdot)
    x = _planes(s, seed=s)
    ref = np.asarray(jff.fused_factored_planes(
        JCFG, jtcfg, jprep, jnp.asarray(x), block_s=8, block_k=512,
        dot_dtype=jdot, out_dtype=jnp.float32, interpret=True))
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=tdot)
    sp = ff.factored_sig_proj(torch.from_numpy(x), prep["w1"])
    got = ff.factored_tail(prep, sp, C)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, 8, C)
    assert _rel(got.numpy(), ref.transpose(0, 2, 1, 3)) < (
        2e-4 if dot == "float32" else 1e-2)


@pytest.mark.parametrize("rows", [1, 37])
def test_mlp_infer_tail_plain_matches_jax_kernel(model, rows):
    """The tail's plain version on the layer-1 wrapper's h1 against JAX's
    fused kernel (interpret mode, bf16) at 1 and 37 rows, hidden 128."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    x = (0.5 * np.random.default_rng(rows).standard_normal(
        (rows, CFG.len_ltf + CFG.num_tx))).astype(np.float32)
    d = 1
    ref = jmi.mlp_infer_pallas(jtcfg, *jax.tree.map(lambda a: a[d], (jp, jb)),
                               jnp.asarray(x), block_b=8, block_k=256,
                               dot_dtype=jnp.bfloat16, interpret=True)
    prep = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), d)
    got = mi.mlp_infer_tail(prep, mi.mlp_infer_layer1(prep,
                                                      torch.from_numpy(x)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, C)
    assert _rel(got.numpy(), ref) < 1e-2
