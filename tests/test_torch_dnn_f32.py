"""The float32 modes of the port's DNN kernels (kernel 2: the factored
all-pairs kernels of ops/kernels/fused_factored.py; kernel 5: the fused
MLP of ops/kernels/mlp_infer.py) and kernel 2's ``out_dtype``, on the
CPU.

The CUDA kernels run only on the card (chip_smoke.py phase 5n holds them
to these plain versions at −90 dB). Here, at Nt 8 and hidden widths of
at most 256:

- the weights of ``prepare_mlp_infer_weights(dot_dtype=float32)``
  against JAX's ``fold_bn_into_dense`` (1e-6 of the scale: the same
  float32 arithmetic);
- ``mlp_infer_pallas`` and ``predict_complex_pallas`` with float32 dots
  against JAX's ``mlp_infer_pallas(dot_dtype=float32)`` in interpret
  mode, at JAX's own 2e-4 relative (tests/test_pallas.py);
- ``fused_factored_planes`` with ``out_dtype=bfloat16``, float32 and
  bf16 dots, against JAX's kernel in interpret mode with the same
  keywords (transposed from its head-major layout): one bf16 step of
  each element, the element's magnitude floored at 2^-16 of the largest
  (below it the two float32 sums' order sets the last bits);
- the float32 rows route (``factored_heads``, ``factored_dense``,
  ``factored_rows_tail``) at depths 1, 2 and 3 against the port's
  float32 plain model (1e-5 of the scale);
- the float32 tail's arithmetic rebuilt from ``tf32_split`` parts (three
  products a 32-wide k-step, each k-step's sum added in float32):
  −110 dB of float64, where one TF32 pass is not within −80 dB;
- the wrappers' CUDA branches with the device test made to answer CUDA
  and the recording library of tests/test_torch_f32_modes.py: float32
  weights and rows reach each launch as they are with the float32 mode
  bit, bf16 the bf16 mode, ``out_dtype=bfloat16`` the bf16 store bit; a
  mixed tree or a ``dot_dtype`` other than the prepared weights' raises;
  each binding has as many arguments as its C function.
"""

import contextlib
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.pallas import mlp_infer as jmi
from mamimo_tpu.ops.pallas.fused_factored import (
    fused_factored_planes as j_fused,
    prepare_factored_weights as j_prepare,
)
from mamimo_tpu_torch import bench
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.util import tf32_split
from test_torch_f32_modes import _Lib

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
C = CFG.num_carriers
F32, BF16 = torch.float32, torch.bfloat16
S = 6


def _models(seed, hidden=(128, 128)):
    """JAX and port parameters of one stacked model with non-trivial BN
    statistics, scales and biases."""
    tcfg, jtcfg = TrainConfig(hidden=hidden), JTrainConfig(hidden=hidden)
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), JCFG, jtcfg))
    rng = np.random.default_rng(seed)
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
    return tcfg, jtcfg, (jp, jb), mlp.params_from_jax(jp, jb)


@pytest.fixture(scope="module")
def model():
    return _models(3)


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _db(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref ** 2))


def _x(rows, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (rows, CFG.len_ltf + CFG.num_tx))).astype(np.float32)


def _planes(s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, CFG.len_ltf)).astype(np.float32)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


# ----------------------------------------------------------------------
# kernel 5: the fused MLP with float32 dots against JAX
# ----------------------------------------------------------------------

def test_prepare_mlp_infer_weights_float32_matches_jax_fold(model):
    """dot_dtype=float32 keeps every weight float32: the folded weights,
    biases and affines of each plane equal JAX's fold_bn_into_dense, the
    K-major copies the TF32 parts of their transposes (w{k}t_tf32, in
    place of w{k}t)."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    prep = mi.prepare_mlp_infer_weights(tcfg, tp, tb, dot_dtype=F32)
    for d in range(2):
        ws, bs, ss, ts = jmi.fold_bn_into_dense(
            jtcfg, jax.tree.map(lambda a: a[d], jp),
            jax.tree.map(lambda a: a[d], jb))
        one = mlp.plane(prep, d)
        for k, w in enumerate(ws, 1):
            got = one[f"w{k}"]
            assert got.dtype == F32
            _close(got[:w.shape[0], :w.shape[1]].numpy(), w, 1e-6)
            assert f"w{k}t" not in one
            assert torch.equal(one[f"w{k}t_tf32"], tf32_split(got.T))
        _close(one["b1"].numpy(), bs[0], 1e-6)
        _close(one["b2"].numpy(), bs[1], 1e-6)
        _close(one["b3"].numpy(), bs[2], 1e-6)
        for k, (sc, sh) in enumerate(zip(ss, ts), 1):
            _close(one[f"s{k}"].numpy(), sc, 1e-6)
            _close(one[f"t{k}"].numpy(), sh, 1e-6)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mi.prepare_mlp_infer_weights(tcfg, tp, tb, dot_dtype=torch.float16)


def test_mlp_infer_float32_matches_jax(model):
    """mlp_infer_pallas(dot_dtype=float32) on raw parameters and on the
    float32 tree, and predict_complex_pallas on both planes, against
    JAX's kernel with float32 dots in interpret mode."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    x = _x(5, 4)
    ref = jmi.mlp_infer_pallas(jtcfg, jax.tree.map(lambda a: a[1], jp),
                               jax.tree.map(lambda a: a[1], jb),
                               jnp.asarray(x), dot_dtype=jnp.float32,
                               interpret=True)
    got = mi.mlp_infer_pallas(tcfg, mlp.plane(tp, 1), mlp.plane(tb, 1),
                              torch.from_numpy(x), dot_dtype=F32)
    assert got.dtype == F32 and _rel(got.numpy(), ref) < 2e-4
    prep = mi.prepare_mlp_infer_weights(tcfg, tp, tb, dot_dtype=F32)
    got_p = mi.mlp_infer_pallas(tcfg, mlp.plane(prep, 1), None,
                                torch.from_numpy(x), dot_dtype=F32)
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())

    rng = np.random.default_rng(6)
    sig = (rng.standard_normal((8, CFG.len_ltf))
           + 1j * rng.standard_normal((8, CFG.len_ltf))).astype(np.complex64)
    pil = np.asarray(rng.choice([-1.0, 1.0], (8, CFG.num_tx)), np.float32)
    ref_c = jmi.predict_complex_pallas(JCFG, jtcfg, jp, jb, jnp.asarray(sig),
                                       jnp.asarray(pil),
                                       dot_dtype=jnp.float32, interpret=True)
    for tree, bn in ((tp, tb), (prep, None)):
        got_c = mi.predict_complex_pallas(CFG, tcfg, tree, bn,
                                          torch.from_numpy(sig),
                                          torch.from_numpy(pil),
                                          dot_dtype=F32)
        assert got_c.dtype == torch.complex64
        assert _rel(got_c.numpy(), ref_c) < 2e-4


# ----------------------------------------------------------------------
# kernel 2: out_dtype and float32 dots against JAX
# ----------------------------------------------------------------------

def _bf16_steps(got, ref):
    """|got − ref| in bf16 steps of each element's magnitude, floored at
    2^-16 of the largest."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 2.0 ** -16 * np.abs(ref).max())
    step = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return np.abs(got - ref) / step


@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
def test_fused_factored_out_bf16_matches_jax(model, dot):
    """fused_factored_planes(dot_dtype, out_dtype=bfloat16) returns bf16
    values within one bf16 step of JAX's kernel with the same keywords;
    the port's layout is JAX's head-major one transposed."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    tdot, jdot = (F32, jnp.float32) if dot == "float32" \
        else (BF16, jnp.bfloat16)
    jprep = j_prepare(JCFG, jtcfg, _jtree(jp), _jtree(jb), dot_dtype=jdot)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=tdot)
    x = _planes(S, 5)
    ref = np.asarray(j_fused(JCFG, jtcfg, jprep, jnp.asarray(x),
                             block_s=64, block_k=512, dot_dtype=jdot,
                             out_dtype=jnp.bfloat16, interpret=True)
                     .astype(jnp.float32)).transpose(0, 2, 1, 3)
    got = ff.fused_factored_planes(CFG, tcfg, prep, torch.from_numpy(x),
                                   block_s=64, block_k=512, dot_dtype=tdot,
                                   out_dtype=BF16, interpret=True)
    assert got.dtype == BF16 and tuple(got.shape) == ref.shape
    assert _bf16_steps(got.float().numpy(), ref).max() <= 1.0
    f32 = ff.fused_factored_planes(CFG, tcfg, prep, torch.from_numpy(x))
    assert f32.dtype == F32 and torch.equal(got, f32.to(BF16))


def test_dot_dtype_must_match_the_prepared_weights(model):
    tcfg, _, _, (tp, tb) = model
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
    x = torch.from_numpy(_planes(2, 1))
    with pytest.raises(ValueError, match="differs from the prepared"):
        ff.fused_factored_planes(CFG, tcfg, prep, x, dot_dtype=F32)
    with pytest.raises(TypeError, match="out_dtype"):
        ff.fused_factored_planes(CFG, tcfg, prep, x, out_dtype=torch.float16)
    ff.fused_factored_planes(CFG, tcfg, prep, x, dot_dtype=BF16)


def test_pallas_factored_returns_jax_bf16_rounded_estimate(model):
    """The bench path pallas_factored stores its DNN estimate rounded to
    bf16, as JAX's kernel's default out_dtype does: every value is a
    bf16 value, within one bf16 step of JAX's kernel."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    x = _planes(S, 8)
    _, h_dnn = bench.make_estimation_fn_pallas_factored(
        CFG, tcfg, tp, tb)(torch.from_numpy(x))
    planes = torch.stack([h_dnn.real, h_dnn.imag])
    assert torch.equal(planes, planes.to(BF16).float())
    jprep = j_prepare(JCFG, jtcfg, _jtree(jp), _jtree(jb))
    ref = np.asarray(j_fused(JCFG, jtcfg, jprep, jnp.asarray(x),
                             block_s=64, block_k=512, interpret=True)
                     .astype(jnp.float32)).transpose(0, 2, 1, 3)
    assert _bf16_steps(planes.numpy(), ref).max() <= 1.0


# ----------------------------------------------------------------------
# the float32 rows route at depths 1, 2 and 3
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [(96,), (64, 96), (64, 96, 80)])
def test_float32_rows_route_matches_the_plain_model(hidden):
    """factored_heads → factored_dense … → factored_rows_tail (or the
    output's factored_dense at depth 1) on float32 weights: float32 rows
    at every step, the answer the port's float32 plain model's; bf16 out
    the float32 answer rounded."""
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(4), CFG, tcfg)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=F32)
    x = torch.from_numpy(_planes(5, 9))
    sp = ff.factored_sig_proj(x, prep["w1"], prep["w1t_tf32"])
    h = ff.factored_heads(prep, sp)
    assert h.dtype == F32 and tuple(h.shape) == (2, 5 * CFG.num_tx, 128)
    d = len(hidden)
    for k in range(2, d):
        h = ff.factored_dense(prep, k, h)
        assert h.dtype == F32
    if d == 1:
        y = ff.factored_dense(prep, 2, h, C)
        yb = ff.factored_dense(prep, 2, h, C, BF16)
    else:
        y = ff.factored_rows_tail(prep, h, C)
        yb = ff.factored_rows_tail(prep, h, C, BF16)
    assert y.dtype == F32 and torch.equal(yb, y.to(BF16))
    ref = mlp._factored_all_pairs(CFG, tcfg, tp, tb, x)
    _close(y.view(ref.shape).numpy(), ref.numpy(), 1e-5)
    _close(ff.fused_factored_planes(CFG, tcfg, prep, x).numpy(),
           ref.numpy(), 1e-5)


# ----------------------------------------------------------------------
# the float32 tail's arithmetic
# ----------------------------------------------------------------------

def _tf32x3(a, b, terms, kstep=32):
    """a @ b as the float32 mode takes it: per k-step of `kstep`, the
    products of the TF32 parts in `terms` ((a part, b part), 0 high, 1
    low) summed exactly (float64), rounded to float32 and added to a
    float32 sum."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32)
    for k0 in range(0, a.shape[1], kstep):
        pa = tf32_split(a[:, k0:k0 + kstep]).double()
        pb = tf32_split(b[k0:k0 + kstep]).double()
        acc += sum(pa[i] @ pb[j] for i, j in terms).float()
    return acc


@pytest.mark.parametrize("terms, within", [
    (((0, 0), (0, 1), (1, 0)), True), (((0, 0),), False)])
def test_float32_tail_arithmetic(terms, within):
    """Layers 2 and 3 of the float32 tail (h and W2 split, h2 = relu(.)
    · a + c split again, W3 split): three products a k-step within −110
    dB of float64; one TF32 pass (high parts only) not within −80."""
    rng = np.random.default_rng(12)
    h = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((256, 128)) / 16)
                          .astype(np.float32))
    w3 = torch.from_numpy((rng.standard_normal((128, 256)) / 11)
                          .astype(np.float32))
    a2 = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    c2 = torch.from_numpy(rng.normal(0, 0.1, 128).astype(np.float32))
    ref = ((torch.relu(h.double() @ w2.double()) * a2.double() + c2.double())
           @ w3.double())
    h2 = torch.relu(_tf32x3(h, w2, terms)) * a2 + c2
    db = _db(_tf32x3(h2, w3, terms).numpy(), ref.numpy())
    assert (db < -110.0) if within else (db > -80.0), db


# ----------------------------------------------------------------------
# the CUDA branches: which launch each weight dtype reaches
# ----------------------------------------------------------------------

@pytest.fixture
def launches(monkeypatch):
    """The wrappers' device test answers CUDA, the stream is 0, and every
    library is a recording _Lib: returns the list of recorded launches."""
    calls = []
    for mod in (ff, mi):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    # layer 1's split plan reads the card's SMs: an H100's 132
    monkeypatch.setattr(ff, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    return calls


def _prep(dtype, hidden):
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(2), CFG, tcfg)
    return tcfg, ff.prepare_factored_weights(CFG, tcfg, tp, tb,
                                             dot_dtype=dtype)


def _ff_calls(prep, dtype, out):
    """Each factored wrapper's call on rows of dtype: (call, launch
    function, index of the rows' pointer or None, index of the weight's
    pointer, the weight's key, index of the mode). Float32 launches take
    the K-major weights' TF32 parts (the ``_tf32`` keys)."""
    h1 = prep["w1"].shape[2]
    sfx = "_tf32" if dtype == F32 else ""
    x = torch.zeros((2, 3, CFG.len_ltf), dtype=dtype)
    sp = torch.zeros((2, 3, h1))
    rows = torch.zeros((2, 3 * CFG.num_tx, h1), dtype=dtype)
    d = ff.factored_depth(prep)
    calls = {
        "sig_proj": (lambda: ff.factored_sig_proj(x, prep["w1"],
                                                  prep["w1t" + sfx]),
                     "factored_sig_proj_launch", 0, 1, "w1t" + sfx, 6, x),
        "heads": (lambda: ff.factored_heads(prep, sp),
                  "factored_heads_launch", None, None, None, 8, None),
    }
    if d == 1:
        calls["dense out"] = (lambda: ff.factored_dense(prep, 2, rows, C,
                                                        out),
                              "factored_dense_launch", 0, 1, "w2t" + sfx, 12,
                              rows)
    else:
        calls["dense"] = (lambda: ff.factored_dense(prep, 2, rows),
                          "factored_dense_launch", 0, 1, "w2t" + sfx, 12,
                          rows)
        # bf16 rows take the two-GEMM launch (its workspace before M)
        rt, rt_mode = (("factored_rows_tail_launch", 13) if dtype == F32
                       else ("factored_rows_gemms_launch", 14))
        calls["rows_tail"] = (lambda: ff.factored_rows_tail(
            prep, rows[:, :, :prep[f"w{d}"].shape[1]], C, out),
            rt, 0, 1, f"w{d}t" + sfx, rt_mode, None)
    return calls


@pytest.mark.parametrize("out", [F32, BF16])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hidden", [(128,), (128, 128, 128)])
def test_cuda_branch_factored_mode_follows_the_weights(launches, hidden,
                                                        dtype, out):
    """Float32 weights reach each launch with mode bit 1 (float32
    operands), the rows themselves and the K-major weights' TF32 parts
    as prepared (the same data_ptr: no copy, no bf16 cast, no split in
    the call); bf16 weights the bf16 launch; the
    output layer's out_dtype=bfloat16 sets bit 0; every launch counted,
    the float32 ones apart."""
    _, prep = _prep(dtype, hidden)
    for name, (call, fn, xi, wi, wkey, mi_, x) in _ff_calls(
            prep, dtype, out).items():
        wrapper = getattr(ff, {"sig_proj": "factored_sig_proj",
                               "heads": "factored_heads",
                               "dense": "factored_dense",
                               "dense out": "factored_dense",
                               "rows_tail": "factored_rows_tail"}[name])
        before = (wrapper.launches, wrapper.launches_f32)
        launches.clear()
        got = call()
        (lib, f, args), = launches
        assert (lib, f) == ("fused_factored", fn), name
        if x is not None:
            assert args[xi] == x.data_ptr(), name
        if wkey is not None:
            assert args[wi] == prep[wkey].data_ptr(), name
        out_bit = name in ("dense out", "rows_tail") and out == BF16
        assert args[mi_] == 2 * (dtype == F32) + out_bit, name
        if name in ("heads", "dense"):
            assert got.dtype == dtype, name
        assert (wrapper.launches, wrapper.launches_f32) == (
            before[0] + 1, before[1] + (dtype == F32)), name


def test_cuda_branch_fused_planes_route_float32_through_the_rows(launches):
    """Depth 2 at 128 units: bf16 weights run the fused tail (with the
    bf16 store bit for out_dtype=bfloat16), float32 weights the per-head
    rows and the rows tail, never the fused tail."""
    x = torch.zeros((2, 3, CFG.len_ltf))
    for dtype, want in ((BF16, ["factored_sig_proj_launch",
                                "factored_tail_launch"]),
                        (F32, ["factored_sig_proj_launch",
                               "factored_heads_launch",
                               "factored_rows_tail_launch"])):
        tcfg, prep = _prep(dtype, (128, 128))
        launches.clear()
        ff.fused_factored_planes(CFG, tcfg, prep, x.to(dtype),
                                 out_dtype=BF16)
        assert [f for _, f, _ in launches] == want
        assert launches[-1][2][-2] == 1 + 2 * (dtype == F32)
    # the all-pairs form passes float32 planes on as they are
    launches.clear()
    rx = x.reshape(2, 3, 1, -1)
    ff.predict_all_pairs_planes_kernel(CFG, tcfg, prep, rx)
    assert launches[0][2][0] == rx.data_ptr()


def test_cuda_branch_refuses_mixed_trees(launches):
    """A float32 tree with bf16 rows or input, a bf16 tree with float32
    input, a tree of two dtypes, a float32 fused tail, or a dot_dtype
    other than the tree's: TypeError before any launch."""
    tcfg, p32 = _prep(F32, (128, 128))
    _, p16 = _prep(BF16, (128, 128))
    x = torch.zeros((2, 3, CFG.len_ltf))
    rows16 = torch.zeros((2, 24, 128), dtype=BF16)
    with pytest.raises(TypeError, match="dtype"):
        ff.factored_sig_proj(x.to(BF16), p32["w1"], p32["w1t_tf32"])
    with pytest.raises(TypeError, match="dtype"):
        ff.factored_sig_proj(x, p16["w1"], p16["w1t"])
    with pytest.raises(TypeError, match="one dtype"):
        ff.factored_rows_tail(p32, rows16, C)
    with pytest.raises(TypeError, match="one dtype"):
        ff.factored_rows_tail({**p32, "w3": p16["w3"]}, rows16.float(), C)
    with pytest.raises(TypeError, match="weights' dtype"):
        ff.factored_dense(p32, 2, rows16)
    with pytest.raises(TypeError, match="bf16 weights"):
        ff.factored_tail(p32, torch.zeros((2, 3, 128)), C)
    with pytest.raises(ValueError, match=r"prepared\['w2t_tf32'\].*float32"):
        ff.factored_rows_tail({**p32, "w2t_tf32": p16["w2t"]},
                              rows16.float(), C)
    mtcfg = TrainConfig(hidden=(128, 128))
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(2), CFG, mtcfg)
    m32 = mlp.plane(mi.prepare_mlp_infer_weights(mtcfg, tp, tb, F32), 0)
    m16 = mlp.plane(mi.prepare_mlp_infer_weights(mtcfg, tp, tb), 0)
    xm = torch.from_numpy(_x(4, 1))
    with pytest.raises(TypeError, match="float32 x"):
        mi.mlp_infer_layer1(m32, xm.to(BF16))
    with pytest.raises(TypeError, match="bf16 or of float32"):
        mi.mlp_infer_layer1({**m32, "w2": m16["w2"]}, xm)
    with pytest.raises(TypeError, match="h1 of the weights"):
        mi.mlp_infer_tail(m32, torch.zeros((4, 128), dtype=BF16))
    with pytest.raises(TypeError, match="differs from the prepared"):
        mi.mlp_infer_pallas(mtcfg, m16, None, xm, dot_dtype=F32)
    assert not launches


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_branch_mlp_mode_follows_the_tree(launches, dtype):
    """mlp_infer_layer1 and mlp_infer_tail launch mode 2 on a float32
    tree, the float32 x and the TF32 parts of the tree's w1t, w2t, w3t
    as prepared (w1t_tf32, w2t_tf32, w3t_tf32); mode 0 on a bf16 tree
    with its w1t, w2t, w3t; each counted, the float32 ones apart."""
    tcfg = TrainConfig(hidden=(128, 128))
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(2), CFG, tcfg)
    p = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb, dtype), 0)
    x = torch.from_numpy(_x(4, 2))
    before = mi.mlp_infer_layer1.launches_f32, mi.mlp_infer_tail.launches_f32
    h1 = mi.mlp_infer_layer1(p, x)
    mi.mlp_infer_tail(p, h1)
    (_, f1, a1), (_, f2, a2) = launches
    assert (f1, f2) == ("mlp_layer1_launch", "mlp_tail_launch")
    sfx = "_tf32" if dtype == F32 else ""
    assert h1.dtype == dtype and a1[1] == p["w1t" + sfx].data_ptr()
    assert a2[0] == h1.data_ptr() and a2[1] == p["w2t" + sfx].data_ptr()
    assert a2[5] == p["w3t" + sfx].data_ptr()
    assert (a1[0] == x.data_ptr()) == (dtype == F32)
    assert a1[-2] == a2[-2] == 2 * (dtype == F32)
    n = int(dtype == F32)
    assert (mi.mlp_infer_layer1.launches_f32,
            mi.mlp_infer_tail.launches_f32) == (before[0] + n, before[1] + n)


@pytest.mark.parametrize("lib, src, fns", [
    (ff._ff_lib, "fused_factored.cu",
     ("factored_sig_proj_launch", "factored_tail_launch",
      "factored_heads_launch", "factored_dense_launch",
      "factored_rows_tail_launch")),
    (mi._mlp_lib, "mlp_infer.cu", ("mlp_layer1_launch", "mlp_tail_launch"))])
def test_bindings_match_the_c_signatures(monkeypatch, lib, src, fns):
    """Each launch function gets as many arguments as its source
    declares."""
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, []))
    text = (Path(ff.__file__).resolve().parents[2] / "csrc" / src).read_text()
    bound = lib()
    for fn in fns:
        m = re.search(rf"int {fn}\(([^)]*)\)", text)
        assert len(getattr(bound, fn).argtypes) == len(m.group(1).split(",")
                                                       ), fn
