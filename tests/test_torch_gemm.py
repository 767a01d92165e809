"""The layer-1 GEMMs' operands and plain versions (the port's
ops.kernels.fused_factored::factored_sig_proj and
ops.kernels.mlp_infer::mlp_infer_layer1), and float32 planes through the
LS kernel's wrappers, on the CPU.

The CUDA kernels (csrc/gemm_sm90.cuh) read W1 K-major from the prepared
``w1t``; here it is held to JAX's layer-1 weights through
params_from_jax. The wrappers' plain versions are held to float64
products of the same bf16-valued operands at the shapes the kernels treat
as edges: a ragged row count (1 row, rows past a 128-row tile) and a K
that is not a multiple of the kernels' 64-wide k-step. Tolerances: a
relative 1e-5 for float32 sums of bf16-valued products (float32 rounding
over a few thousand terms), one bf16 rounding step (2^-8 relative) where
the output is bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.pallas import mlp_infer as jmi
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import fused_ls
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.util import tf32_split
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh

CFG = SimConfig(num_tx=8, num_rx=2)
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def model(small_cfg):
    """JAX and port parameters of one stacked model (hidden 128/128)."""
    jtcfg = JTrainConfig(hidden=(128, 128))
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(11), small_cfg, jtcfg))
    tcfg = TrainConfig(hidden=(128, 128))
    return tcfg, jtcfg, (jp, jb), mlp.params_from_jax(jp, jb)


def _bf16_np(a) -> np.ndarray:
    """a rounded to bf16 values, as float64."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF16).double() \
        .numpy()


@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_factored_w1t_is_the_transpose_of_jax_layer1(model, dot_dtype):
    """The layer-1 kernel's K-major W1: w1t in a bf16 tree; in a float32
    tree its TF32 parts, w1t_tf32, in its place."""
    tcfg, _, (jp, _), (tp, tb) = model
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=dot_dtype)
    L = CFG.len_ltf
    f32 = dot_dtype == torch.float32
    key = "w1t_tf32" if f32 else "w1t"
    kmajor = tf32_split if f32 else (lambda t: t)
    assert f32 != ("w1t" in prep)
    assert prep[key].dtype == dot_dtype and prep[key].is_contiguous()
    for d in range(2):
        want = torch.from_numpy(np.ascontiguousarray(
            jp["dense"][0]["w"][d][:L].T)).to(dot_dtype)
        assert torch.equal(prep[key][d], kmajor(want))
        assert torch.equal(prep[key][d], kmajor(prep["w1"][d].T))


def test_mlp_w1t_is_the_transpose_of_jax_layer1(model):
    tcfg, _, (jp, jb), (tp, tb) = model
    prep = mi.prepare_mlp_infer_weights(tcfg, tp, tb)
    k = CFG.len_ltf + CFG.num_tx
    kp = prep["w1"].shape[1]
    assert tuple(prep["w1t"].shape) == (2, 128, kp) and kp == 2592
    for d in range(2):
        want = torch.from_numpy(np.ascontiguousarray(
            jp["dense"][0]["w"][d].T)).to(BF16)
        assert torch.equal(prep["w1t"][d, :, :k], want)
        assert not bool(prep["w1t"][d, :, k:].any())
        assert torch.equal(mlp.plane(prep, d)["w1t"], prep["w1"][d].T)


@pytest.mark.parametrize("s, L", [(1, 2560), (13, 2536), (131, 2504)])
def test_sig_proj_plain_at_the_kernel_edges(s, L):
    """1 row, a 13-row tile and rows past one 128-row tile; L % 64 != 0
    for the last two (2536 = 39.6 k-steps, 2504 = 39.1)."""
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((2, s, L)).astype(np.float32))
    w = torch.from_numpy(
        0.02 * rng.standard_normal((2, L, 128)).astype(np.float32))
    x16, w16 = x.to(BF16), w.to(BF16)
    got = ff.factored_sig_proj(x16, w16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, 128)
    ref = np.einsum("psl,plh->psh", _bf16_np(x), _bf16_np(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _layer1_tree(rng, k, h1=128):
    """One plane's layer-1 tensors with w1 zero past row k."""
    kp = -(-k // 32) * 32
    w1 = np.zeros((kp, h1), np.float32)
    w1[:k] = 0.02 * rng.standard_normal((k, h1))
    w1 = torch.from_numpy(w1).to(BF16)
    f = lambda a: torch.from_numpy(a.astype(np.float32))    # noqa: E731
    return {"w1": w1, "w1t": w1.T.contiguous(),
            "b1": f(0.1 * rng.standard_normal(h1)),
            "s1": f(0.5 + rng.random(h1)),
            "t1": f(0.1 * rng.standard_normal(h1))}


@pytest.mark.parametrize("m, k", [(1, 2568), (37, 2544), (133, 2528)])
def test_layer1_plain_at_the_kernel_edges(m, k):
    """1 row and rows past one 128-row tile; K % 64 = 8, 48, 32."""
    rng = np.random.default_rng(m)
    p = _layer1_tree(rng, k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    got = mi.mlp_infer_layer1(p, x)
    assert got.dtype == BF16 and tuple(got.shape) == (m, 128)
    h = _bf16_np(x) @ p["w1"][:k].double().numpy() + p["b1"].double().numpy()
    ref = np.maximum(h, 0) * p["s1"].double().numpy() \
        + p["t1"].double().numpy()
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)


def test_mlp_infer_one_row_matches_jax(model):
    """A batch of one row through the port (prepared tree) and the JAX
    kernel in interpret mode."""
    tcfg, jtcfg, (jp, jb), (tp, tb) = model
    x = (0.5 * np.random.default_rng(5).standard_normal(
        (1, CFG.len_ltf + CFG.num_tx))).astype(np.float32)
    jplane = jax.tree.map(lambda a: a[0], (jp, jb))
    ref = jmi.mlp_infer_pallas(jtcfg, *jplane, jnp.asarray(x), block_b=8,
                               block_k=256, dot_dtype=jnp.bfloat16,
                               interpret=True)
    prep = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), 0)
    got = mi.mlp_infer_pallas(tcfg, prep, None, torch.from_numpy(x))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 1e-2


@pytest.mark.parametrize("w1t_rows, L, match", [
    (256, 2560, r"w1t \(2, 128, 2560\)"), (None, 2560, "needs w1t"),
    (None, 2556, "L % 8")])
def test_sig_proj_kernel_branch_refuses_bad_operands(monkeypatch, w1t_rows,
                                                     L, match):
    """The CUDA branch's checks run before any launch (shown without a
    card: the wrapper's device test is made to answer CUDA): a w1t of the
    wrong shape, a missing w1t, L % 8 != 0."""
    monkeypatch.setattr(ff, "on_cuda", lambda *t: True)
    x = torch.zeros((2, 3, L), dtype=BF16)
    w1 = torch.zeros((2, L, 128), dtype=BF16)
    w1t = None if w1t_rows is None else torch.zeros((2, w1t_rows, L),
                                                    dtype=BF16)
    with pytest.raises(ValueError, match=match):
        ff.factored_sig_proj(x, w1, w1t)


def _planes(s, seed):
    """float32 planes holding bf16 values."""
    x = np.random.default_rng(seed).standard_normal((2, s, CFG.len_ltf))
    return torch.from_numpy(x.astype(np.float32)).to(BF16).float()


@pytest.mark.parametrize("mode", [None, "seq", "data"])
def test_ls_float32_planes_give_the_bf16_answer(mode):
    """float32 planes through ls_planes_v2 and sharded_ls_pallas_v2 give
    the answer of the same values as bf16. This holds the plain versions'
    dtype handling; on the kernel branch float32 planes keep their dtype
    (test_ls_kernel_branch_casts_float32_planes)."""
    x32 = _planes(4, seed=9)
    if mode is None:
        f = lambda x: fused_ls.ls_planes_v2(CFG, x)          # noqa: E731
    else:
        mesh = make_mesh({mode: 2}, devices=["cpu"] * 2)
        f = lambda x: sharded.sharded_ls_pallas_v2(          # noqa: E731
            CFG, mesh, x, mode=mode)
    got32, got16 = f(x32), f(x32.to(BF16))
    assert got32.dtype == got16.dtype
    assert torch.equal(got32, got16)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("mode", [None, "seq", "data"])
def test_ls_kernel_branch_casts_float32_planes(monkeypatch, mode):
    """On the kernel branch (the wrapper's device test made to answer
    CUDA, the launch cut off at the operand check) float32 planes reach
    the kernel as they are, float32 (its float32 mode; no cast to
    bfloat16, as JAX's kernel computes float32 planes in float32), with
    the float32 constants; the first rank's share where the call is
    sharded."""
    seen = []

    seen_consts = []

    def check_then_stop(cfg, planes, bmat, nsym_in=None):
        real_check(cfg, planes, bmat, nsym_in)
        seen.append(planes)
        seen_consts.append(bmat.bt)
        raise _Stop

    real_check = fused_ls._check_kernel_shapes
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fused_ls, "_check_kernel_shapes", check_then_stop)
    x32 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, CFG.len_ltf)).astype(np.float32))
    want = x32
    if mode is None:
        call = lambda: fused_ls.ls_planes_v2(CFG, x32)       # noqa: E731
    else:
        mesh = make_mesh({mode: 2}, devices=["cpu"] * 2)
        call = lambda: sharded.sharded_ls_pallas_v2(         # noqa: E731
            CFG, mesh, x32, mode=mode)
        want = want[:, :2] if mode == "data" \
            else want[:, :, :CFG.len_ltf // 2]
    with pytest.raises(_Stop):
        call()
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    assert torch.equal(seen[0], want)
    assert seen_consts[0].dtype == torch.float32
