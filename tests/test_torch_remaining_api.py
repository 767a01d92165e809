"""The last pieces of the JAX package's API in the port, against JAX on
the CPU at Nt 8, Nr 2, hidden (64, 64):

* kernel 5's hidden widths (ops/kernels/mlp_infer.py): the prepared
  weights zero-padded to the kernels' 128-wide tile, exact through ReLU,
  and accepted by the CUDA branch's checks (shown without a card: the
  wrapper's device test answers CUDA and the library load is replaced by
  a stub that stops the call just before the launch);
* models/mlp.py::predict_all_pairs_rxmajor and the ``dtype=`` option of
  sharded_predict_all_pairs and sharded_estimate_combined (float32 to
  2e-4 relative, bf16 to 1e-2: both packages round the same operands);
* utils/numerics.py::put_complex / get_complex (bit-equal to JAX's,
  the bf16 fetch included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.pallas import mlp_infer as jmi
from mamimo_tpu.parallel import mesh as jmesh
from mamimo_tpu.parallel import sharded as jsh
from mamimo_tpu.utils import numerics as jnum
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh
from mamimo_tpu_torch.utils import numerics


def _model(jcfg, hidden, seed=3):
    """JAX and port weights with non-trivial BN statistics and biases."""
    jtcfg = JTrainConfig(hidden=hidden)
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), jcfg, jtcfg))
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    return (TrainConfig(hidden=hidden), jtcfg, (jp, jb),
            mlp.params_from_jax(jp, jb))


@pytest.fixture(scope="module")
def cfgs(small_cfg):
    return SimConfig(**dataclasses.asdict(small_cfg)), small_cfg


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _x(cfg, rows, seed):
    return torch.from_numpy((0.5 * np.random.default_rng(seed).standard_normal(
        (rows, cfg.len_ltf + cfg.num_tx))).astype(np.float32))


# ---- kernel 5's hidden widths -------------------------------------------

@pytest.mark.parametrize("hidden", [(64, 64), (64, 96), (200, 40)])
def test_prepared_weights_pad_hidden_widths_to_the_kernel_tile(cfgs, hidden):
    """Both hidden widths are zero-padded to one multiple of 128 (weights,
    biases and BN affines: scale 0, shift 0); the padded units stay 0, so
    the prepared tree's plain version equals the unpadded float32 chain
    and JAX's kernel in interpret mode (bf16)."""
    cfg, jcfg = cfgs
    tcfg, jtcfg, (jp, jb), (tp, tb) = _model(jcfg, hidden)
    prep = mi.prepare_mlp_infer_weights(tcfg, tp, tb)
    h1, h2 = hidden
    H = -(-max(h1, h2) // 128) * 128
    kp = prep["w1"].shape[1]
    assert tuple(prep["w1"].shape) == (2, kp, H)
    assert tuple(prep["w1t"].shape) == (2, H, kp)
    assert tuple(prep["w2"].shape) == (2, H, H)
    assert tuple(prep["w2t"].shape) == (2, H, H)
    assert tuple(prep["w3"].shape) == (2, H, 256)
    assert tuple(prep["w3t"].shape) == (2, 256, H)
    for k in ("b1", "s1", "t1"):
        assert prep[k].shape[-1] == H and not bool(prep[k][:, h1:].any())
    for k in ("b2", "s2", "t2"):
        assert prep[k].shape[-1] == H and not bool(prep[k][:, h2:].any())
    assert not bool(prep["w1"][:, :, h1:].any())
    assert not bool(prep["w2"][:, h1:].any())
    assert not bool(prep["w2"][:, :, h2:].any())
    assert not bool(prep["w3"][:, h2:].any())
    x = _x(cfg, 16, 4)
    for d in range(2):
        p_d = mlp.plane(prep, d)
        h = mi.mlp_infer_layer1(p_d, x)
        assert tuple(h.shape) == (16, H) and not bool(h[:, h1:].any())
        got = mi.mlp_infer_pallas(tcfg, p_d, None, x)
        # float32 products on the padded tree: the unpadded chain
        f32 = mi.mlp_infer_pallas(tcfg, mlp.plane(tp, d), mlp.plane(tb, d),
                                  x, dot_dtype=torch.float32)
        ref32 = mlp.csi_mlp_apply(tcfg, mlp.plane(tp, d), mlp.plane(tb, d),
                                  x)[0]
        assert _rel(f32.numpy(), ref32.numpy()) < 1e-6
        ref = jmi.mlp_infer_pallas(
            jtcfg, *jax.tree.map(lambda a: a[d], (jp, jb)), jnp.asarray(
                x.numpy()), block_b=16, block_k=1024,
            dot_dtype=jnp.bfloat16, interpret=True)
        assert _rel(got.numpy(), ref) < 1e-2


class _Launch(Exception):
    """Raised by the stub library: the call got past every check."""


def test_padded_widths_pass_the_kernel_checks(cfgs, monkeypatch):
    """The CUDA branch of both wrappers takes the padded hidden-64 tree
    (it refused H1 = 64 before the weights were padded) and a hidden
    layer wider than 1024 (whose h1 the tail streams), and refuses rows
    that do not match the tree's width, naming the shapes."""
    cfg, jcfg = cfgs
    tcfg, _, _, (tp, tb) = _model(jcfg, (64, 64))
    prep = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), 0)
    monkeypatch.setattr(mi, "on_cuda", lambda *t: True)

    def stub():
        raise _Launch

    monkeypatch.setattr(mi, "_mlp_lib", stub)
    x = _x(cfg, 5, 1)
    with pytest.raises(_Launch):
        mi.mlp_infer_layer1(prep, x)
    with pytest.raises(_Launch):
        mi.mlp_infer_tail(prep, torch.zeros((5, 128), dtype=torch.bfloat16))
    wide_tcfg, _, _, (wp, wb) = _model(jcfg, (1100, 64))
    wide = mlp.plane(mi.prepare_mlp_infer_weights(wide_tcfg, wp, wb), 0)
    with pytest.raises(_Launch):
        mi.mlp_infer_tail(wide, torch.zeros((5, 1152), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"H1=1024, w2 \(1152, 1152\)"):
        mi.mlp_infer_tail(wide, torch.zeros((5, 1024), dtype=torch.bfloat16))


# ---- rx-major all pairs and the dtype options ----------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_predict_all_pairs_rxmajor_matches_jax(cfgs, dtype):
    cfg, jcfg = cfgs
    tcfg, jtcfg, (jp, jb), (tp, tb) = _model(jcfg, (64, 64))
    rng = np.random.default_rng(5)
    shape = (3, cfg.num_rx, cfg.len_ltf)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = jmlp.predict_all_pairs_rxmajor(
        jcfg, jtcfg, jp, jb, jnp.asarray(rx),
        dtype=getattr(jnp, dtype) if dtype else None)
    got = mlp.predict_all_pairs_rxmajor(
        cfg, tcfg, tp, tb, torch.from_numpy(rx),
        dtype=getattr(torch, dtype) if dtype else None)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (3, cfg.num_rx, cfg.num_tx, cfg.num_carriers)
    assert _rel(got.numpy(), ref) < (1e-2 if dtype else 2e-4)
    # the time-major layout, permuted
    tm = mlp.predict_all_pairs(cfg, tcfg, tp, tb,
                               torch.from_numpy(rx).transpose(1, 2),
                               dtype=getattr(torch, dtype) if dtype else None)
    torch.testing.assert_close(got.permute(0, 3, 2, 1), tm, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["predict_all_pairs", "estimate_combined"])
def test_sharded_inference_dtype_matches_jax(cfgs, form):
    """dtype=bfloat16 in sharded_predict_all_pairs (antenna 4) and in
    sharded_estimate_combined (data 2 x seq 2 x antenna 2) against JAX's
    (the float32 forms: tests/test_torch_parallel.py)."""
    cfg, jcfg = cfgs
    tcfg, jtcfg, (jp, jb), (tp, tb) = _model(jcfg, (64, 64))
    rng = np.random.default_rng(6)
    shape = (2, cfg.len_ltf, cfg.num_rx)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    if form == "predict_all_pairs":
        ref = jsh.sharded_predict_all_pairs(
            jcfg, jtcfg, jmesh.make_mesh({"antenna": 4},
                                         devices=jax.devices()[:4]),
            jp, jb, jnp.asarray(rx), dtype=jnp.bfloat16)
        got = sharded.sharded_predict_all_pairs(
            cfg, tcfg, make_mesh({"antenna": 4}, devices=["cpu"] * 4), tp,
            tb, torch.from_numpy(rx), dtype=torch.bfloat16)
        assert _rel(got.numpy(), np.asarray(ref)) < 1e-2
        return
    axes = {"data": 2, "seq": 2, "antenna": 2}
    jl, jdnn = jsh.sharded_estimate_combined(
        jcfg, jtcfg, jmesh.make_mesh(axes), jp, jb, jnp.asarray(rx),
        dtype=jnp.bfloat16)
    tl, tdnn = sharded.sharded_estimate_combined(
        cfg, tcfg, make_mesh(axes, devices=["cpu"] * 8), tp, tb,
        torch.from_numpy(rx), dtype=torch.bfloat16)
    assert _rel(tl.numpy(), np.asarray(jl)) < 2e-4
    assert _rel(tdnn.numpy(), np.asarray(jdnn)) < 1e-2


# ---- put_complex / get_complex ------------------------------------------

def test_get_complex_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 128))
         + 1j * rng.standard_normal((64, 128))).astype(np.complex64)
    t = numerics.put_complex(x, "cpu")
    assert t.dtype == torch.complex64
    np.testing.assert_array_equal(numerics.get_complex(t), x)
    jq = jnum.get_complex(jnum.put_complex(x), fetch_dtype=jnp.bfloat16)
    q = numerics.get_complex(t, fetch_dtype=torch.bfloat16)
    assert q.dtype == np.complex64
    np.testing.assert_array_equal(q, jq)
    err = np.mean(np.abs(q - x) ** 2) / np.mean(np.abs(x) ** 2)
    assert 10 * np.log10(err) < -45.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            numerics.put_complex(x)
