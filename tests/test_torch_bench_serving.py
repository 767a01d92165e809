"""The bench slice of the port on the CPU: kernel 1's bf16 store and
per-tile sums of h² (``ls_planes_v2(out_dtype=bfloat16, with_ssq=True)``,
plain version), the ``dtype=`` options of ``ls_estimate_planes`` and of
the factored DNN functions, the estimation functions of
``mamimo_tpu_torch/bench.py`` and ``mamimo_tpu_torch/entry.py``, each
against the JAX package's blocks of the same path.

Inputs are made with numpy and go to both packages. Tolerances:

- the bf16 LS estimate, densified: ≤ −45 dB against JAX's kernel in
  interpret mode (both round float32 values to bf16 once); its sums of
  h²: column sums within 1e-2 and the total within 1e-3 relative of
  JAX's sums / 8 (JAX broadcasts each block's sums over 8 sublanes);
- float32 products: 1e-4 of the largest value (DNN) and 2e-4 (LS), as
  the other port tests;
- ``ls_estimate_planes(dtype=bfloat16)``: ≤ −80 dB (bf16 operands,
  float32 products on both sides; a result rounded to bf16 would read
  about −50 dB);
- bf16 DNN (``dtype=bfloat16``, or the fused kernels' plain versions):
  ≤ −40 dB (the two frameworks round at other places; bf16 operands cost
  about −48 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops import estimate as jest
from mamimo_tpu.ops.ltf import _hadamard_np as j_hadamard
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_planes_pallas_v2 as j_ls_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu_torch import bench
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.entry import entry
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.estimate import ls_estimate_planes
from mamimo_tpu_torch.ops.kernels import fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import ls_planes_v2, ls_v2_tiles

BF16 = torch.bfloat16
S = 11


def _db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    with np.errstate(divide="ignore"):          # an exact match is -inf
        return 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                             / np.sum(np.abs(ref) ** 2))


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _complex(h2):
    """(2, ...) planes (any float dtype) as a complex numpy array."""
    h2 = h2.float().numpy()
    return h2[0] + 1j * h2[1]


def _j_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def case(small_cfg, tcfg):
    """The port's and JAX's configurations, a model with non-trivial BN
    statistics in both packages, and S samples of float32 planes."""
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(13), small_cfg, tcfg))
    rng = np.random.default_rng(13)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    cfg = SimConfig.from_json(small_cfg.to_json())
    port_tcfg = TrainConfig.from_json(tcfg.to_json())
    planes = f32(rng.standard_normal((2, S, cfg.len_ltf)))
    return {"cfg": cfg, "tcfg": port_tcfg, "jcfg": small_cfg, "jtcfg": tcfg,
            "jax": (jp, jb), "port": mlp.params_from_jax(jp, jb),
            "planes": planes}


# ----------------------------------------------------------------------
# kernel 1: the bf16 store and the per-tile sums of h²
# ----------------------------------------------------------------------

def _j_v2_ssq(jcfg, x, seq=None, block_samples=4):
    """JAX's v2 kernel in interpret mode with the bf16 store and fused
    Σh²: (densified (S, nt, C) complex, ssq (n_blocks, 8, 2·Cp))."""
    consts = None
    if seq is not None:
        i, n = seq
        loc = jcfg.num_tx // n
        b, _ = j_v2_constants(jcfg, block_samples)
        p = j_hadamard(jcfg.num_tx).astype(np.float32)[:, i * loc:
                                                       (i + 1) * loc]
        consts = (b, jnp.asarray(np.kron(np.eye(block_samples,
                                                dtype=np.float32), p)))
    h, ssq = j_ls_v2(jcfg, jnp.asarray(x), consts,
                     block_samples=block_samples, interpret=True,
                     with_ssq=True, out_dtype=jnp.bfloat16)
    assert h.dtype == jnp.bfloat16
    h = j_v2_to_complex(jcfg, h.astype(jnp.float32), x.shape[1])
    return np.asarray(h), np.asarray(ssq)


@pytest.mark.parametrize("seq", [None, (0, 2), (1, 2)])
def test_v2_bf16_and_ssq_match_jax(case, seq):
    """Full mode and seq rank i of 2: the densified bf16 estimate, the
    sums' column sums and their total against JAX's kernel."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    loc = cfg.num_tx if seq is None else cfg.num_tx // seq[1]
    x = np.ascontiguousarray(case["planes"][:, :, :loc * cfg.sym_len])
    h, ssq = ls_planes_v2(cfg, torch.from_numpy(x), seq_shard=seq,
                          out_dtype=BF16, with_ssq=True)
    assert h.dtype == BF16
    assert tuple(h.shape) == (2, S, cfg.num_tx, cfg.num_carriers)
    assert ssq.dtype == torch.float32
    assert tuple(ssq.shape) == (ls_v2_tiles(S, loc), 2, cfg.num_carriers)
    ref_h, ref_ssq = _j_v2_ssq(jcfg, x, seq)
    assert _db(_complex(h), ref_h) <= -45.0
    cp_ = ref_ssq.shape[2] // 2
    cols = ref_ssq.sum((0, 1)) / 8.0
    ref_cols = np.stack([cols[:cfg.num_carriers],
                         cols[cp_:cp_ + cfg.num_carriers]])
    np.testing.assert_allclose(ssq.sum(0).numpy(), ref_cols, rtol=1e-2)
    np.testing.assert_allclose(float(ssq.double().sum()),
                               float(ref_ssq.astype(np.float64).sum()) / 8.0,
                               rtol=1e-3)


def test_v2_ssq_rows_are_per_tile_sums():
    """BS32, S = 5: 4 samples a tile, so 2 tiles, the second holding
    sample 4 and 3 pad samples. Row t is the column sums of h² over tile
    t's samples; a tile whose samples are zero has a zero row (pad
    samples add nothing)."""
    cfg = SimConfig()
    x = np.random.default_rng(3).standard_normal(
        (2, 5, cfg.len_ltf)).astype(np.float32)
    x[:, 4] = 0.0
    h, ssq = ls_planes_v2(cfg, torch.from_numpy(x), with_ssq=True)
    assert tuple(ssq.shape) == (2, 2, cfg.num_carriers)
    assert ls_v2_tiles(5, cfg.num_tx) == 2
    want = (h[:, :4] ** 2).sum((1, 2)).numpy()           # (2, C)
    np.testing.assert_allclose(ssq[0].numpy(), want, rtol=1e-5)
    assert torch.equal(ssq[1], torch.zeros_like(ssq[1]))


@pytest.mark.parametrize("seq", [None, (3, 4)])
def test_v2_bf16_store_is_the_rounded_float32(case, seq):
    """The bf16 store is the float32 estimate rounded once (to nearest
    even); the sums are the same in both dtypes (taken before the
    rounding), and the default call is unchanged."""
    cfg = case["cfg"]
    loc = cfg.num_tx if seq is None else cfg.num_tx // seq[1]
    x = torch.from_numpy(np.ascontiguousarray(
        case["planes"][:, :, :loc * cfg.sym_len]))
    h32 = ls_planes_v2(cfg, x, seq_shard=seq)
    h32s, ssq32 = ls_planes_v2(cfg, x, seq_shard=seq, with_ssq=True)
    h16, ssq16 = ls_planes_v2(cfg, x, seq_shard=seq, out_dtype=BF16,
                              with_ssq=True)
    assert h32.dtype == torch.float32 and torch.equal(h32, h32s)
    assert torch.equal(h16, h32.to(BF16))
    assert torch.equal(ssq16, ssq32)
    assert torch.equal(ls_planes_v2(cfg, x, seq_shard=seq, out_dtype=BF16),
                       h16)


def test_v2_refuses_other_out_dtypes(case):
    x = torch.from_numpy(case["planes"])
    with pytest.raises(TypeError, match="out_dtype"):
        ls_planes_v2(case["cfg"], x, out_dtype=torch.float16)


class _Stop(Exception):
    pass


def test_v2_kernel_branch_with_ssq(monkeypatch, case):
    """The CUDA branch (device test made to answer CUDA): an empty batch
    returns the empty estimate and sums without a launch; a batch reaches
    the build of the kernel library (cut off here)."""
    cfg = case["cfg"]
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)

    def no_build(name, defines=()):
        raise _Stop(name)

    monkeypatch.setattr(fused_ls._build, "library", no_build)
    before = ls_planes_v2.launches
    h, ssq = ls_planes_v2(cfg, torch.empty((2, 0, cfg.len_ltf), dtype=BF16),
                          out_dtype=BF16, with_ssq=True)
    assert h.dtype == BF16 and tuple(h.shape) == (2, 0, cfg.num_tx,
                                                  cfg.num_carriers)
    assert tuple(ssq.shape) == (0, 2, cfg.num_carriers)
    assert ls_planes_v2.launches == before
    with pytest.raises(_Stop, match="ls_v2"):
        ls_planes_v2(cfg, torch.from_numpy(case["planes"]).to(BF16),
                     out_dtype=BF16, with_ssq=True)


# ----------------------------------------------------------------------
# the dtype= options
# ----------------------------------------------------------------------

def test_ls_estimate_planes_bf16_operands_match_jax(case):
    """bf16 operands, float32 products and result, as JAX's
    preferred_element_type=float32; the default stays float32."""
    cfg, jcfg, x = case["cfg"], case["jcfg"], case["planes"]
    ref = np.asarray(jest.ls_estimate_planes(
        jcfg, jnp.asarray(x), jest.ls_planes_constants(jcfg, jnp.bfloat16),
        dtype=jnp.bfloat16))
    got = ls_estimate_planes(cfg, torch.from_numpy(x), dtype=BF16)
    assert got.dtype == torch.complex64
    assert _db(got.numpy(), ref) <= -80.0
    _close(ls_estimate_planes(cfg, torch.from_numpy(x)).numpy(),
           np.asarray(jest.ls_estimate_planes(jcfg, jnp.asarray(x))), 2e-4)


def _mlp_calls(case, dtype):
    """(port result, JAX result) of each of the six DNN functions with
    ``dtype`` (None or bfloat16) on the same inputs."""
    cfg, jcfg, tcfg, jtcfg = (case["cfg"], case["jcfg"], case["tcfg"],
                              case["jtcfg"])
    (jp, jb), (tp, tb), x = case["jax"], case["port"], case["planes"]
    jdt = None if dtype is None else jnp.bfloat16
    L = cfg.len_ltf
    pil = np.asarray(j_hadamard(cfg.num_tx), np.float32).T.copy()
    jp0, jb0 = jax.tree.map(lambda a: a[0], (jp, jb))
    tp0, tb0 = mlp.plane(tp, 0), mlp.plane(tb, 0)
    sig_proj = x[0] @ jp["dense"][0]["w"][0][:L]
    rxp = x[:, :10].reshape(2, 5, cfg.num_rx, L)
    rx = (x[0, :10] + 1j * x[1, :10]).astype(np.complex64).reshape(
        5, cfg.num_rx, L).transpose(0, 2, 1).copy()
    t = torch.from_numpy
    return {
        "factored_heads_apply": (
            mlp.factored_heads_apply(tcfg, tp0, tb0, t(sig_proj), t(pil), L,
                                     dtype=dtype),
            jmlp.factored_heads_apply(jtcfg, jp0, jb0, jnp.asarray(sig_proj),
                                      jnp.asarray(pil), L, dtype=jdt)),
        "factored_plane_apply": (
            mlp.factored_plane_apply(tcfg, tp0, tb0, t(x[0]), t(pil),
                                     dtype=dtype),
            jmlp.factored_plane_apply(jtcfg, jp0, jb0, jnp.asarray(x[0]),
                                      jnp.asarray(pil), dtype=jdt)),
        "_factored_all_pairs": (
            mlp._factored_all_pairs(cfg, tcfg, tp, tb, t(x), dtype),
            jmlp._factored_all_pairs(jcfg, jtcfg, jp, jb, jnp.asarray(x),
                                     dtype=jdt)),
        "predict_all_pairs_planes_flat": (
            mlp.predict_all_pairs_planes_flat(cfg, tcfg, tp, tb, t(x), dtype),
            jmlp.predict_all_pairs_planes_flat(jcfg, jtcfg, jp, jb,
                                               jnp.asarray(x), dtype=jdt)),
        "predict_all_pairs_planes": (
            mlp.predict_all_pairs_planes(cfg, tcfg, tp, tb, t(rxp), dtype),
            jmlp.predict_all_pairs_planes(jcfg, jtcfg, jp, jb,
                                          jnp.asarray(rxp), dtype=jdt)),
        "predict_all_pairs": (
            mlp.predict_all_pairs(cfg, tcfg, tp, tb, t(rx), dtype),
            jmlp.predict_all_pairs(jcfg, jtcfg, jp, jb, jnp.asarray(rx),
                                   dtype=jdt)),
    }


MLP_FUNCTIONS = ("factored_heads_apply", "factored_plane_apply",
                 "_factored_all_pairs", "predict_all_pairs_planes_flat",
                 "predict_all_pairs_planes", "predict_all_pairs")


@pytest.mark.parametrize("name", MLP_FUNCTIONS)
@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
def test_mlp_dtype_matches_jax(case, name, dtype):
    """Each DNN function: bf16 products and biases with a float32 BN fold
    and a float32 (complex64) output; without dtype, float32 as before."""
    got, ref = _mlp_calls(case, dtype)[name]
    ref = np.asarray(ref)
    assert got.dtype in (torch.float32, torch.complex64)
    assert got.dtype == (torch.complex64 if np.iscomplexobj(ref)
                         else torch.float32)
    if dtype is None:
        _close(got.numpy(), ref, 1e-4)
    else:
        assert _db(got.numpy(), ref) <= -40.0


# ----------------------------------------------------------------------
# the estimation functions of the bench
# ----------------------------------------------------------------------

def test_serving_r3_matches_jax_blocks(case):
    """pallas_ls_v2_serving_r3 on bf16 planes: JAX's blocks are the v2
    kernel with the bf16 store and sums (bf16 constants, as its bench
    makes them) and the bf16 factored DNN cast to bf16."""
    cfg, jcfg, tcfg, jtcfg = (case["cfg"], case["jcfg"], case["tcfg"],
                              case["jtcfg"])
    (jp, jb), (tp, tb) = case["jax"], case["port"]
    x16 = torch.from_numpy(case["planes"]).to(BF16)
    xj = jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16)
    fn = bench.make_estimation_fn_serving_r3(cfg, tcfg, tp, tb,
                                             block_samples=8)
    ssq, y2 = fn(x16)
    _, ref_ssq = j_ls_v2(jcfg, xj, j_v2_constants(jcfg, 8, jnp.bfloat16),
                         block_samples=8, dma_samples=32, interpret=True,
                         with_ssq=True, out_dtype=jnp.bfloat16)
    ref_y2 = jmlp._factored_all_pairs(jcfg, jtcfg, jp, jb, xj,
                                      dtype=jnp.bfloat16).astype(jnp.bfloat16)
    assert y2.dtype == BF16
    assert tuple(y2.shape) == (2, S, cfg.num_tx, cfg.num_carriers)
    assert _db(y2.float().numpy(), _j_f32(ref_y2)) <= -40.0
    assert ssq.dtype == torch.float32
    assert tuple(ssq.shape) == (ls_v2_tiles(S, cfg.num_tx), 2,
                                cfg.num_carriers)
    np.testing.assert_allclose(float(ssq.double().sum()),
                               float(np.asarray(ref_ssq, np.float64).sum())
                               / 8.0, rtol=1e-3)
    with pytest.raises(TypeError, match="bfloat16"):
        fn(x16.float())


def test_pallas_factored_matches_jax_blocks(case):
    """pallas_factored on float32 planes: the float32 planes LS (2e-4)
    and the fused factored DNN (bf16 operands, ≤ −40 dB against the
    float32 factored DNN, as JAX's fused kernel is held)."""
    cfg, jcfg, tcfg, jtcfg = (case["cfg"], case["jcfg"], case["tcfg"],
                              case["jtcfg"])
    (jp, jb), (tp, tb), x = case["jax"], case["port"], case["planes"]
    fn = bench.make_estimation_fn_pallas_factored(cfg, tcfg, tp, tb,
                                                  block_s=64, block_k=512)
    h_ls, h_dnn = fn(torch.from_numpy(x))
    shape = (S, cfg.num_tx, cfg.num_carriers)
    assert h_ls.dtype == h_dnn.dtype == torch.complex64
    assert tuple(h_dnn.shape) == shape
    _close(h_ls.numpy(), np.asarray(jest.ls_estimate_planes(
        jcfg, jnp.asarray(x))), 2e-4)
    ref = np.asarray(jmlp.predict_all_pairs_planes_flat(
        jcfg, jtcfg, jp, jb, jnp.asarray(x)))
    assert _db(h_dnn.numpy(), ref) <= -40.0


@pytest.mark.parametrize("name", ["xla_planes", "xla_planes_bf16",
                                  "xla_planes_bf16_bf16ls",
                                  "xla_planes_bf16in"])
def test_planes_xla_options_match_jax_blocks(case, name):
    """The XLA paths of make_estimation_fn_planes run the plain PyTorch
    forms with the JAX path's dtype=: float32 at 2e-4 / 1e-4, the bf16
    DNN at ≤ −40 dB, the bf16-operand LS at ≤ −80 dB. With bf16 input the
    JAX path pre-casts its LS constants to bf16 where the port keeps
    them float32: ≤ −45 dB there."""
    cfg, jcfg, tcfg, jtcfg = (case["cfg"], case["jcfg"], case["tcfg"],
                              case["jtcfg"])
    (jp, jb), (tp, tb) = case["jax"], case["port"]
    opts = dict(bench.XLA_PATHS.get(name, {"input_bf16": True}))
    bf16_in = opts.get("input_bf16", False)
    x = torch.from_numpy(case["planes"])
    if bf16_in:
        x = x.to(BF16)
    xj = jnp.asarray(x.float().numpy())
    h_ls, h_dnn = bench.make_estimation_fn_planes(cfg, tcfg, tp, tb,
                                                  **opts)(x)
    ls_bf16 = opts.get("ls_bf16", False) or bf16_in
    ldt = jnp.bfloat16 if ls_bf16 else None
    ref_ls = np.asarray(jest.ls_estimate_planes(
        jcfg, xj.astype(ldt) if bf16_in else xj,
        jest.ls_planes_constants(jcfg, ldt),
        dtype=ldt if not bf16_in else None))
    dnn_bf16 = opts.get("use_bf16", False) or bf16_in
    ref_dnn = np.asarray(jmlp.predict_all_pairs_planes_flat(
        jcfg, jtcfg, jp, jb, xj, dtype=jnp.bfloat16 if dnn_bf16 else None))
    assert h_ls.dtype == h_dnn.dtype == torch.complex64
    if bf16_in:
        assert _db(h_ls.numpy(), ref_ls) <= -45.0
    elif ls_bf16:
        assert _db(h_ls.numpy(), ref_ls) <= -80.0
    else:
        _close(h_ls.numpy(), ref_ls, 2e-4)
    if dnn_bf16:
        assert _db(h_dnn.numpy(), ref_dnn) <= -40.0
    else:
        _close(h_dnn.numpy(), ref_dnn, 1e-4)
    with pytest.raises(TypeError, match="bfloat16" if bf16_in else "float32"):
        bench.make_estimation_fn_planes(cfg, tcfg, tp, tb, **opts)(
            x.float() if bf16_in else x.to(BF16))


def test_entry_runs_on_the_cpu():
    """entry(device="cpu"): BS32, 4 packets, bf16 (2, 16, 32, 234)
    estimates; its LS half against JAX's off-TPU entry, the float32
    ls_estimate_planes (bf16 input and output: ≤ −45 dB)."""
    from mamimo_tpu.config import SimConfig as JSimConfig

    fn, (planes,) = entry(device="cpu")
    h_ls, h_dnn = fn(planes)
    jcfg = JSimConfig()
    shape = (2, 4 * jcfg.num_rx, jcfg.num_tx, jcfg.num_carriers)
    assert planes.dtype == torch.float32
    assert tuple(planes.shape) == (2, 4 * jcfg.num_rx, jcfg.len_ltf)
    for h in (h_ls, h_dnn):
        assert h.dtype == BF16 and tuple(h.shape) == shape
        assert bool(torch.isfinite(h.float()).all())
    ref = np.asarray(jest.ls_estimate_planes(jcfg,
                                             jnp.asarray(planes.numpy())))
    assert _db(_complex(h_ls), ref) <= -45.0
