"""The bf16 GEMM walk's operands (kernel 6, ``matmul_pallas``) and the
DNN tails' two-GEMM route above 1024 units (``factored_rows_tail``,
``mlp_infer_tail``), on the CPU.

- ``matmul_pallas`` on bf16 operands, the plain version against JAX's
  ``matmul_pallas`` in interpret mode at ragged M, N and K, for B
  row-major, a transposed view and a strided slice: within 1e-5 of the
  largest value (both take exact bf16 products and add in float32, in
  other orders);
- its CUDA branch with the device test answering CUDA and a library that
  records each launch: the bf16 kernel gets B (K, N) itself (its data
  pointer, mode bit 2) where B is row-major with N % 8 == 0, the K-major
  Bt of a transposed view as it lies, and a copy otherwise (the launch
  of ``csrc/matmul_bf16.cu``); the int8 and float32 kernels still get B
  transposed;
- the ctypes bindings against the C declarations;
- the route functions at their edges (1024 / 1152 units, bf16 and
  float32) and the CUDA branches' launches along each route (H2 = 128,
  C = 234 / 256 taken, 257 refused);
- bf16 ``factored_dense`` on the same GEMM (``csrc/mm_sm90.cuh``'s
  ``rows_gemm_kernel``): its launch's arguments for a hidden layer (bias
  and affine as prepared, N values a plane, at widths that are and are
  not a multiple of the 256-column tile) and for the output layer
  (float32 and bf16 stores), and the C launch function's bf16 branch on
  that kernel;
- the hidden layer's epilogue reads its bias and affine at the layer's
  N columns only (the functor returns before reading at col >= N), so
  ``factored_rows_tail`` at H2 = 640 and ``mlp_infer_tail`` at 1152
  units (H2 % 256 = 128) pass their vectors as prepared, of H2 values a
  plane: every column the epilogue reads, modelled over the 256-column
  tiles, lies inside them;
- the two-GEMM route's plain chain (the last hidden layer's rows rounded
  to bf16 for the output layer, as the route stores them) against JAX's
  bf16 factored all-pairs at hidden (1152, 128) and (1152, 256, 128):
  ≤ −40 dB NMSE, the limit of ``test_torch_serve_widths.py``.
"""

import contextlib
import ctypes
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
from mamimo_tpu.ops.pallas.int8_mm import matmul_pallas as j_matmul_pallas
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import _build, int8_mm, util
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.int8_mm import b_operand, matmul_pallas

BF16, F32 = torch.bfloat16, torch.float32
CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
REL = 1e-5                    # float32 sums of exact products, of the scale
CSRC = Path(ff.__file__).resolve().parents[2] / "csrc"


def _db(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref ** 2))


def _b_layout(b: np.ndarray, layout: str) -> torch.Tensor:
    """b (K, N) as a torch bf16 tensor: row-major, the transposed view of
    a row-major Bt, or every other column of a wider row-major array."""
    if layout == "rows":
        return torch.from_numpy(b).to(BF16)
    if layout == "view of bt":
        return torch.from_numpy(b.T.copy()).to(BF16).T
    wide = np.repeat(b, 2, axis=1)
    return torch.from_numpy(wide).to(BF16)[:, ::2]


@pytest.mark.parametrize("layout", ["rows", "view of bt", "strided"])
@pytest.mark.parametrize("m, k, n", [(129, 72, 40), (5, 136, 264),
                                     (300, 64, 13)])
def test_matmul_bf16_plain_matches_jax(m, k, n, layout):
    """Ragged M (JAX's 128-row blocks), N and K; B in three layouts."""
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = np.asarray(j_matmul_pallas(jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16),
                                     block_m=128, interpret=True))
    tb = _b_layout(b, layout)
    assert tb.is_contiguous() == (layout == "rows")
    got = matmul_pallas(torch.from_numpy(a).to(BF16), tb)
    assert got.dtype == F32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("n, layout, same, bmn", [
    (24, "rows", "b", True),            # B as it is: MN-major, no copy
    (24, "view of bt", "bt", False),    # Bt as it is: K-major, no copy
    (24, "strided", None, True),        # a row-major copy of B
    (13, "rows", None, False),          # N % 8: a copy of B.T
])
def test_b_operand_reads_b_as_it_lies(n, layout, same, bmn):
    b = _b_layout(np.ones((16, n), np.float32), layout)
    got, is_mn = b_operand(b)
    assert is_mn == bmn and got.is_contiguous()
    assert tuple(got.shape) == ((16, n) if bmn else (n, 16))
    if same == "b":
        assert got.data_ptr() == b.data_ptr()
    elif same == "bt":
        assert got.data_ptr() == b.T.data_ptr()
    else:
        assert torch.equal(got, b if bmn else b.T)


class _Fn:
    def __init__(self, record):
        self.record = record

    def __call__(self, *args):
        self.record(args)
        return 0


class _Lib:
    """Stands in for a built library: each launch function records
    (library, function, arguments) and returns 0 (success)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        f = _Fn(lambda args: self.calls.append((self.name, fn, args)))
        setattr(self, fn, f)
        return f


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' device test answers CUDA, the stream is 0, and every
    library is a _Lib: returns the list of recorded launches."""
    calls = []
    for mod in (int8_mm, util, ff, mi):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    return calls


@pytest.mark.parametrize("out", [None, BF16])
@pytest.mark.parametrize("n, layout, bmn", [
    (24, "rows", True), (24, "view of bt", False), (13, "rows", False)])
def test_cuda_branch_bf16_gets_b_as_given(launches, n, layout, bmn, out):
    """The bf16 launch gets B (K, N) itself with mode bit 2, or the Bt
    its transposed view lies on, or (N % 8) a copy of B.T; bit 0 the bf16
    store, bit 3 the STAGED epilogue (a bf16 C with 16-byte rows);
    counted once."""
    a = torch.ones((3, 16), dtype=BF16)
    b = _b_layout(np.ones((16, n), np.float32), layout)
    before = int8_mm.matmul_float.launches
    got = matmul_pallas(a, b, out_dtype=out)
    (name, fn, args), = launches
    assert (name, fn) == ("matmul_bf16", "mm_bf16_launch")
    assert args[0] == a.data_ptr() and args[3:6] == (3, n, 16)
    staged = out == BF16 and n % 8 == 0
    assert args[6] == int(out == BF16) | 4 * bmn | 8 * staged
    if bmn:
        assert args[1] == b.data_ptr()
    elif layout == "view of bt":
        assert args[1] == b.T.data_ptr()
    else:
        assert args[1] not in (b.data_ptr(), b.T.data_ptr())
    assert got.dtype == (out or F32) and tuple(got.shape) == (3, n)
    assert int8_mm.matmul_float.launches == before + 1


def test_cuda_branch_int8_and_float32_get_bt(launches):
    """The int8 kernel gets a K-major copy of B; the float32 kernel the
    TF32 parts of one, split in the call; neither sets bit 2."""
    b8 = torch.ones((16, 24), dtype=torch.int8)
    matmul_pallas(torch.ones((3, 16), dtype=torch.int8), b8)
    (name, fn, args), = launches
    assert (name, fn) == ("int8_mm", "int8_mm_launch")
    assert args[1] != b8.data_ptr() and args[3:6] == (3, 24, 16)
    launches.clear()
    b = torch.ones((16, 24))
    matmul_pallas(torch.ones((3, 16)), b)
    (_, f1, s), (_, f2, m) = launches
    assert (f1, f2) == ("tf32_split_launch", "mm_float_launch")
    assert s[0] != b.data_ptr() and m[1] == s[1] and m[6] == 2


def _c_arity(src, fn):
    m = re.search(rf"int {fn}\(([^)]*)\)", (CSRC / f"{src}.cu").read_text())
    assert m, fn
    return len(m.group(1).split(","))


@pytest.mark.parametrize("src, fn, lib", [
    ("matmul", "mm_float_launch", lambda: int8_mm._float_lib()),
    ("matmul_bf16", "mm_bf16_launch", lambda: int8_mm._bf16_lib()),
    ("fused_factored", "factored_rows_tail_launch", lambda: ff._ff_lib()),
    ("fused_factored", "factored_rows_gemms_launch", lambda: ff._ff_lib()),
    ("fused_factored", "factored_dense_launch", lambda: ff._ff_lib()),
    ("mlp_infer", "mlp_tail_launch", lambda: mi._mlp_lib()),
    ("mlp_infer", "mlp_tail_gemms_launch", lambda: mi._mlp_lib()),
])
def test_launch_binding_matches_the_c_signature(monkeypatch, src, fn, lib):
    """Each binding gives its launch function as many arguments as the C
    source declares (a missing one is a TypeError only on the card)."""
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, []))
    assert len(getattr(lib(), fn).argtypes) == _c_arity(src, fn)


def test_routes_at_their_edges():
    """mlp_infer_tail: bf16 h1 of 1024 units stays on the fused kernel,
    1152 take the two GEMMs; factored_rows_tail: bf16 rows always take
    the two GEMMs; float32 takes the fused float32 tails at any width.
    matmul_pallas: the STAGED epilogue for a bf16 C with n % 8 == 0."""
    assert mi.tail_route(1024, BF16) == "fused"
    assert mi.tail_route(1152, BF16) == "gemms"
    assert mi.tail_route(1152, F32) == mi.tail_route(4096, F32) == "fused"
    assert ff.rows_tail_route(BF16) == "gemms"
    assert ff.rows_tail_route(F32) == "fused"
    assert int8_mm.staged_epilogue(BF16, 1024)
    assert int8_mm.staged_epilogue(BF16, 8)
    assert not int8_mm.staged_epilogue(BF16, 234)
    assert not int8_mm.staged_epilogue(F32, 1024)


def _tree(hidden, seed=1):
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(seed), CFG, tcfg)
    return tcfg, tp, tb, ff.prepare_factored_weights(CFG, tcfg, tp, tb)


@pytest.mark.parametrize("C", [234, 256])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hidden", [(1024, 128), (1152, 128),
                                    (1152, 256, 128)])
def test_cuda_branch_rows_tail_routes(launches, hidden, dtype, C):
    """factored_rows_tail on bf16 rows launches the two GEMMs (with a (2,
    M, H2) bf16 workspace for the last hidden layer's rows, H2 = 128
    here), on float32 rows the fused float32 tail; C up to 256 either
    way, 257 refused; the mode's bits as before; counted once, the GEMM
    route apart."""
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(1), CFG, tcfg)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb, dot_dtype=dtype)
    launches.clear()                  # the float32 tree's TF32 splits
    d = ff.factored_depth(prep)
    h1 = prep[f"w{d}"].shape[1]
    rows = torch.zeros((2, 24, h1), dtype=dtype)
    before = (ff.factored_rows_tail.launches,
              ff.factored_rows_tail.launches_gemms)
    y = ff.factored_rows_tail(prep, rows, C, BF16)
    (name, f, args), = launches
    gemms = dtype == BF16
    assert (name, f) == ("fused_factored", "factored_rows_gemms_launch"
                         if gemms else "factored_rows_tail_launch")
    sfx = "" if gemms else "_tf32"
    assert args[0] == rows.data_ptr()
    assert args[1] == prep[f"w{d}t{sfx}"].data_ptr()
    ints = args[9:15] if gemms else args[8:14]
    assert ints == (24, h1, 128, C, prep[f"b{d + 1}"].shape[-1],
                    1 + 2 * (not gemms))
    assert y.dtype == BF16 and tuple(y.shape) == (2, 24, C)
    assert (ff.factored_rows_tail.launches,
            ff.factored_rows_tail.launches_gemms) == (
        before[0] + 1, before[1] + gemms)
    with pytest.raises(ValueError, match="C <= 256"):
        ff.factored_rows_tail(prep, rows, 257)


def _floats(ptr, n):
    """n float32 values at a host address (a CPU tensor's data_ptr)."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


@pytest.mark.parametrize("out", [F32, BF16])
@pytest.mark.parametrize("hidden", [(128, 128, 128), (128, 256, 128),
                                    (128,)])
def test_cuda_branch_bf16_dense_routes(launches, monkeypatch, hidden, out):
    """bf16 factored_dense reaches factored_dense_launch with the rows,
    the K-major weight as prepared, (M, N, K, C, ldb, out_layer, mode):
    a hidden layer (depth 3: layer 2) with N = its width and bias,
    affine as prepared, ldb = N, whether or not N is a multiple of 256
    (the GEMM's epilogue reads no column past N); the output layer
    (depth 1) with N = 256 rows of W^T, C = 234 and mode bit 0 for a
    bf16 store; counted once, never as the float32 mode."""
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(3), CFG, tcfg)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
    gen = torch.Generator().manual_seed(4)
    for k in ("b2", "a2", "c2"):
        if k in prep:                     # values to find in the copies
            prep[k] = torch.rand(prep[k].shape, generator=gen) + 0.5
    out_layer = len(hidden) == 1
    seen = {}

    def record(args):
        # the vectors as the kernel would read them, during the launch
        ldb = args[10]
        seen.update({k: _floats(args[i], 2 * ldb).reshape(2, ldb).copy()
                     for k, i in (("b", 2), ("a", 3), ("c", 4))})

    def library(name, defines=()):
        lib = _Lib(name, launches)
        lib.factored_dense_launch = _Fn(lambda a: (record(a), launches.append(
            (name, "factored_dense_launch", a))))
        return lib

    monkeypatch.setattr(_build, "library", library)
    kin = prep["w1"].shape[2]
    rows = torch.zeros((2, 24, kin), dtype=BF16)
    before = (ff.factored_dense.launches, ff.factored_dense.launches_f32)
    y = ff.factored_dense(prep, 2, rows, CFG.num_carriers, out) \
        if out_layer else ff.factored_dense(prep, 2, rows)
    (name, fn, args), = launches
    assert (name, fn) == ("fused_factored", "factored_dense_launch")
    assert args[0] == rows.data_ptr() and args[1] == prep["w2t"].data_ptr()
    if out_layer:
        n, ldb = 256, prep["b2"].shape[-1]
        assert args[6:] == (24, n, kin, CFG.num_carriers, ldb, 1,
                            int(out == BF16), 0)
        assert y.dtype == out and tuple(y.shape) == (2, 24,
                                                      CFG.num_carriers)
    else:
        n = prep["w2"].shape[2]
        assert args[6:] == (24, n, kin, 0, n, 0, 0, 0)
        assert y.dtype == BF16 and tuple(y.shape) == (2, 24, n)
        for k, i in (("b", 2), ("a", 3), ("c", 4)):
            np.testing.assert_array_equal(
                seen[k], prep[f"{k}2"].reshape(2, n).numpy())
            assert args[i] == prep[f"{k}2"].data_ptr()
    assert (ff.factored_dense.launches, ff.factored_dense.launches_f32) == (
        before[0] + 1, before[1])


def _staged_reads(N, Z, ldb):
    """The reads of b, a and c the hidden layer's STAGED epilogue makes
    over the 256-column tiles of N columns and Z planes, as (plane, the
    functor's column col, index p·ldb + col or + 1): (every read its
    functor would make at each even column of every tile, those its guard
    lets through). The guard is taken from the source: a statement of the
    functor before any read of a vector, `if (col >= N) return` zeros."""
    body = (CSRC / "mm_sm90.cuh").read_text()
    body = body[body.index("gemm_coop<false, STAGED>("):]
    functor = body[:body.index("});")]
    m = re.search(r"if \((\w+) (>=) (\w+)\) return make_float2\(0\.f, 0\.f\);",
                  functor)
    assert m is not None and m.groups() == ("col", ">=", "N")
    assert m.end() < min(functor.index(v) for v in ("b[", "a[", "c["))
    reads = []
    for p in range(Z):
        for n0 in range(0, -(-N // 256) * 256, 256):
            for c in range(0, 256, 2):
                col = n0 + c
                reads += [(p, col, p * ldb + col + e) for e in (0, 1)]
    guarded = [r for r in reads if not r[1] >= N]      # the source's guard
    return reads, guarded


@pytest.mark.parametrize("hidden, H", [((1536, 640), None), (None, 1152)])
def test_two_gemm_route_reads_its_vectors_inside(launches, hidden, H):
    """factored_rows_tail at hidden (1536, 640) (H2 = 640) and
    mlp_infer_tail at 1152 units (H2 % 256 = 128 both) launch the two
    GEMMs with b2 and the affine as prepared, H2 values a plane; the
    STAGED epilogue's reads, modelled over its 256-column tiles, would
    run 128 values past the last plane's H2 values, and the guard read
    from the source removes exactly those at columns >= H2, leaving each
    vector read once, inside it."""
    if hidden is not None:
        tcfg = TrainConfig(hidden=hidden)
        tp, tb = mlp.init_stacked(torch.Generator().manual_seed(5), CFG,
                                  tcfg)
        prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
        rows = torch.zeros((2, 24, 1536), dtype=BF16)
        ff.factored_rows_tail(prep, rows, CFG.num_carriers)
        (name, fn, args), = launches
        assert fn == "factored_rows_gemms_launch"
        vec, z, h2 = [prep[k] for k in ("b2", "a2", "c2")], 2, 640
        assert args[9:12] == (24, 1536, h2)
    else:
        tcfg = TrainConfig(hidden=(H, H))
        tp, tb = mlp.init_stacked(torch.Generator().manual_seed(6), CFG,
                                  tcfg)
        p = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), 0)
        mi.mlp_infer_tail(p, torch.zeros((24, H), dtype=BF16))
        (name, fn, args), = launches
        assert fn == "mlp_tail_gemms_launch"
        vec, z, h2 = [p[k] for k in ("b2", "s2", "t2")], 1, H
        assert args[9:12] == (24, H, h2)
    assert [args[i] for i in (2, 3, 4)] == [v.data_ptr() for v in vec]
    for v in vec:
        assert v.is_contiguous() and v.numel() == z * h2
    reads, guarded = _staged_reads(h2, z, h2)
    # unguarded, the last plane's tile would read 128 values past its end
    assert max(j for _, _, j in reads) == z * h2 - 1 + 128
    # the guard removes exactly the reads at columns >= H2, and the rest
    # cover each vector once, inside it
    assert [r for r in reads if r not in guarded] == \
        [r for r in reads if r[1] >= h2]
    assert sorted(j for _, _, j in guarded) == list(range(z * h2))


def _c_body(src, fn):
    """The body of launch function fn in csrc/<src>.cu."""
    text = (CSRC / f"{src}.cu").read_text()
    start = text.index(f"int {fn}(")
    return text[start:text.index("\n}\n", start)]


def test_bf16_dense_launch_runs_the_tails_gemm():
    """factored_dense_launch's bf16 branch launches mm_sm90.cuh's
    rows_gemm_kernel: the hidden layer with the STAGED epilogue (its rows
    through a TMA store map of y), the output layer in DIRECT row pieces
    with an f32 and a bf16 store; no kernel of its own is left in the
    source, and the float32 mode keeps factored_dense_f32_kernel."""
    body = _c_body("fused_factored", "factored_dense_launch")
    assert "mm::launch<mm::STAGED>(mm::rows_gemm_kernel<false>" in body
    assert "mm::make_c_map(&my, y, M, N, 2)" in body
    for t in ("bf16", "float"):
        assert f"mm::launch(mm::rows_gemm_kernel<true, {t}>" in body
    assert "factored_dense_f32_kernel<" in body
    text = (CSRC / "fused_factored.cu").read_text()
    assert "factored_dense_kernel" not in text


@pytest.mark.parametrize("H, fn", [(1024, "mlp_tail_launch"),
                                   (1152, "mlp_tail_gemms_launch")])
def test_cuda_branch_mlp_tail_routes(launches, H, fn):
    """mlp_infer_tail on bf16 h1 launches the fused tail up to 1024 units
    and the two GEMMs above (an (M, H) bf16 workspace for h2)."""
    tcfg = TrainConfig(hidden=(H, H))
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(2), CFG, tcfg)
    p = mlp.plane(mi.prepare_mlp_infer_weights(tcfg, tp, tb), 0)
    h1 = torch.zeros((24, p["w2"].shape[0]), dtype=BF16)
    before = (mi.mlp_infer_tail.launches, mi.mlp_infer_tail.launches_gemms)
    y = mi.mlp_infer_tail(p, h1)
    (name, f, args), = launches
    assert (name, f) == ("mlp_infer", fn)
    assert args[0] == h1.data_ptr()
    gemms = fn == "mlp_tail_gemms_launch"
    width = p["w2"].shape[0]
    assert args[9 if gemms else 8:][:4] == (24, width, width,
                                            CFG.num_carriers)
    assert y.dtype == F32 and tuple(y.shape) == (24, CFG.num_carriers)
    assert (mi.mlp_infer_tail.launches, mi.mlp_infer_tail.launches_gemms) \
        == (before[0] + 1, before[1] + gemms)


def _jax_model(hidden, seed):
    """JAX parameters with non-trivial biases and BN state."""
    jtcfg = JTrainConfig(hidden=hidden)
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
    return jtcfg, jp, jb


@pytest.mark.parametrize("hidden", [(1152, 128), (1152, 256, 128)])
def test_gemm_route_plain_chain_matches_jax_bf16(hidden):
    """Nt 8, S = 8: models with a first hidden layer of 1152 units (at
    depth 2 the rows tail's input, on the two GEMMs; at depth 3 the dense
    layer's) through the plain chain, wrapper by wrapper, against JAX's
    bf16 factored all-pairs; the two-GEMM route's rounding of the last
    hidden layer's rows to bf16 before the output layer is the plain
    version's."""
    jtcfg, jp, jb = _jax_model(hidden, seed=len(hidden) + 3)
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.params_from_jax(jp, jb)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
    d = ff.factored_depth(prep)
    x = np.random.default_rng(17).standard_normal(
        (2, 8, CFG.len_ltf)).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    ref = np.asarray(jmlp._factored_all_pairs(
        JCFG, jtcfg, jp, jb, jnp.asarray(x).astype(jnp.bfloat16),
        dtype=jnp.bfloat16).astype(jnp.float32))
    got = ff.fused_factored_planes(CFG, tcfg, prep, xb)
    assert _db(got.numpy(), ref) <= -40.0
    h = ff.factored_heads(prep, ff.factored_sig_proj(xb, prep["w1"]))
    for k in range(2, d):
        h = ff.factored_dense(prep, k, h)
    h2 = ff._hidden_plain(prep, d, h).to(BF16)      # the route's rows
    y = ff.factored_dense(prep, d + 1, h2, CFG.num_carriers)
    assert torch.equal(y.reshape(got.shape), got)
    assert torch.equal(ff.factored_rows_tail(prep, h, CFG.num_carriers)
                       .reshape(got.shape), got)
