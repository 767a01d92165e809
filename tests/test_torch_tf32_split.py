"""The TF32 split of the float32 kernels' operands (csrc/tf32_split.cu
and its plain version ``ops/kernels/util.py::tf32_split``), on the CPU.

The kernel runs only on the card (chip_smoke.py phase 5n holds it to the
plain version bit for bit). Here:

- the plain split against a float64 reference of TF32 rounding (to
  nearest, ties away from zero): both parts TF32 values (the low 13 bits
  zero), hi + lo = w within 2^-22 |w| (within half of TF32's subnormal
  spacing, 2^-137, for w below float32's normal range, where no part
  can carry finer bits), signs, zeros and subnormals;
- the float32 trees of ``prepare_factored_weights`` and
  ``prepare_mlp_infer_weights`` carry each K-major weight's parts
  (``<key>_tf32``), and their bf16 trees keep their keys and bits;
- hi·hi + hi·lo + lo·hi at K = 10240, summed in float64, below −120 dB
  of the float64 product;
- the CUDA branches with the device test made to answer CUDA and a
  recording library: the split launch's arguments and count, the float32
  GEMM splitting Bt per call and launching on the parts, the raw-weight
  MLP splitting its three weights per call, and trees without the parts
  refused before any launch.
"""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.ops.kernels import _build, int8_mm, util
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.util import tf32_split

CFG = SimConfig(num_tx=8, num_rx=2)
F32, BF16 = torch.float32, torch.bfloat16


def _rna_f64(w: np.ndarray) -> np.ndarray:
    """float64 values rounded to TF32 (11 significant bits, subnormal
    spacing 2^-136) to nearest, ties away from zero."""
    a = np.abs(w)
    _, ex = np.frexp(a)
    q = np.ldexp(1.0, np.maximum(ex - 1, -126) - 10)
    return np.sign(w) * np.floor(a / q + 0.5) * q


def _specials() -> np.ndarray:
    """Signs, zeros, subnormals, ties and values near the binade edges."""
    one = np.float32(1.0)
    eps = 2.0 ** -11
    v = [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -2.8e-45, 1.1754942e-38,
         -1.1754942e-38, 1.1754944e-38, 3e-39, 1 + eps, -(1 + eps),
         1 + 3 * eps, -(1 + 3 * eps), 1 + eps + 2 ** -23, 2 - 2 ** -23,
         -(2 - 2 ** -23), 3.0e38, -3.0e38, float(one)]
    return np.array(v, dtype=np.float32)


@pytest.mark.parametrize("kind", ["specials", "randn", "wide"])
def test_plain_split_matches_the_float64_reference(kind):
    """The plain split's parts equal the float64 reference's, bit for
    bit up to the sign of zero; both parts are TF32 values; hi + lo holds
    w to 2^-22 |w| (2^-137 below the normal range)."""
    rng = np.random.default_rng(7)
    w = {"specials": _specials(),
         "randn": rng.standard_normal(4096).astype(np.float32),
         "wide": (rng.standard_normal(4096) * np.exp2(
             rng.integers(-140, 120, 4096))).astype(np.float32)}[kind]
    hi, lo = tf32_split(torch.from_numpy(w))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    w64 = w.astype(np.float64)
    ref_hi = _rna_f64(w64)
    ref_lo = _rna_f64(w64 - ref_hi)
    np.testing.assert_array_equal(hi.double().numpy(), ref_hi)
    np.testing.assert_array_equal(lo.double().numpy(), ref_lo)
    # the sign of hi is w's (zeros included)
    assert np.array_equal(np.signbit(hi.numpy()), np.signbit(w))
    err = np.abs(w64 - hi.double().numpy() - lo.double().numpy())
    assert (err <= np.maximum(2.0 ** -22 * np.abs(w64), 2.0 ** -137)).all()


def test_split_of_ties_rounds_away_from_zero():
    """1 + 2^-11 lies halfway between 1 and 1 + 2^-10: TF32's cvt.rna
    takes 1 + 2^-10 (away from zero, not to even), and 1 + 3·2^-11 takes
    1 + 2^-9; the negative values mirror them."""
    e = 2.0 ** -11
    w = torch.tensor([1 + e, 1 + 3 * e, -(1 + e), -(1 + 3 * e)])
    hi, lo = tf32_split(w)
    assert hi.tolist() == [1 + 2 * e, 1 + 4 * e, -(1 + 2 * e), -(1 + 4 * e)]
    assert lo.tolist() == [-e, -e, e, e]


def test_split_dim_places_the_parts():
    """dim places the (hi, lo) axis; every dim gives the same parts."""
    t = torch.randn((3, 4, 8), generator=torch.Generator().manual_seed(1))
    base = tf32_split(t)
    for dim in (1, 2, 3, -1):
        got = tf32_split(t, dim)
        assert torch.equal(got.movedim(dim, 0), base)


def test_three_products_at_k10240():
    """hi·hi + hi·lo + lo·hi of float32 operands at K = 10240 (the
    layer-1 GEMMs' depth), summed in float64: below −120 dB of the
    float64 product; one TF32 product (hi·hi) is far above it."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((16, 10240)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((10240, 12)).astype(np.float32))
    (ah, al), (bh, bl) = tf32_split(a).double(), tf32_split(b).double()
    ref = a.double() @ b.double()

    def db(got):
        return 10 * float(torch.log10((got - ref).square().sum()
                                      / ref.square().sum()))

    assert db(ah @ bh + ah @ bl + al @ bh) < -120.0
    assert db(ah @ bh) > -80.0


def _models(hidden):
    tcfg = TrainConfig(hidden=hidden)
    params, bn = mlp.init_stacked(torch.Generator().manual_seed(5), CFG,
                                  tcfg)
    return tcfg, params, bn


def _kmajor(w: torch.Tensor, rows: int) -> torch.Tensor:
    """Plane-leading w (2, K, N) K-major, (2, rows, K), zero-padded to
    rows as the trees' K-major weights are."""
    out = w.new_zeros((w.shape[0], rows, w.shape[1]))
    out[:, :w.shape[2]] = w.transpose(1, 2)
    return out


def _same_bits_as_rounded(t16: dict, t32: dict) -> None:
    """The bf16 tree's keys are the float32 tree's with each K-major
    weight unsplit (w{j}t in place of w{j}t_tf32), each weight the
    float32 weight rounded and every vector identical."""
    assert set(t16) == {k[:-5] if k.endswith("_tf32") else k for k in t32}
    for k, v in t16.items():
        if k + "_tf32" in t32:
            want = _kmajor(t32[k[:-1]], v.shape[1]).to(BF16)
        else:
            want = t32[k].to(BF16) if v.dtype == BF16 else t32[k]
        assert v.dtype == want.dtype and torch.equal(v, want), k


@pytest.mark.parametrize("hidden", [(128,), (128, 256), (128, 128, 128)])
def test_factored_trees_carry_the_parts(hidden):
    """The float32 tree has w{j}t_tf32 = tf32_split(w{j}t, 1), (2, 2, N,
    K), in place of w{j}t, for layer 1, each hidden layer and the output;
    the bf16 tree has no parts and the same bits as before (the float32
    weights rounded)."""
    tcfg, params, bn = _models(hidden)
    p32 = ff.prepare_factored_weights(CFG, tcfg, params, bn, dot_dtype=F32)
    p16 = ff.prepare_factored_weights(CFG, tcfg, params, bn)
    d = len(hidden)
    parts = sorted(k for k in p32 if k.endswith("_tf32"))
    assert parts == sorted(f"w{j}t_tf32" for j in range(1, d + 2))
    for k in parts:
        assert k[:-5] not in p32
        wt = _kmajor(p32[k[:-6]], p32[k].shape[2])
        assert tuple(p32[k].shape) == (2, 2, *wt.shape[1:])
        assert torch.equal(p32[k], tf32_split(wt, 1))
    _same_bits_as_rounded(p16, p32)
    keys = {"w1", "w1t", "hb", "a1", "c1", f"w{d + 1}", f"w{d + 1}t",
            f"b{d + 1}"}
    for k in range(2, d + 1):
        keys |= {f"w{k}", f"w{k}t", f"b{k}", f"a{k}", f"c{k}"}
    assert set(p16) == keys


def test_mlp_trees_carry_the_parts():
    """prepare_mlp_infer_weights(float32): w1t_tf32, w2t_tf32, w3t_tf32
    (2, 2, N, K) in place of the bf16 tree's w1t, w2t, w3t; the bf16
    tree's 13 keys hold the float32 tree's bits rounded."""
    tcfg, params, bn = _models((128, 128))
    m32 = mi.prepare_mlp_infer_weights(tcfg, params, bn, F32)
    m16 = mi.prepare_mlp_infer_weights(tcfg, params, bn)
    assert set(m16) == {"w1", "w1t", "b1", "s1", "t1", "w2", "w2t", "b2",
                        "s2", "t2", "w3", "w3t", "b3"}
    for k in ("w1t", "w2t", "w3t"):
        assert k not in m32
        wt = _kmajor(m32[k[:-1]], m32[k[:-1]].shape[2])
        assert tuple(m32[f"{k}_tf32"].shape) == (2, 2, *wt.shape[1:])
        assert torch.equal(m32[f"{k}_tf32"], tf32_split(wt, 1))
    _same_bits_as_rounded(m16, m32)


# ----------------------------------------------------------------------
# the CUDA branches
# ----------------------------------------------------------------------

class _Lib:
    """Stands in for a built library: each function records (library,
    function, arguments) and returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        def f(*args):
            self.calls.append((self.name, fn, args))
            return 0

        f.argtypes, f.restype = None, None
        setattr(self, fn, f)
        return f


@pytest.fixture
def launches(monkeypatch):
    """Every wrapper's device test answers CUDA, the stream is 0, every
    library records its launches: returns the list of them."""
    calls = []
    for mod in (util, ff, mi, int8_mm):
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


@pytest.mark.parametrize("shape, dim, outer", [
    ((6, 10), 0, 1), ((2, 6, 10), 1, 2), ((2, 3, 4), 3, 24)])
def test_cuda_branch_split_launch(launches, shape, dim, outer):
    """On CUDA the split launches its kernel once, (x, out, outer,
    inner), out with the parts axis at dim; counted."""
    t = torch.ones(shape)
    before = tf32_split.launches
    out = tf32_split(t, dim)
    (lib, fn, args), = launches
    assert (lib, fn) == ("tf32_split", "tf32_split_launch")
    assert args == (t.data_ptr(), out.data_ptr(), outer,
                    t.numel() // outer, 0)
    assert out.shape[dim] == 2 and out.dtype == F32
    assert tf32_split.launches == before + 1


def test_cuda_branch_matmul_splits_bt_per_call(launches):
    """matmul_pallas on float32 operands splits Bt with the split kernel
    in the call and launches the float32 GEMM on the parts it wrote; the
    bf16 mode splits nothing."""
    a, b = torch.ones((3, 16)), torch.ones((16, 5))
    int8_mm.matmul_pallas(a, b)
    (l1, f1, s), (l2, f2, m) = launches
    assert (f1, f2) == ("tf32_split_launch", "mm_float_launch")
    assert s[2:4] == (1, 5 * 16) and m[1] == s[1] and m[6] == 2
    launches.clear()
    int8_mm.matmul_pallas(a.to(BF16), b.to(BF16))
    assert [f for _, f, _ in launches] == ["mm_bf16_launch"]


def test_cuda_branch_raw_mlp_splits_per_call(launches):
    """mlp_infer_pallas on raw float32 parameters folds them and splits
    w1t, w2t, w3t with the split kernel in the call (three launches),
    then launches both kernels in the float32 mode on those parts."""
    tcfg, params, bn = _models((128, 128))
    x = torch.zeros((4, CFG.len_ltf + CFG.num_tx))
    mi.mlp_infer_pallas(tcfg, mlp.plane(params, 0), mlp.plane(bn, 0), x,
                        dot_dtype=F32)
    fns = [f for _, f, _ in launches]
    assert fns == ["tf32_split_launch"] * 3 + ["mlp_layer1_launch",
                                               "mlp_tail_launch"]
    outs = [a[1] for _, f, a in launches[:3]]
    assert launches[3][2][1] == outs[0]
    assert launches[4][2][1] == outs[1] and launches[4][2][5] == outs[2]


def test_cuda_branch_refuses_trees_without_parts(launches):
    """A float32 tree without the parts (or w1t given unsplit) raises
    ValueError naming the missing key, before any launch."""
    tcfg, params, bn = _models((128, 128, 128))
    p32 = ff.prepare_factored_weights(CFG, tcfg, params, bn, dot_dtype=F32)
    launches.clear()
    bare = {k: v for k, v in p32.items() if not k.endswith("_tf32")}
    rows = torch.zeros((2, 3 * CFG.num_tx, 128))
    x = torch.zeros((2, 3, CFG.len_ltf))
    with pytest.raises(ValueError, match=r"prepared\['w1t_tf32'\]"):
        ff.factored_sig_proj(x, p32["w1"],
                             p32["w1"].transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match=r"prepared\['w2t_tf32'\]"):
        ff.factored_dense(bare, 2, rows)
    with pytest.raises(ValueError, match=r"prepared\['w3t_tf32'\]"):
        ff.factored_rows_tail(bare, rows, CFG.num_carriers)
    mtcfg, mp, mb = _models((128, 128))
    m32 = mlp.plane(mi.prepare_mlp_infer_weights(mtcfg, mp, mb, F32), 0)
    launches.clear()
    xm = torch.zeros((4, CFG.len_ltf + CFG.num_tx))
    with pytest.raises(ValueError, match=r"prepared\['w1t_tf32'\]"):
        mi.mlp_infer_layer1({k: v for k, v in m32.items()
                             if k != "w1t_tf32"}, xm)
    with pytest.raises(ValueError, match=r"prepared\['w2t_tf32'\]"):
        mi.mlp_infer_tail({k: v for k, v in m32.items()
                           if k != "w2t_tf32"}, torch.zeros((4, 128)))
    assert not launches


def test_split_binding_matches_the_c_signature(monkeypatch):
    """tf32_split_launch gets as many arguments as its source declares,
    the sizes as 64-bit integers."""
    import ctypes

    class Lib:
        def __init__(self):
            self.tf32_split_launch = types.SimpleNamespace()

    monkeypatch.setattr(_build, "library", lambda name, defines=(): Lib())
    fn = util._split_lib().tf32_split_launch
    src = (Path(util.__file__).resolve().parents[2] / "csrc" /
           "tf32_split.cu").read_text()
    m = re.search(r"int tf32_split_launch\(([^)]*)\)", src)
    params = m.group(1).split(",")
    assert len(fn.argtypes) == len(params)
    for t, p in zip(fn.argtypes, params):
        assert (t is ctypes.c_longlong) == ("long long" in p), p
