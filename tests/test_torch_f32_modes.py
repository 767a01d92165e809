"""The float32 modes of the port's LS kernels (kernels 1, 3 and 4:
ls_planes_v2, ls_planes_pallas / ls_planes_v1, ls_estimate_pallas) and
the bf16 and float32 modes of its GEMM (kernel 6, matmul_pallas), on the
CPU.

The CUDA kernels run only on the card (chip_smoke.py phase 5m holds them
to these plain versions at −90 dB). Here:

- the plain versions, on the same numpy inputs, against JAX's Pallas
  kernels in interpret mode on float32 input: the v2 kernel with float32
  constants, full and sequence-sharded; the v1 kernel in its complex,
  raw and ``as_planes`` forms; the per-pair kernel on complex64 rx; the
  GEMM on bf16 and float32 operands with ``out_dtype`` None and bf16.
  Tolerance: float32 against float32, 1e-5 of the largest reference
  value (JAX's own LS tests allow 2e-4); a bf16 store one bf16 step
  (2^-7) relative more, where two float32 sums round apart;
- the float32 mode's arithmetic, rebuilt in float64 from the split
  constants of ``ls_sm90_constants(cfg, dtype=float32)`` (three TF32
  products of high and low parts), against the plain version: −110 dB;
  at 256 Tx antennas as the kernel sums its two symbol halves a tile
  (the second half's products negated for the second output part):
  −100 dB;
- the wrappers' CUDA branches (the device test made to answer CUDA, the
  library replaced by one that records each launch): float32 input
  reaches the float32 launch mode as it is, without a cast to bf16, and
  bf16 input the bf16 mode; matmul_pallas launches the float kernel for
  bf16 and float32 operands; constants of the other dtype are refused.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops.ltf import _hadamard_np as j_hadamard
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_estimate_pallas as j_ls_pair,
    ls_planes_pallas as j_ls_v1,
    ls_planes_pallas_v2 as j_ls_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu.ops.pallas.int8_mm import matmul_pallas as j_matmul_pallas
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import _build, fused_ls, int8_mm
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    LsSm90Constants,
    _ls_v2_plain,
    ls_estimate_pallas,
    ls_kernel_constants,
    ls_pair_kernel,
    ls_planes_pallas,
    ls_planes_v1,
    ls_planes_v2,
    ls_sm90_constants,
    ls_sm90_row_order,
    pair_planes,
    tf32_split,
)
from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_float, matmul_pallas
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
S = 3                         # 24 rows: one partly filled 128-row tile
REL = 1e-5                    # float32 against float32, of the scale
BF16_STEP = 2.0 ** -7         # one bfloat16 rounding step, relative
F32, BF16 = torch.float32, torch.bfloat16


def _planes(s=S, seed=0, nsym=None):
    n = (nsym or CFG.num_tx) * CFG.sym_len
    return np.random.default_rng(seed).standard_normal(
        (2, s, n)).astype(np.float32)


def _close(got, ref, rel=REL, step=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    if np.iscomplexobj(ref):
        got, ref = (np.stack([t.real, t.imag]) for t in (got, ref))
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=step,
                               atol=rel * np.abs(ref).max())


def _nmse_db(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref ** 2))


# ----------------------------------------------------------------------
# the plain versions against JAX's kernels on float32 input
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seq", [None, (1, 2), (3, 4)])
def test_v2_float32_matches_jax(seq):
    """Kernel 1 on float32 planes with float32 constants: the whole
    preamble, and seq ranks' partial despreads (JAX's rectangular K)."""
    loc = CFG.num_tx if seq is None else CFG.num_tx // seq[1]
    x = _planes(seed=1 + (seq or (0,))[0], nsym=loc)
    b, k = j_v2_constants(JCFG, 4, dtype=jnp.float32)
    if seq is not None:
        i = seq[0]
        p = j_hadamard(JCFG.num_tx).astype(np.float32)[:, i * loc:
                                                       (i + 1) * loc]
        k = jnp.asarray(np.kron(np.eye(4, dtype=np.float32), p))
    h, _ = j_ls_v2(JCFG, jnp.asarray(x), (b, k), block_samples=4,
                   interpret=True)
    ref = np.asarray(j_v2_to_complex(JCFG, h, S))
    got = ls_planes_v2(CFG, torch.from_numpy(x), seq_shard=seq)
    assert got.dtype == F32
    _close(torch.complex(got[0], got[1]).numpy(), ref)


@pytest.mark.parametrize("form", ["complex", "raw", "as_planes"])
def test_v1_float32_matches_jax(form):
    """Kernel 3 on float32 planes in its three forms; ``as_planes`` is
    JAX's (2, S, num_tx, num_carriers) float32 planes."""
    x = _planes(seed=7)
    opts = {"raw": form == "raw", "as_planes": form == "as_planes"}
    ref = j_ls_v1(JCFG, jnp.asarray(x), block_samples=4, interpret=True,
                  **opts)
    got = ls_planes_pallas(CFG, torch.from_numpy(x), block_samples=4, **opts)
    if form == "raw":
        for g, r in zip(got, ref):
            assert g.dtype == F32
            _close(g, r)
    elif form == "as_planes":
        assert got.dtype == F32
        assert tuple(got.shape) == (2, S, CFG.num_tx, CFG.num_carriers)
        _close(got, ref)
        cplx = ls_planes_pallas(CFG, torch.from_numpy(x), block_samples=4)
        assert torch.equal(torch.complex(got[0], got[1]), cplx)
    else:
        _close(got.numpy(), ref)


def test_pair_float32_matches_jax():
    """Kernel 4 on complex64 rx (JAX's float32 xr/xi planes)."""
    rng = np.random.default_rng(11)
    shape = (2, CFG.len_ltf, CFG.num_rx)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.asarray(j_ls_pair(JCFG, jnp.asarray(rx), interpret=True))
    _close(ls_estimate_pallas(CFG, torch.from_numpy(rx)).numpy(), ref)


@pytest.mark.parametrize("out", [None, "bf16"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_matmul_float_matches_jax(dtype, out):
    """Kernel 6 on bf16 and float32 operands, M ragged (129 rows against
    JAX's 128-row blocks), with the float32 result and rounded to bf16:
    the bf16 store is the float32 result rounded to nearest even."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((129, 72)).astype(np.float32)
    b = rng.standard_normal((72, 40)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, BF16) if dtype == "bf16"
                else (jnp.float32, F32))
    jo, to = (jnp.bfloat16, BF16) if out else (None, None)
    ref = j_matmul_pallas(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                          block_m=128, out_dtype=jo)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = matmul_pallas(ta, tb, block_m=128, out_dtype=to)
    assert got.dtype == (to or F32) and tuple(got.shape) == (129, 40)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got.float(), ref, step=BF16_STEP if out else 0.0)
    if out:
        assert torch.equal(got, matmul_pallas(ta, tb).to(BF16))


def test_matmul_float_plain_refusals():
    """Mixed dtypes, float16 storage and ill-shaped operands are refused
    on the CPU too; the int8 mode alone still refuses float operands."""
    a = torch.ones((4, 16))
    with pytest.raises(TypeError, match="two bfloat16 or two float32"):
        matmul_pallas(a, torch.ones((16, 8), dtype=BF16))
    with pytest.raises(TypeError, match="out_dtype"):
        matmul_pallas(a, torch.ones((16, 8)), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="2-D"):
        matmul_pallas(a, torch.ones(16))
    with pytest.raises(ValueError, match="bt"):
        matmul_float(a, torch.ones((8, 12)))


def test_sharded_float32_planes_match_unsharded():
    """sharded_ls_pallas_v2 on float32 planes (not bf16-valued), data and
    seq over 2 CPU ranks, against the unsharded float32 kernel."""
    x = torch.from_numpy(_planes(s=4, seed=13))
    ref = ls_planes_v2(CFG, x)
    ref = torch.complex(ref[0], ref[1])
    for mode in ("data", "seq"):
        got = sharded.sharded_ls_pallas_v2(
            CFG, make_mesh({mode: 2}, devices=["cpu"] * 2), x, mode=mode)
        _close(torch.view_as_real(got), torch.view_as_real(ref))


# ----------------------------------------------------------------------
# the float32 constants and the float32 mode's arithmetic
# ----------------------------------------------------------------------

def test_tf32_split():
    """hi + lo holds 22 of float32's 24 bits: both TF32 values (low 13
    bits zero), |t − hi − lo| ≤ 2^-22 |t|, and a TF32 value splits into
    itself and zero."""
    t = torch.from_numpy(np.random.default_rng(2).standard_normal(
        4096).astype(np.float32))
    hi, lo = tf32_split(t)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (t.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * t.double().abs()).all())
    hi2, lo2 = tf32_split(hi)
    assert torch.equal(hi2, hi) and not lo2.any()


@pytest.mark.parametrize("cfg", [CFG, SimConfig()])
def test_float32_constants(cfg):
    """ls_sm90_constants(dtype=float32): (2, 2·Cp, 2·fft), the split of
    the float32 K-major matrix in the bf16 constants' row order; the
    default stays the bf16 (2·Cp, 2·fft) matrix."""
    k32 = ls_sm90_constants(cfg, dtype=F32)
    assert isinstance(k32, LsSm90Constants) and k32.bt.dtype == F32
    b = ls_kernel_constants(cfg, dtype=F32)
    cp_ = b.shape[1] // 2
    assert tuple(k32.bt.shape) == (2, 2 * cp_, 2 * cfg.fft_length)
    order = torch.from_numpy(ls_sm90_row_order(cp_))
    assert torch.equal(k32.bt, tf32_split(b.T[order].contiguous()))
    k16 = ls_sm90_constants(cfg)
    assert k16.bt.dtype == BF16 and tuple(k16.bt.shape) == tuple(
        k32.bt.shape[1:])
    assert torch.equal(k16.bt, ls_kernel_constants(cfg).T[order])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ls_sm90_constants(cfg, dtype=torch.float16)


def _mode_product(x, loc, seq, terms, cfg=CFG):
    """The float32 mode's LS rebuilt in float64: [x_r | x_i] (the fft
    samples) split into TF32 parts, times the split permuted constants,
    summed over ``terms`` ((input part, constants part) pairs, 0 high, 1
    low), the columns un-permuted and despread with P (a seq rank's
    columns of it): (2, S, num_tx, num_carriers). Above 128 symbols a
    sample (num_tx = 256) as the kernel's two halves a tile (NH = 2):
    output part a of a sample sums both 128-symbol halves' products, the
    second half's negated for part 1, then despreads with P_128."""
    s, c = x.shape[1], cfg.num_carriers
    rows = x.view(2, -1, cfg.sym_len)[:, :, cfg.cp_length:]
    xs = tf32_split(torch.cat([rows[0], rows[1]], 1)).double()
    bt = ls_sm90_constants(cfg, dtype=F32).bt.double()
    cp_ = bt.shape[1] // 2
    z = torch.empty((xs.shape[1], 2 * cp_), dtype=torch.float64)
    z[:, torch.from_numpy(ls_sm90_row_order(cp_))] = sum(
        xs[i] @ bt[j].T for i, j in terms)
    z = z.view(s, loc, 2 * cp_)
    if loc > 128:
        p = torch.from_numpy(j_hadamard(128)).double()
        h = torch.cat([torch.einsum("jn,snc->sjc", p, z[:, :128]
                                    + (-1.0) ** a * z[:, 128:])
                       for a in (0, 1)], 1)
    else:
        p = torch.from_numpy(j_hadamard(cfg.num_tx)).double()
        if seq is not None:
            p = p[:, seq[0] * loc:(seq[0] + 1) * loc]
        h = torch.einsum("jn,snc->sjc", p, z)
    return torch.stack([h[..., :c], h[..., cp_:cp_ + c]])


@pytest.mark.parametrize("seq", [None, (1, 4)])
def test_float32_mode_arithmetic(seq):
    """hi·hi + hi·lo + lo·hi on the split constants is within −110 dB of
    the float32 plain version; one TF32 pass (hi·hi) is not within −80."""
    loc = CFG.num_tx if seq is None else CFG.num_tx // seq[1]
    x = torch.from_numpy(_planes(s=5, seed=17, nsym=loc))
    ref = _ls_v2_plain(CFG, x, seq).double()
    three = _mode_product(x, loc, seq, ((0, 0), (0, 1), (1, 0)))
    assert _nmse_db(three, ref) < -110.0
    assert _nmse_db(_mode_product(x, loc, seq, ((0, 0),)), ref) > -80.0


def test_float32_mode_arithmetic_nt256():
    """At 256 Tx antennas (NH = 2), one packet: the three TF32 products
    summed over both symbol halves of a tile, the second half's negated
    for output part 1, then the 128-symbol despread, are within −100 dB
    of the float32 plain version; one TF32 pass is not within −80."""
    cfg = SimConfig(num_tx=256, num_rx=4)
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (2, cfg.num_rx, cfg.len_ltf)).astype(np.float32))
    ref = _ls_v2_plain(cfg, x).double()
    assert ref.shape == (2, cfg.num_rx, 256, cfg.num_carriers)
    three = _mode_product(x, 256, None, ((0, 0), (0, 1), (1, 0)), cfg)
    assert _nmse_db(three, ref) < -100.0
    assert _nmse_db(_mode_product(x, 256, None, ((0, 0),), cfg), ref) > -80.0


# ----------------------------------------------------------------------
# the CUDA branches: which launch mode each input reaches
# ----------------------------------------------------------------------

class _Fn:
    """A launch function of a _Lib: records its arguments, returns 0."""

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
    for mod in (fused_ls, int8_mm):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    return calls


def _ls_calls(x, rx, k):
    xq = x[:, :, :CFG.len_ltf // 4].contiguous()
    pp = pair_planes(rx, x.dtype)
    return {
        "v2": (lambda: ls_planes_v2(CFG, x, k), "ls_v2", 0, 13, 4),
        "v2 seq bf16 ssq": (lambda: ls_planes_v2(
            CFG, xq, k, seq_shard=(3, 4), out_dtype=BF16, with_ssq=True),
            "ls_v2", 0, 13, 4),
        "v1": (lambda: ls_planes_v1(CFG, x, k), "ls_v1", 0, 11, 2),
        "as_planes": (lambda: ls_planes_pallas(CFG, x, k, as_planes=True),
                      "ls_v1", 0, 11, 2),
        "pair": (lambda: ls_pair_kernel(CFG, pp, CFG.num_rx, k), "ls_pair",
                 0, 11, 1),
    }


def _rx():
    """One packet of complex64 time-major rx."""
    rng = np.random.default_rng(4)
    shape = (1, CFG.len_ltf, CFG.num_rx)
    return torch.from_numpy((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)
                             ).astype(np.complex64))


@pytest.mark.parametrize("which", ["v2", "v2 seq bf16 ssq", "v1",
                                   "as_planes", "pair"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_branch_mode_follows_the_input(launches, which, dtype):
    """float32 planes reach the launch as they are (the same tensor, no
    bf16 copy) with the float32 constants and the float32 mode bit (v2
    mode bit 2, v1 bit 1, the per-pair in_f32); bf16 planes the bf16
    constants and no float32 bit."""
    x = torch.from_numpy(_planes(s=2, seed=3)).to(dtype)
    k = ls_sm90_constants(CFG, dtype=dtype)
    call, lib, ptr_arg, mode_arg, bit = _ls_calls(x, _rx(), k)[which]
    call()
    (name, fn, args), = launches
    assert name == lib
    assert args[1] == k.bt.data_ptr()
    if which in ("v2", "v1", "as_planes"):
        assert args[ptr_arg] == x.data_ptr()        # no cast, no copy
    assert bool(args[mode_arg] & bit) == (dtype == F32)


def test_cuda_branch_pair_takes_complex64_as_float32(launches):
    """ls_estimate_pallas on complex64 rx: one float32 layout pass
    (pair_planes) and the per-pair kernel's float32 mode, with float32
    constants built when omitted."""
    rx = _rx()
    before = ls_pair_kernel.launches
    out = ls_estimate_pallas(CFG, rx)
    (name, fn, args), = launches
    assert name == "ls_pair" and args[11] == 1
    assert out.dtype == torch.complex64
    assert ls_pair_kernel.launches == before + 1
    assert pair_planes(rx, F32).dtype == F32
    assert torch.equal(pair_planes(rx, F32).to(BF16), pair_planes(rx))


def test_cuda_branch_sharded_passes_float32_shares(launches):
    """sharded_ls_pallas_v2 on float32 planes: each rank's launch is the
    float32 mode."""
    x = torch.from_numpy(_planes(s=4, seed=6))
    for mode in ("data", "seq"):
        launches.clear()
        sharded.sharded_ls_pallas_v2(
            CFG, make_mesh({mode: 2}, devices=["cpu"] * 2), x, mode=mode)
        assert len(launches) == 2
        assert all(args[13] & 4 for _, _, args in launches)


@pytest.mark.parametrize("planes, consts, err, match", [
    (F32, BF16, TypeError, "float32 planes take"),
    (BF16, F32, TypeError, "bfloat16 planes take"),
    (F32, "f32 (512, 512)", ValueError, r"\(2, 512, 512\)"),
])
def test_cuda_branch_refuses_the_other_dtypes_constants(
        launches, planes, consts, err, match):
    """Constants made for the other input dtype, or float32 constants
    without their two parts, are refused before any launch."""
    x = torch.from_numpy(_planes(s=2, seed=8)).to(planes)
    k = (LsSm90Constants(torch.zeros((512, 512))) if isinstance(consts, str)
         else ls_sm90_constants(CFG, dtype=consts))
    with pytest.raises(err, match=match):
        ls_planes_v2(CFG, x, k)
    assert not launches


@pytest.mark.parametrize("out", [None, BF16])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_branch_matmul_takes_float_operands(launches, dtype, out):
    """matmul_pallas on bf16 and float32 operands launches the bf16
    kernel (csrc/matmul_bf16.cu) or the float32 one (csrc/matmul.cu;
    mode bit 0 the bf16 store, bit 1 float32 operands) on A and B
    transposed (N % 8 here), and counts the launch."""
    a, b = torch.ones((3, 16), dtype=dtype), torch.ones((16, 5), dtype=dtype)
    before = matmul_float.launches
    got = matmul_pallas(a, b, out_dtype=out)
    (name, fn, args), = launches
    assert (name, fn) == (("matmul", "mm_float_launch") if dtype == F32
                          else ("matmul_bf16", "mm_bf16_launch"))
    assert args[3:7] == (3, 5, 16, int(out == BF16) | 2 * int(dtype == F32))
    assert args[0] == a.data_ptr()
    assert got.dtype == (out or F32) and tuple(got.shape) == (3, 5)
    assert matmul_float.launches == before + 1


def test_cuda_branch_matmul_checks(launches):
    """The kernels' row pitch: K % 8 in bf16, K % 4 in float32; empty
    operands launch nothing."""
    with pytest.raises(ValueError, match="K % 8"):
        matmul_pallas(torch.ones((2, 12), dtype=BF16),
                      torch.ones((12, 3), dtype=BF16))
    with pytest.raises(ValueError, match="K % 4"):
        matmul_pallas(torch.ones((2, 6)), torch.ones((6, 3)))
    assert tuple(matmul_pallas(torch.ones((0, 8)),
                               torch.ones((8, 3))).shape) == (0, 3)
    assert not matmul_pallas(torch.ones((2, 0)), torch.ones((0, 3))).any()
    assert not launches


def test_matmul_binding_matches_the_c_signature(monkeypatch):
    """mm_float_launch gets as many arguments as csrc/matmul.cu declares."""
    import re
    from pathlib import Path

    calls = []
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    fn = int8_mm._float_lib().mm_float_launch
    src = (Path(int8_mm.__file__).resolve().parents[2] / "csrc" /
           "matmul.cu").read_text()
    m = re.search(r"int mm_float_launch\(([^)]*)\)", src)
    assert len(fn.argtypes) == len(m.group(1).split(","))
