"""The LS kernels (kernels 1, 3 and 4: ls_planes_v2, ls_planes_pallas /
ls_planes_v1, ls_estimate_pallas) at every num_tx and cp_length a JAX
configuration takes, on the CPU: 512 and 1024 Tx antennas (four and
eight 128-symbol parts a sample) and cyclic prefixes that leave a symbol
off the 16-byte grid TMA strides by (NR's 18 samples at a 256-point FFT,
and 9).

The CUDA kernels run only on the card (``chip_smoke.py`` phase 5o holds
them to these plain versions). Here, on the same numpy planes from a
seed, at S <= 2:

- the plain versions against JAX's Pallas kernels in interpret mode
  (``block_samples=1``): kernel 1 in full mode and as seq ranks, whose
  partials sum to the estimate; kernel 3 in its complex, raw and
  ``as_planes`` forms; kernel 4 on complex64 rx. float32 planes: 1e-5 of
  the largest reference value (float32 against float32, as
  ``test_torch_f32_modes.py``); bf16 planes: <= -45 dB against JAX's
  kernel on the same bf16 planes (JAX rounds its DFT constants to bf16,
  the plain version keeps them float32: about -58 dB apart at Nt 256,
  ``test_torch_serve_widths.py``);
- the per-tile sums of h² (``_ssq_plain``, ``ls_v2_tiles``) at loc 512
  and 1024, full and a seq rank, against the sums taken here by their
  definition, and their total against JAX's (1e-5 relative);
- the general body's data path (``csrc/ls_sm90.cuh``, ``ls_body<0>``:
  the boxes' coordinates on a map whose rows span ``symbol_group``
  symbols, each box loaded from its start rounded down to 16 bytes with
  the next 16 bytes beside it and shifted back, the rotated symbol order
  within a tile, the k-steps, the signs H_nh[p, v] of the parts, the
  despread's bits and ``Rows::at``), rebuilt in float64 from the planes
  and the kernels' constants, against the plain version: -120 dB
  (float32 values summed in another order). At 512 symbols a sample and
  more the rebuilt path is the part transform's (``ls_parts``: Z in the
  planes' dtype, bf16 rounding and all) and one part a tile on Z, held
  to the plain version of the planes whose transform is exactly that Z;
- the wrappers' CUDA branches (the device test made to answer CUDA, the
  library one that records each launch): the new shapes reach the
  launch with their num_tx, loc, sym_len and cp (at 512 symbols a sample
  and more, after the part transform's launch, on its output: fft
  samples a symbol, no cyclic prefix, the ``parts`` mode bit; below, no
  transform), and the shapes no body takes raise by name;
- both packages' ``CSIPredictor.estimate_full`` on one JAX checkpoint of
  a small model at Nt 512 and at BS32 with cp 18: float32 serving, 1e-4
  of the largest value (as ``test_torch_predictor.py``).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.models.predictor import CSIPredictor as JPredictor
from mamimo_tpu.ops.ltf import _hadamard_np as j_hadamard
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_estimate_pallas as j_ls_pair,
    ls_planes_pallas as j_ls_v1,
    ls_planes_pallas_v2 as j_ls_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.models.predictor import CSIPredictor
from mamimo_tpu_torch.ops.kernels import _build, fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    MAX_KERNEL_TX,
    PARTS_MIN_LOC,
    _ls_parts_plain,
    _ssq_plain,
    ls_estimate_pallas,
    ls_kernel_constants,
    ls_pair_kernel,
    ls_planes_pallas,
    ls_planes_v1,
    ls_planes_v2,
    ls_sm90_constants,
    ls_v2_tiles,
    symbol_group,
)
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh

F32, BF16 = torch.float32, torch.bfloat16
REL = 1e-5                    # float32 against float32, of the scale
BF16_DB = -45.0               # bf16 planes against JAX's bf16 kernel
REBUILD_DB = -120.0           # the general body's layout, rebuilt

# (num_tx, num_rx, cp_length): the wide arrays, and the cyclic prefixes
# off the 16-byte grid (bf16 rows of 4 and 8 symbols, float32 of 2 and 4)
CASES = {"nt512": (512, 2, 64), "nt1024": (1024, 2, 64),
         "nt8 cp18": (8, 2, 18), "nt32 cp18": (32, 2, 18),
         "nt8 cp9": (8, 2, 9), "nt32 cp9": (32, 2, 9)}


def _cfgs(case):
    nt, nr, cp = CASES[case]
    return (SimConfig(num_tx=nt, num_rx=nr, cp_length=cp),
            JSimConfig(num_tx=nt, num_rx=nr, cp_length=cp))


def _planes(cfg, s, seed, nsym=None):
    n = (nsym or cfg.num_tx) * cfg.sym_len
    return np.random.default_rng(seed).standard_normal(
        (2, s, n)).astype(np.float32)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    if np.iscomplexobj(ref):
        got, ref = (np.stack([t.real, t.imag]) for t in (got, ref))
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    if np.iscomplexobj(ref):
        got, ref = (np.stack([t.real, t.imag]) for t in (got, ref))
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    with np.errstate(divide="ignore"):
        return 10 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref ** 2))


def _cplx(h):
    return torch.complex(h[0].float(), h[1].float()).numpy()


def _jax_v2(jcfg, x, s, seq=None, jdt=jnp.float32):
    """JAX's kernel 1 in interpret mode, block_samples=1, densified to
    (S, num_tx, C); with seq = (i, n) rank i's rectangular K."""
    b, k = j_v2_constants(jcfg, 1, dtype=jdt)
    if seq is not None:
        i, n = seq
        loc = jcfg.num_tx // n
        p = j_hadamard(jcfg.num_tx).astype(np.float32)
        k = jnp.asarray(p[:, i * loc:(i + 1) * loc], jdt)
    h, _ = j_ls_v2(jcfg, jnp.asarray(x, jdt), (b, k), block_samples=1,
                   interpret=True)
    return np.asarray(j_v2_to_complex(jcfg, h.astype(jnp.float32), s))


# ----------------------------------------------------------------------
# the plain versions against JAX's kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel1_matches_jax(case, dtype):
    """Kernel 1, full mode, on float32 and on bf16 planes."""
    cfg, jcfg = _cfgs(case)
    x = _planes(cfg, 2, seed=1)
    if dtype == "bf16":
        xt = torch.from_numpy(x).to(BF16)
        ref = _jax_v2(jcfg, xt.float().numpy(), 2, jdt=jnp.bfloat16)
        got = ls_planes_v2(cfg, xt)
        assert _db(_cplx(got), ref) <= BF16_DB
    else:
        ref = _jax_v2(jcfg, x, 2)
        got = ls_planes_v2(cfg, torch.from_numpy(x))
        assert got.dtype == F32
        assert tuple(got.shape) == (2, 2, cfg.num_tx, cfg.num_carriers)
        _close(_cplx(got), ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["nt512", "nt1024", "nt32 cp18",
                                  "nt32 cp9"])
def test_kernel1_seq_partials_match_jax(case, n):
    """Kernel 1's seq mode: rank 0's and rank n-1's partials against
    JAX's rectangular K, and the n partials summing to the estimate."""
    cfg, jcfg = _cfgs(case)
    loc, w = cfg.num_tx // n, cfg.num_tx // n * cfg.sym_len
    x = _planes(cfg, 2, seed=2)
    parts = [ls_planes_v2(cfg, torch.from_numpy(x[:, :, i * w:(i + 1) * w]
                                                .copy()), seq_shard=(i, n))
             for i in range(n)]
    for i in (0, n - 1):
        _close(_cplx(parts[i]),
               _jax_v2(jcfg, x[:, :, i * w:(i + 1) * w], 2, (i, n)))
    assert loc == fused_ls.seq_shard_symbols(cfg, (1, n))
    _close(_cplx(sum(parts)), _cplx(ls_planes_v2(cfg, torch.from_numpy(x))))


@pytest.mark.parametrize("case, form", [(c, "complex") for c in CASES]
                         + [(c, f) for c in ("nt1024", "nt32 cp9")
                            for f in ("raw", "as_planes")])
def test_kernel3_matches_jax(case, form):
    """Kernel 3 (v1) on float32 planes in its three forms; bf16 planes
    through the complex form within BF16_DB."""
    cfg, jcfg = _cfgs(case)
    x = _planes(cfg, 2, seed=3)
    opts = {"raw": form == "raw", "as_planes": form == "as_planes"}
    ref = j_ls_v1(jcfg, jnp.asarray(x), block_samples=1, interpret=True,
                  **opts)
    got = ls_planes_pallas(cfg, torch.from_numpy(x), block_samples=1, **opts)
    if form == "raw":
        for g, r in zip(got, ref):
            assert g.dtype == F32
            _close(g, r)
    elif form == "as_planes":
        assert tuple(got.shape) == (2, 2, cfg.num_tx, cfg.num_carriers)
        _close(got, ref)
    else:
        _close(got.numpy(), ref)
        xb = torch.from_numpy(x).to(BF16)
        jb = j_ls_v1(jcfg, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                     block_samples=1, interpret=True)
        assert _db(ls_planes_pallas(cfg, xb).numpy(), np.asarray(jb)) \
            <= BF16_DB


@pytest.mark.parametrize("case", ["nt512", "nt1024", "nt32 cp18",
                                  "nt8 cp9"])
def test_kernel4_matches_jax(case):
    """Kernel 4 on complex64 rx of one packet (JAX's float32 planes)."""
    cfg, jcfg = _cfgs(case)
    rng = np.random.default_rng(4)
    shape = (1, cfg.len_ltf, cfg.num_rx)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.asarray(j_ls_pair(jcfg, jnp.asarray(rx), interpret=True))
    got = ls_estimate_pallas(cfg, torch.from_numpy(rx))
    assert tuple(got.shape) == (1, cfg.num_carriers, cfg.num_tx,
                                cfg.num_rx)
    _close(got.numpy(), ref)


# ----------------------------------------------------------------------
# the per-tile sums of h² at 4 and 8 parts a sample
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case, seq", [("nt512", None), ("nt1024", None),
                                       ("nt1024", (1, 2))])
def test_ssq_tiles_at_nt512_and_1024(case, seq):
    """Kernel 1's Σh² at loc = 128·nh: tile s·nh + p sums rows a·loc +
    p·128 .. + 127 of sample s over a seq rank's n copies; in full mode
    the total is JAX's sums / 8."""
    cfg, jcfg = _cfgs(case)
    s = 2
    loc = cfg.num_tx if seq is None else cfg.num_tx // seq[1]
    x = _planes(cfg, s, seed=5, nsym=loc)
    h, ssq = ls_planes_v2(cfg, torch.from_numpy(x), seq_shard=seq,
                          with_ssq=True)
    nh, n = loc // 128, cfg.num_tx // loc
    assert ls_v2_tiles(s, loc) == s * nh
    assert tuple(ssq.shape) == (s * nh, 2, cfg.num_carriers)
    hn = h.double().numpy()
    want = np.zeros((s * nh, 2, cfg.num_carriers))
    for smp in range(s):
        for p in range(nh):
            for a in range(n):
                r = a * loc + p * 128
                want[smp * nh + p] += (hn[:, smp, r:r + 128] ** 2).sum(1)
    np.testing.assert_allclose(ssq.double().numpy(), want, rtol=1e-5)
    assert torch.equal(ssq, _ssq_plain(h, loc))
    if seq is None:
        _, jssq = j_ls_v2(jcfg, jnp.asarray(x), block_samples=1,
                          interpret=True, with_ssq=True)
        np.testing.assert_allclose(
            float(ssq.double().sum()),
            float(np.asarray(jssq, np.float64).sum()) / 8.0, rtol=1e-5)


# ----------------------------------------------------------------------
# the general body's layout (ls_sm90.cuh, ls_body<0>), rebuilt
# ----------------------------------------------------------------------

def _box_log_symbols(log_loc):
    return 0 if log_loc == 0 else (1 if log_loc <= 5 else 3)


def _rebuild_general(cfg, x, loc, rank, esize, parts=False):
    """h (S, num_tx, C) complex128 as ls_body<0> and the v2 store compute
    it from the planes x (2, S, loc·sym_len): per tile (part p of a
    sample, or samples) and k-step, the 16 boxes of the map whose rows
    span g = symbol_group symbols, each at (m·sym_len + cp + k-chunk,
    part·128/g + q, sample, plane), loaded from that start rounded down
    to 16 bytes with the next 16 bytes beside and shifted back where g >
    1; the k-step's 128 rows times the constants' rows; the nh parts
    summed with H_nh's signs; the despread over the tile-row bits the
    boxes put the symbols on; each row placed by Rows::at and stored n
    times with H_n[a, rank]. With ``parts`` x is the part transform's Z
    (2, S, loc·fft): symbols of fft samples, no cyclic prefix, and each
    tile runs its own part p alone, with the sign +1."""
    ke, al = 128 // esize, 16 // esize       # a k-step, 16 bytes
    s = x.shape[1]
    cp_ = -(-cfg.num_carriers // 128) * 128
    bt = ls_kernel_constants(cfg, dtype=torch.float32).double().numpy()
    sym_len, cpl = (cfg.fft_length, 0) if parts \
        else (cfg.sym_len, cfg.cp_length)
    g_sym = symbol_group(sym_len, esize)
    log_loc, log_g = loc.bit_length() - 1, g_sym.bit_length() - 1
    assert log_g <= min(log_loc, 7)
    log_nh = max(log_loc - 7, 0)
    nh, log_tl = 1 << log_nh, min(log_loc, 7)
    log_bs = min(_box_log_symbols(log_tl), log_tl - log_g)
    bs, tq, nsb = 1 << log_bs, log_tl - log_g, log_tl - log_bs
    log_spt = 7 - log_tl
    tiles = s << log_nh if log_nh else -(-s // (1 << log_spt))
    nk0 = 2 * cfg.fft_length // ke
    row_len = g_sym * sym_len                    # a map row's elements
    xr = x.astype(np.float64).reshape(2, s, loc // g_sym, row_len)
    n = cfg.num_tx // loc
    hmat = j_hadamard(n)
    out = np.zeros((s, cfg.num_tx, cfg.num_carriers), np.complex128)
    for t in range(tiles):
        s0, part = (t >> log_nh) << log_spt, t & (nh - 1)
        acc = np.zeros((128, 2 * cp_))
        for half in [part] if parts else range(nh):
            sign = -1.0 if not parts and bin(part & half).count("1") & 1 \
                else 1.0
            for k0 in range(nk0):
                plane = int(k0 >= nk0 // 2)
                col = cpl + (k0 % (nk0 // 2)) * ke
                stage = np.zeros((128, ke))
                for g in range(16):
                    a, bb = g & ((1 << nsb) - 1), g >> nsb
                    v = a << log_bs
                    o = (v >> tq) * sym_len + col
                    a0 = o - o % al if log_g else o  # a box starts on 16 B
                    c1 = (half << (7 - log_g)) + (v & ((1 << tq) - 1))
                    c2 = s0 + (bb << (3 - log_bs))
                    for rib in range(8):
                        smp, mrow = c2 + (rib >> log_bs), c1 + (rib & (bs - 1))
                        if smp >= s:
                            continue                 # the map's zero fill
                        raw = xr[plane, smp, mrow, a0:a0 + ke + al]
                        stage[8 * g + rib] = raw[o - a0:o - a0 + ke]
                acc += sign * stage @ bt[k0 * ke:(k0 + 1) * ke]
        # the despread: symbol bits on tile-row bits 0 (pair), 1 and 2
        # (quad), then 3 .. (the box index)
        bits = ([0] if log_bs >= 1 else []) + ([1, 2] if log_bs == 3
                                               else []) \
            + [3 + k for k in range(log_tl - log_bs)]
        for b in bits:
            r = np.arange(128)
            lo = r[(r >> b) & 1 == 0]
            hi = lo | (1 << b)
            acc[lo], acc[hi] = acc[lo] + acc[hi], acc[lo] - acc[hi]
        h = acc[:, :cfg.num_carriers] + 1j * acc[:, cp_:cp_
                                                 + cfg.num_carriers]
        for row in range(128):                       # Rows::at
            rib, j = row & 7, row >> 3
            aa, bb = j & ((1 << nsb) - 1), j >> nsb
            v = (aa << log_bs) + (rib & (bs - 1))
            smp = s0 + (bb << (3 - log_bs)) + (rib >> log_bs)
            sym = (part << 7) + (v >> tq) + ((v & ((1 << tq) - 1)) << log_g)
            if smp < s:
                for c in range(n):
                    out[smp, c * loc + sym] = hmat[c, rank] * h[row]
    return out


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("case, seq", [
    ("nt512", None), ("nt1024", (1, 2)), ("nt8 cp18", None),
    ("nt32 cp18", None), ("nt8 cp9", None), ("nt32 cp9", (1, 2)),
    ("nt512", (3, 4))])
def test_general_body_layout_rebuilds_the_estimate(case, seq, esize):
    """The general body's index arithmetic at each new shape and both
    input widths (bf16 rows of 1, 4 or 8 symbols, float32 of 1, 2 or 4)
    gives the plain version's estimate. At loc >= 512 the path is the
    part transform's Z in the input's dtype (its bf16 rounding kept),
    then one part a tile on Z, held to the plain version of the planes
    whose transform is exactly that Z."""
    cfg, _ = _cfgs(case)
    loc = cfg.num_tx if seq is None else cfg.num_tx // seq[1]
    x = _planes(cfg, 2 if loc > 8 else 17, seed=6, nsym=loc)
    parts = loc >= PARTS_MIN_LOC
    if parts:
        z = _ls_parts_plain(cfg, torch.from_numpy(x).to(
            BF16 if esize == 2 else F32), loc).double().numpy()
        x = _unparts(cfg, z, loc)
        got = _rebuild_general(cfg, z, loc, 0 if seq is None else seq[0],
                               esize, parts=True)
    else:
        got = _rebuild_general(cfg, x, loc, 0 if seq is None else seq[0],
                               esize)
    ref = _cplx(ls_planes_v2(cfg, torch.from_numpy(x), seq_shard=seq))
    assert _db(got, ref) <= REBUILD_DB


def _unparts(cfg, z, loc):
    """The planes (2, S, loc·sym_len) float32 whose part transform is z
    (2, S, loc·fft), float64: Y_v = Σ_p H_nl[v, p] Z_p / nl (H_nl H_nl =
    nl I), zeros in the cyclic prefix, which the LS never reads."""
    nl, fft, s = loc // 128, cfg.fft_length, z.shape[1]
    y = np.einsum("vp,aspmf->asvmf", j_hadamard(nl).astype(np.float64),
                  z.reshape(2, s, nl, 128, fft)) / nl
    x = np.zeros((2, s, nl, 128, cfg.sym_len))
    x[..., cfg.cp_length:cfg.cp_length + fft] = y
    return x.astype(np.float32).reshape(2, s, loc * cfg.sym_len)


# ----------------------------------------------------------------------
# the CUDA branches
# ----------------------------------------------------------------------

class _Lib:
    """A built library's stand-in: each launch function records (library,
    function, arguments) and returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        def launch(*args):
            self.calls.append((self.name, fn, args))
            return 0
        setattr(self, fn, launch)
        return launch


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    return calls


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_branches_take_the_new_shapes(launches, case, dtype):
    """Each LS wrapper launches at the new shapes, passing num_tx, the
    symbols of a sample, sym_len and cp_length as they are (the library
    picks its body from them); a seq rank its loc. At 512 symbols a
    sample and more the part transform launches first, and the LS launch
    reads its output: fft samples a symbol, no cyclic prefix, the
    ``parts`` mode bit; below, no transform launches."""
    cfg, _ = _cfgs(case)
    k = ls_sm90_constants(cfg, dtype=dtype)
    nt, L = cfg.num_tx, cfg.len_ltf
    x = torch.zeros((2, 2, L), dtype=dtype)
    ls_planes_v2(cfg, x, k)
    ls_planes_v1(cfg, x, k)
    ls_pair_kernel(cfg, x, 2, k)
    n = 2 if nt // 2 >= symbol_group(cfg.sym_len, x.element_size()) else 1
    ls_planes_v2(cfg, x[:, :, :L // n].contiguous(), k, seq_shard=(n - 1, n),
                 out_dtype=BF16, with_ssq=True)
    full, seq = nt >= PARTS_MIN_LOC, nt // n >= PARTS_MIN_LOC
    transforms = [(t[1], t[2]) for t in launches if t[0] == "ls_parts"]
    assert [a[3] for _, a in transforms] == [nt] * (3 * full) \
        + [nt // n] * seq
    (_, f2, a2), (_, f1, a1), (_, fp, ap), (_, fs, as_) = [
        t for t in launches if t[0] != "ls_parts"]
    geo = (cfg.sym_len, cfg.cp_length, cfg.fft_length)
    zgeo = (cfg.fft_length, 0, cfg.fft_length)
    assert (f2, a2[4:8], a2[9:12]) == ("ls_planes_v2_launch",
                                       (2, nt, nt, 0), zgeo if full else geo)
    assert a2[13] == 4 * (dtype == F32) | 8 * full
    assert (f1, a1[4:7], a1[7:10]) == ("ls_planes_v1_launch", (2, 8, nt),
                                       zgeo if full else geo)
    assert a1[11] & 4 == 4 * full
    assert (fp, ap[3:6], ap[7:10]) == ("ls_pair_launch", (2, 2, nt),
                                       zgeo if full else geo)
    assert ap[11] == int(dtype == F32) | 2 * full
    assert (fs, as_[4:8], as_[13]) == ("ls_planes_v2_launch",
                                       (2, nt, nt // n, n - 1),
                                       3 | 4 * (dtype == F32) | 8 * seq)


@pytest.mark.parametrize("nt, cp, nsym, dtype, match", [
    (4096, 64, None, BF16, "power of 2 <= 2048"),
    (4096, 18, None, F32, "power of 2 <= 2048"),
    (4, 9, None, BF16, "at least 8 symbols a sample, got 4"),
    (4, 18, 2, BF16, "at least 4 symbols a sample, got 2"),
    (2, 9, None, F32, "at least 4 symbols a sample, got 2"),
])
def test_cuda_branches_refuse_by_name(launches, nt, cp, nsym, dtype, match):
    """What no body takes raises, naming the limit: more than
    MAX_KERNEL_TX antennas, and fewer symbols a sample than a map row
    spans."""
    cfg = SimConfig(num_tx=nt, num_rx=1, cp_length=cp)
    k = ls_sm90_constants(cfg, dtype=dtype)
    x = torch.zeros((2, 1, (nsym or nt) * cfg.sym_len), dtype=dtype)
    seq = None if nsym is None else (0, nt // nsym)
    with pytest.raises(ValueError, match=match):
        ls_planes_v2(cfg, x, k, seq_shard=seq)
    assert not launches
    assert MAX_KERNEL_TX == 2048


def test_symbol_group():
    """A map row spans the least power of 2 of symbols that is 16-byte
    aligned: BS32's 320 samples alone, NR's 274 four (bf16) or two
    (float32), 265 eight or four."""
    assert [symbol_group(n, e) for n in (320, 274, 265) for e in (2, 4)] \
        == [1, 1, 4, 2, 8, 4]


# ----------------------------------------------------------------------
# sharded, and serving through both packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode, ranks", [("data", 2), ("seq", 2),
                                         ("seq", 4)])
def test_sharded_at_nt1024(mode, ranks):
    """sharded_ls_pallas_v2 at Nt 1024 on CPU ranks against the unsharded
    kernel 1."""
    cfg, _ = _cfgs("nt1024")
    x = torch.from_numpy(_planes(cfg, 2, seed=8))
    ref = ls_planes_v2(cfg, x)
    got = sharded.sharded_ls_pallas_v2(
        cfg, make_mesh({mode: ranks}, devices=["cpu"] * ranks), x, mode=mode)
    _close(torch.view_as_real(got), torch.view_as_real(
        torch.complex(ref[0], ref[1])))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One JAX-written checkpoint at hidden (64, 64) per configuration,
    served by both packages on the CPU."""
    out = {}
    for key, jcfg in (("nt512", JSimConfig(num_tx=512, num_rx=2)),
                      ("bs32 cp18", JSimConfig(cp_length=18))):
        d = tmp_path_factory.mktemp("model")
        jtcfg = JTrainConfig(hidden=(64, 64))
        jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
            jax.random.PRNGKey(5), jcfg, jtcfg))
        jckpt.save_checkpoint(str(d / "best"), jcfg, jtcfg, jp, jb)
        out[key] = (JPredictor(str(d)), CSIPredictor(str(d), device="cpu"))
    return out


@pytest.mark.parametrize("key", ["nt512", "bs32 cp18"])
def test_estimate_full_matches_jax(models, key):
    """The serving call at Nt 512 and at BS32 with NR's cyclic prefix, on
    one packet: both estimates within float32 of JAX's."""
    jpred, pred = models[key]
    cfg = pred.cfg
    assert (cfg.num_tx, cfg.cp_length) == ((512, 64) if key == "nt512"
                                           else (32, 18))
    s = cfg.num_rx
    flat = np.random.default_rng(9).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)
    ref = jpred.estimate_full(flat)
    got = pred.estimate_full(flat)
    for g, r in zip(got, ref):
        assert g.shape == (s, cfg.num_tx, cfg.num_carriers)
        _close(g, r, 1e-4)
