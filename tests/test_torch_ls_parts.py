"""The LS kernels' part transform (``csrc/ls_parts.cu``, wrapper
``ops/kernels/fused_ls.py::ls_parts``) and the LS kernels above 1024 Tx
antennas, on the CPU.

At loc = 128·nl symbols a sample the LS kernels first write Z_p = Σ_v
H_nl[p, v]·Y_v (Y_v part v's 128 symbols, the cyclic prefix dropped) and
then run one part a tile. The kernel runs only on the card
(``chip_smoke.py`` phase 5o holds it to the plain version bit for bit).
Here, at S <= 2:

- the plain version against its definition in float64 at nl = 2, 4, 8
  and 16, on bf16 and float32 planes: within float32 of the float64
  sums, and bit for bit the float32 sum taken in the order v = 0 … nl − 1
  (numpy, float32), rounded once to bf16 for bf16 planes;
- a seq rank's parts: part p_hi·nl + p_lo of the whole transform over a
  rank's nl parts is H_n[p_hi, r]·Z_{p_lo}, the sign the kernels' stores
  give a rank's partial;
- the CUDA branch (the device test made to answer CUDA, a library that
  records each launch): the launch's arguments and the mode of float32
  planes, and the shapes the kernel does not take refused by name;
- Nt 2048, the width this transform opens: kernel 1's plain version
  against JAX's Pallas kernel in interpret mode at S = 1, and the three
  LS wrappers' CUDA branches launching the transform, then their kernel
  on its output in the ``parts`` mode.
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
    ls_planes_pallas_v2 as j_ls_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import _build, fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    MAX_KERNEL_TX,
    PARTS_MIN_LOC,
    ls_pair_kernel,
    ls_parts,
    ls_planes_v1,
    ls_planes_v2,
    ls_sm90_constants,
)

F32, BF16 = torch.float32, torch.bfloat16


def _cfg(nt, cp=64):
    return SimConfig(num_tx=nt, num_rx=1, cp_length=cp)


def _planes(cfg, s, seed, loc):
    return np.random.default_rng(seed).standard_normal(
        (2, s, loc * cfg.sym_len)).astype(np.float32)


def _parts_f32(cfg, y32, nl):
    """The float32 sums in the kernel's order: y32 (2, S, nl, 128, fft)
    float32; Z_p = ((0 ± Y_0) ± Y_1) ± …, each step rounded to float32."""
    h = j_hadamard(nl)
    z = np.zeros(y32.shape, np.float32)
    for v in range(nl):
        for p in range(nl):
            z[:, :, p] = z[:, :, p] + np.float32(h[p, v]) * y32[:, :, v]
    return z


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("nl, cp", [(2, 64), (4, 18), (8, 64), (16, 9)])
def test_parts_plain_matches_its_definition(nl, cp, dtype):
    """The plain transform: within float32 of the float64 definition, and
    bit for bit the float32 sum in the order of v, rounded once."""
    cfg = _cfg(128 * nl, cp)
    loc, fft = 128 * nl, cfg.fft_length
    x = torch.from_numpy(_planes(cfg, 2, 11, loc)).to(dtype)
    got = ls_parts(cfg, x)
    assert got.dtype == dtype and tuple(got.shape) == (2, 2, loc * fft)
    y = x.float().numpy().reshape(2, 2, nl, 128, cfg.sym_len)[
        ..., cp:cp + fft]
    want64 = np.einsum("pv,asvmf->aspmf", j_hadamard(nl).astype(np.float64),
                       y.astype(np.float64))
    g = got.float().numpy().reshape(2, 2, nl, 128, fft)
    tol = 2.0 ** -7 if dtype == BF16 else 1e-6
    np.testing.assert_allclose(g, want64, rtol=0,
                               atol=tol * np.abs(want64).max())
    want = torch.from_numpy(_parts_f32(cfg, y, nl)).to(dtype)
    assert torch.equal(got.view(2, 2, nl, 128, fft), want)


@pytest.mark.parametrize("nt, n, rank", [(1024, 2, 1), (2048, 4, 2),
                                          (2048, 2, 0)])
def test_seq_rank_parts_carry_the_rank_sign(nt, n, rank):
    """Rank r of n holds nl = nt/(128 n) parts; the whole transform's part
    p_hi·nl + p_lo over the rank's symbols (H_nh's columns r·nl …) is
    H_n[p_hi, r] times the rank's own part p_lo."""
    cfg = _cfg(nt)
    loc, nh = nt // n, nt // 128
    nl = loc // 128
    x = torch.from_numpy(_planes(cfg, 1, 12, loc))
    z = ls_parts(cfg, x, loc).double().numpy().reshape(2, 1, nl, 128, -1)
    y = x.double().numpy().reshape(2, 1, nl, 128, cfg.sym_len)[
        ..., cfg.cp_length:cfg.cp_length + cfg.fft_length]
    hnh = j_hadamard(nh).astype(np.float64)
    whole = np.einsum("pv,asvmf->aspmf", hnh[:, rank * nl:(rank + 1) * nl],
                      y)
    hn = j_hadamard(n)
    for p in range(nh):
        np.testing.assert_allclose(whole[:, :, p],
                                   hn[p // nl, rank] * z[:, :, p % nl],
                                   rtol=0, atol=1e-5)


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
@pytest.mark.parametrize("nt, cp", [(512, 64), (2048, 18)])
def test_parts_cuda_branch_launches(launches, nt, cp, dtype):
    """The transform's launch: planes and an output of the planes' dtype,
    S, loc, the geometry as it is, and the float32 flag; counted."""
    cfg = _cfg(nt, cp)
    x = torch.zeros((2, 3, cfg.len_ltf), dtype=dtype)
    before = ls_parts.launches
    z = ls_parts(cfg, x)
    (lib, fn, args), = launches
    assert (lib, fn) == ("ls_parts", "ls_parts_launch")
    assert args[0] == x.data_ptr() and args[1] == z.data_ptr()
    assert args[2:8] == (3, nt, cfg.sym_len, cp, cfg.fft_length,
                         int(dtype == F32))
    assert z.dtype == dtype and tuple(z.shape) == (2, 3,
                                                   nt * cfg.fft_length)
    assert ls_parts.launches == before + 1


@pytest.mark.parametrize("nt, match", [
    (256, "512 to 2048 symbols"), (4096, "512 to 2048 symbols")])
def test_parts_cuda_branch_refuses_by_name(launches, nt, match):
    """The kernel takes 4, 8 or 16 parts a sample: fewer or more raise
    before any launch."""
    cfg = _cfg(nt)
    with pytest.raises(ValueError, match=match):
        ls_parts(cfg, torch.zeros((2, 1, cfg.len_ltf), dtype=BF16))
    assert not launches


# ----------------------------------------------------------------------
# Nt 2048
# ----------------------------------------------------------------------

def test_kernel1_at_nt2048_matches_jax():
    """Kernel 1's plain version at 2048 Tx antennas (16 parts a sample)
    against JAX's kernel in interpret mode, one sample, float32: 1e-5 of
    the largest value."""
    cfg = SimConfig(num_tx=2048, num_rx=1)
    jcfg = JSimConfig(num_tx=2048, num_rx=1)
    x = _planes(cfg, 1, 13, 2048)
    b, k = j_v2_constants(jcfg, 1)
    h, _ = j_ls_v2(jcfg, jnp.asarray(x), (b, k), block_samples=1,
                   interpret=True)
    ref = np.asarray(j_v2_to_complex(jcfg, h, 1))
    got = ls_planes_v2(cfg, torch.from_numpy(x))
    got = torch.complex(got[0], got[1]).numpy()
    assert got.shape == ref.shape == (1, 2048, cfg.num_carriers)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_nt2048_cuda_branches_run_the_parts(launches, dtype):
    """At 2048 antennas each LS wrapper launches the part transform, then
    its kernel on the transform's output: symbols of fft samples, no
    cyclic prefix, the ``parts`` mode bit."""
    assert MAX_KERNEL_TX == 2048 and PARTS_MIN_LOC == 512
    cfg = SimConfig(num_tx=2048, num_rx=1)
    k = ls_sm90_constants(cfg, dtype=dtype)
    x = torch.zeros((2, 2, cfg.len_ltf), dtype=dtype)
    ls_planes_v2(cfg, x, k)
    ls_planes_v1(cfg, x, k)
    ls_pair_kernel(cfg, x, 1, k)
    fns = [(lib, fn) for lib, fn, _ in launches]
    parts = ("ls_parts", "ls_parts_launch")
    assert fns == [parts, ("ls_v2", "ls_planes_v2_launch"),
                   parts, ("ls_v1", "ls_planes_v1_launch"),
                   parts, ("ls_pair", "ls_pair_launch")]
    f32 = int(dtype == F32)
    geo = (cfg.fft_length, 0, cfg.fft_length)
    (_, _, p), (_, _, a2), (_, _, _), (_, _, a1), (_, _, _), (_, _, ap) = \
        launches
    assert a2[0] == p[1]                  # the kernel reads the output
    assert a2[9:12] == geo and a2[13] == 4 * f32 | 8
    assert a1[7:10] == geo and a1[11] == 2 * f32 | 4
    assert ap[7:10] == geo and ap[11] == f32 | 2
