"""The port's int8 GEMM (mamimo_tpu_torch.ops.kernels.int8_mm) at the
tile edges of its Hopper kernel (csrc/int8_mm.cu: 128-row tiles, 128 or
256 output columns, 128-byte k-steps; a resident slab of Bt for
K <= 1024, a ring of both operands above), on the CPU.

The CUDA kernel runs only on the card, where chip_smoke.py holds it bit
for bit to the float64 plain version. Here that plain version (the CPU
branch of matmul_pallas and matmul_int8) is held to JAX's matmul_pallas
in interpret mode on the same numpy operands, exactly (integer sums),
at M in {1, 127, 129, 257}, N in {8, 234, 264} and K in {16, 1040}
with the ±127 extremes in place; the wrapper's CUDA branch (its device
test made to answer CUDA, the launch cut off before any build) is held
to the operands it refuses; and _build.sass_counts, which the chip run
uses to require IGMMA and no IMMA in the kernel, is held to a short
canned ``cuobjdump -sass`` listing.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.ops.pallas.int8_mm import matmul_pallas as j_matmul_pallas
from mamimo_tpu_torch.ops.kernels import _build, int8_mm
from mamimo_tpu_torch.ops.kernels.int8_mm import matmul_int8, matmul_pallas


def _operands(m, k, n, seed):
    """Random int8 A (m, k) and B (k, n) with the extremes: A's first
    row +127 and last row −127, B's first column −127 and last +127."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    a[0], a[-1] = 127, -127
    b[:, 0], b[:, -1] = -127, 127
    return a, b


@pytest.mark.parametrize("k", [16, 1040])
@pytest.mark.parametrize("n", [8, 234, 264])
@pytest.mark.parametrize("m", [1, 127, 129, 257])
def test_plain_matches_jax_at_tile_edges(m, n, k):
    """Exact against JAX's kernel in interpret mode (its 128-row blocks
    pad M), in the (K, N) form and the transposed (N, K) form the card's
    path takes; the extremes' products sum to ±127²·K exactly."""
    a, b = _operands(m, k, n, seed=m * 7 + n + k)
    ref = np.asarray(j_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                     block_m=128))
    assert ref.dtype == np.int32 and ref.shape == (m, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = matmul_pallas(ta, tb)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        matmul_int8(ta, tb.T.contiguous()).numpy(), ref)
    if m > 1:
        assert ref[-1, 0] == 127 * 127 * k       # (−127)·(−127), K terms
        assert ref[-1, -1] == -127 * 127 * k


class _Stop(Exception):
    pass


@pytest.fixture
def kernel_branch(monkeypatch):
    """The wrapper's device test answers CUDA and any library build stops
    the call, so the CUDA branch runs up to the launch."""
    monkeypatch.setattr(int8_mm, "on_cuda", lambda *t: True)

    def no_build(name, defines=()):
        raise _Stop(name)

    monkeypatch.setattr(int8_mm._build, "library", no_build)


def _misaligned(m, k):
    """A contiguous (m, k) int8 tensor whose data starts one byte past a
    16-byte boundary."""
    buf = torch.zeros(m * k + 32, dtype=torch.int8)
    off = (-buf.data_ptr()) % 16 + 1
    return buf[off:off + m * k].view(m, k)


@pytest.mark.parametrize("case", ["k_not_16", "k_too_big", "a_misaligned",
                                  "bt_misaligned"])
def test_kernel_branch_refuses(kernel_branch, case):
    """K % 16 != 0, K >= 2^17 and operands off a 16-byte boundary are
    refused before any build or launch."""
    ok = lambda m, k: torch.ones((m, k), dtype=torch.int8)  # noqa: E731
    a, bt = {
        "k_not_16": (ok(4, 40), ok(8, 40)),
        "k_too_big": (ok(2, 1 << 17), ok(8, 1 << 17)),
        "a_misaligned": (_misaligned(4, 64), ok(8, 64)),
        "bt_misaligned": (ok(4, 64), _misaligned(8, 64)),
    }[case]
    if case.endswith("misaligned"):
        assert min(a.data_ptr() % 16, bt.data_ptr() % 16) == 0
        assert max(a.data_ptr() % 16, bt.data_ptr() % 16) != 0
    before = matmul_int8.launches
    with pytest.raises(ValueError, match="K % 16|16-byte"):
        matmul_int8(a, bt)
    assert matmul_int8.launches == before


@pytest.mark.parametrize("m,n,k", [(0, 8, 64), (4, 0, 64), (4, 8, 0)])
def test_kernel_branch_empty_counts_no_launch(kernel_branch, m, n, k):
    """M = 0 or N = 0: an empty (M, N) int32 result; K = 0: zeros. No
    library is built and no launch is counted."""
    before = matmul_int8.launches
    out = matmul_int8(torch.ones((m, k), dtype=torch.int8),
                      torch.ones((n, k), dtype=torch.int8))
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, n)
    assert not out.any()
    assert matmul_int8.launches == before


def test_kernel_branch_reaches_the_launch(kernel_branch):
    """Well-formed operands reach the int8_mm library (cut off at its
    build), through matmul_pallas's transpose too."""
    a = torch.ones((3, 48), dtype=torch.int8)
    with pytest.raises(_Stop, match="int8_mm"):
        matmul_int8(a, torch.ones((5, 48), dtype=torch.int8))
    with pytest.raises(_Stop, match="int8_mm"):
        matmul_pallas(a, torch.ones((48, 5), dtype=torch.int8))


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119int8_mm_kernel_slabE14CUtensorMap_stS0_Piiiii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
        /*0f30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;  /* 0x00e0000004187df3 */
        /*0f40*/                   IGMMA.64x128x32.S8.S8 R88, gdesc[UR8], R88, gsb0 ;  /* 0x00e0000008587df3 */
        /*0f50*/              @!P0 IGMMA.64x128x32.S8.S8 R24, gdesc[UR12], R24 ;  /* 0x00e000000c187df3 */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_119int8_mm_kernel_ringE14CUtensorMap_stS0_Piiii
        /*0100*/                   IGMMA.64x256x32.S8.S8 R24, gdesc[UR4], R24 ;  /* 0x00e0000004187df3 */
        /*0110*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;  /* 0x00000000000079b4 */
\t\tFunction : _Z13old_int8_mmPKaS0_Piiii
        /*0200*/                   IMMA.16816.S8.S8 R4, R8.ROW, R12.COL, R4 ;  /* 0x000000000c04723c */
        /*0210*/                   IMMA.16816.S8.S8 R16, R8.ROW, R14.COL, R16 ;  /* 0x000000000e10723c */
\t\tFunction : _Z9ls_kernelPKfPf
        /*0300*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;  /* 0x0000000004187df3 */
        /*0310*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x000000000c04723c */
"""


def test_sass_counts_counts_integer_and_float_mma(monkeypatch, tmp_path):
    """IGMMA, IMMA, HGMMA and HMMA are counted per kernel from the
    listing (predicated instructions included, other opcodes and the
    header lines not); a kernel is matched by a substring of its
    mangled name."""
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=SASS, stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build, "_target", lambda name: tmp_path / name)
    got = _build.sass_counts("int8_mm", ("int8_mm_kernel_slab",
                                         "int8_mm_kernel_ring",
                                         "old_int8_mm", "ls_kernel"))
    assert seen["cmd"][-2:] == ["-sass", str(tmp_path / "int8_mm")]
    assert got == {
        "int8_mm_kernel_slab": {"HGMMA": 0, "HMMA": 0, "IGMMA": 3, "IMMA": 0},
        "int8_mm_kernel_ring": {"HGMMA": 0, "HMMA": 0, "IGMMA": 1, "IMMA": 0},
        "old_int8_mm": {"HGMMA": 0, "HMMA": 0, "IGMMA": 0, "IMMA": 2},
        "ls_kernel": {"HGMMA": 1, "HMMA": 1, "IGMMA": 0, "IMMA": 0},
    }
