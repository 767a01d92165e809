"""Kernel 2's layer 1 (``factored_sig_proj``) with K split across the
card, on the CPU, in both modes.

Where the tile groups of ``csrc/gemm_sm90.cuh`` (two M-tiles of one
N-tile of a plane, one a 2-block cluster; 128 × 256 tiles in bf16, 128 ×
128 in the float32 mode, ``gemm_tf32x3``) are fewer than the clusters
that fit, the kernel cuts K into ranges (the plan:
``fused_factored.py::sig_proj_splits``), one cluster a (M-tile pair, or
one M-tile where M <= 128; N-tile, plane, range) unit, each range's
float32 partial in a workspace, then sums the partials in range order.
The kernels run only on the card (``chip_smoke.py`` phase 5o: two
launches bit-identical, -85 dB (bf16) and -90 dB (float32) of float32 x
@ W1). Here:

- the plan: one range at the BS32 bench shape and at every layer-1 shape
  PERF.md's kernel table times (S = 4096, H1 up to 4096); at Nt 1024 with
  S = 128 and at Nt 512 with S = 512 the units fill 132 SMs (128 of
  them); no range empty, each at least SPLIT_MIN_KSTEPS k-steps of 64
  (float32: SPLIT_MIN_KSTEPS_F32 of 32);
- the ranges, rebuilt in float64 in the kernel's order (each range's sum
  rounded to float32, the partials added in float32 in range order),
  against float64 x @ W1: -90 dB, on bf16 operands and on float32 ones;
- the CUDA branch (a library that records each launch): the workspace
  and the count reach the launch where the plan splits, none where it
  does not, in both modes, the float32 mode's on its own plan.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels.fused_factored import (
    SPLIT_MIN_KSTEPS,
    SPLIT_MIN_KSTEPS_F32,
    sig_proj_splits,
)

SMS = 132                     # an H100 SXM
BF16 = torch.bfloat16
# each mode's N-tile and k-step (elements)
TILE = {False: (256, 64), True: (128, 32)}


def _units(m, n, splits, float32=False):
    """The split walk's blocks: one a (N-tile, plane, range) at one
    M-tile, else two a pair of M-tiles."""
    mt = -(-m // 128)
    bn = TILE[float32][0]
    return (1 if mt == 1 else 2 * -(-mt // 2)) * -(-n // bn) * 2 * splits


def _ranges(k, splits, float32=False):
    """The kernel's ranges of K (elements): ks = ceil(KT / splits) k-steps
    (of 64, float32 32) each, the last cut at K."""
    bk = TILE[float32][1]
    kt = -(-k // bk)
    ks = -(-kt // splits)
    return [(j * ks * bk, min(k, (j + 1) * ks * bk)) for j in range(splits)]


@pytest.mark.parametrize("m, n, k", [
    (4096, 1024, 10240), (4096, 1536, 10240), (4096, 2048, 10240),
    (4096, 4096, 10240), (4096, 1024, 10272)])
def test_no_split_where_the_tiles_fill_the_card(m, n, k):
    """The bench shape and the other layer-1 shapes of the kernel table:
    one range, the launch as it ran before the split walk."""
    assert sig_proj_splits(m, n, k, SMS) == 1


@pytest.mark.parametrize("nt, s, want", [(1024, 128, 16), (512, 512, 4)])
def test_split_fills_the_card(nt, s, want):
    """Nt 1024 at S = 128 (8 tiles: 16 ranges of 20480) and Nt 512 at S =
    512 (32 tiles: 4 ranges of 40960): 128 units for 132 SMs, every range
    holding k-steps."""
    k = 320 * nt
    splits = sig_proj_splits(s, 1024, k, SMS)
    assert splits == want
    assert SMS - 8 < _units(s, 1024, splits) <= SMS
    r = _ranges(k, splits)
    assert r[0][0] == 0 and r[-1][1] == k
    assert all(a < b and b - a >= 64 * SPLIT_MIN_KSTEPS for a, b in r)
    assert all(r[j][1] == r[j + 1][0] for j in range(splits - 1))


RAGGED = [(8, 256, 2560), (8, 256, 1000), (100, 512, 70000),
          (300, 128, 33000)]


def _plan_covers_k(m, n, k, float32):
    splits = sig_proj_splits(m, n, k, SMS, float32)
    assert splits >= 1 and _units(m, n, splits, float32) <= max(
        SMS, _units(m, n, 1, float32))
    r = _ranges(k, splits, float32)
    assert r[-1][1] == k and all(a < b for a, b in r)
    assert sum(b - a for a, b in r) == k


@pytest.mark.parametrize("m, n, k", RAGGED)
def test_split_plan_leaves_no_range_empty(m, n, k):
    """Small and ragged shapes: the ranges cover K once, none empty, the
    units within the card."""
    _plan_covers_k(m, n, k, False)


@pytest.mark.parametrize("m, n, k", RAGGED)
def test_float32_split_plan_leaves_no_range_empty(m, n, k):
    """The same in the float32 mode's plan (128-column tiles, k-steps of
    32)."""
    _plan_covers_k(m, n, k, True)


@pytest.mark.parametrize("m, n, k", [
    (4096, 1024, 10240), (4096, 2048, 10240), (4096, 4096, 10240),
    (4096, 1024, 10272)])
def test_float32_plan_keeps_one_range_where_the_tiles_fill_the_card(m, n,
                                                                    k):
    """The float32 mode at BS32's S = 4096 (256 clusters of 128 x 128
    tiles and more): one range, the launch that ran before its split."""
    assert sig_proj_splits(m, n, k, SMS, float32=True) == 1


@pytest.mark.parametrize("nt, s, want", [(1024, 128, 8), (512, 512, 2)])
def test_float32_split_fills_the_card(nt, s, want):
    """The float32 mode (128 x 128 tiles, k-steps of 32): Nt 1024 at S =
    128 (16 one-block units: 8 ranges of 40960) and Nt 512 at S = 512 (32
    clusters of two blocks: 2 ranges of 81920), 128 blocks for 132 SMs,
    every range of at least SPLIT_MIN_KSTEPS_F32 k-steps."""
    k = 320 * nt
    splits = sig_proj_splits(s, 1024, k, SMS, float32=True)
    assert splits == want
    assert _units(s, 1024, splits, True) == 128
    r = _ranges(k, splits, True)
    assert r[0][0] == 0 and r[-1][1] == k
    assert all(a < b and b - a >= 32 * SPLIT_MIN_KSTEPS_F32 for a, b in r)
    assert all(r[j][1] == r[j + 1][0] for j in range(splits - 1))


def _rebuild_db(float32):
    """The ranges' float32 partials added in range order, rebuilt in
    float64 per range at Nt 1024's plan (8 rows and 256 columns), on
    operands of the mode's dtype: dB of float64 x @ W1."""
    k = 327680
    splits = sig_proj_splits(128, 1024, k, SMS, float32)
    assert splits == (8 if float32 else 16)
    dt = torch.float32 if float32 else BF16
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32)) \
        .to(dt).double().numpy()
    w = torch.from_numpy((rng.standard_normal((k, 256)) / k ** 0.5)
                         .astype(np.float32)).to(dt).double().numpy()
    acc = np.zeros((8, 256), np.float32)
    for a, b in _ranges(k, splits, float32):
        acc = acc + (x[:, a:b] @ w[a:b]).astype(np.float32)
    ref = x @ w
    return 10 * np.log10(np.sum((acc - ref) ** 2) / np.sum(ref ** 2))


def test_split_sums_rebuild_x_w1():
    """The bf16 mode's 16 ranges of a K of 327680 (bf16 operands): -90 dB
    of float64 x @ W1."""
    assert _rebuild_db(False) <= -90.0


def test_float32_split_sums_rebuild_x_w1():
    """The float32 mode's 8 ranges of a K of 327680 (float32 operands):
    -90 dB of float64 x @ W1."""
    assert _rebuild_db(True) <= -90.0


class _Lib:
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
    monkeypatch.setattr(ff, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ff, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library",
                        lambda name, defines=(): _Lib(name, calls))
    return calls


@pytest.mark.parametrize("s, L, h", [(3, 5120, 256), (128, 2560, 256),
                                     (4096, 640, 1024)])
def test_cuda_branch_passes_the_plan(launches, s, L, h):
    """The launch gets the plan's splits and, where it splits, a float32
    workspace of (splits, 2, S, H); where it does not, no workspace. One
    launch counted either way, the split walk's apart."""
    x = torch.zeros((2, s, L), dtype=BF16)
    w1 = torch.zeros((2, L, h), dtype=BF16)
    w1t = torch.zeros((2, h, L), dtype=BF16)
    before = (ff.factored_sig_proj.launches,
              ff.factored_sig_proj.launches_split)
    ff.factored_sig_proj(x, w1, w1t)
    (lib, fn, args), = launches
    splits = sig_proj_splits(s, h, L, SMS)
    assert (lib, fn) == ("fused_factored", "factored_sig_proj_launch")
    assert args[3:7] == (s, L, h, 0) and args[8] == splits
    assert (args[7] is None) == (splits == 1)
    assert (ff.factored_sig_proj.launches,
            ff.factored_sig_proj.launches_split) == (
        before[0] + 1, before[1] + (splits > 1))
    assert splits > 1 or s == 4096


def test_cuda_branch_float32_mode_never_splits(launches):
    """The float32 mode (3xTF32) gets its own plan and, where it splits,
    a workspace: at S = 3 (L = 5120, H = 256) the plan's ranges of k-steps
    of 32 and a (splits, 2, S, H) float32 workspace; at S = 4096 it never
    splits (one range, no workspace). Counted as a split launch of the
    float32 mode apart."""
    for s, L, h in ((3, 5120, 256), (4096, 640, 1024)):
        x = torch.zeros((2, s, L))
        w1 = torch.zeros((2, L, h))
        before = (ff.factored_sig_proj.launches_split,
                  ff.factored_sig_proj.launches_split_f32)
        launches.clear()
        ff.factored_sig_proj(x, w1, torch.zeros((2, 2, h, L)))
        (_, _, args), = launches
        splits = sig_proj_splits(s, h, L, SMS, float32=True)
        assert args[3:7] == (s, L, h, 2) and args[8] == splits
        assert (splits > 1) == (s == 3)
        assert (args[7] is None) == (splits == 1)
        assert (ff.factored_sig_proj.launches_split,
                ff.factored_sig_proj.launches_split_f32) == (
            before[0] + (splits > 1), before[1] + (splits > 1))
