"""Kernel 2's layer 1 (``factored_sig_proj``, bf16) with K split across
the card, on the CPU.

Where the 128 × 256 tile groups of ``csrc/gemm_sm90.cuh`` (two M-tiles of
one N-tile of a plane, one a 2-block cluster) are fewer than the clusters
that fit, the bf16 kernel cuts K into ranges (the plan:
``fused_factored.py::sig_proj_splits``), one cluster a (M-tile pair,
or one M-tile where M <= 128; N-tile, plane, range) unit, each range's
float32 partial in a workspace, then sums the partials in range order.
The kernel runs only on the card (``chip_smoke.py`` phase 5o: two
launches bit-identical, -85 dB of float32 x @ W1). Here:

- the plan: one range at the BS32 bench shape and at every layer-1 shape
  PERF.md's kernel table times (S = 4096, H1 up to 4096); at Nt 1024 with
  S = 128 and at Nt 512 with S = 512 the units fill 132 SMs (128 of
  them); no range empty, each at least SPLIT_MIN_KSTEPS k-steps;
- the ranges, rebuilt in float64 in the kernel's order (each range's sum
  rounded to float32, the partials added in float32 in range order),
  against float64 x @ W1: -90 dB;
- the CUDA branch (a library that records each launch): the workspace
  and the count reach the launch where the plan splits, none where it
  does not, and never in the float32 mode.
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
    sig_proj_splits,
)

SMS = 132                     # an H100 SXM
BF16 = torch.bfloat16


def _units(m, n, splits):
    """The split walk's blocks: one a (N-tile, plane, range) at one
    M-tile, else two a pair of M-tiles."""
    mt = -(-m // 128)
    return (1 if mt == 1 else 2 * -(-mt // 2)) * -(-n // 256) * 2 * splits


def _ranges(k, splits):
    """The kernel's ranges of K (elements): ks = ceil(KT / splits) k-steps
    of 64 each, the last cut at K."""
    kt = -(-k // 64)
    ks = -(-kt // splits)
    return [(j * ks * 64, min(k, (j + 1) * ks * 64)) for j in range(splits)]


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


@pytest.mark.parametrize("m, n, k", [(8, 256, 2560), (8, 256, 1000),
                                     (100, 512, 70000), (300, 128, 33000)])
def test_split_plan_leaves_no_range_empty(m, n, k):
    """Small and ragged shapes: the ranges cover K once, none empty, the
    units within the card."""
    splits = sig_proj_splits(m, n, k, SMS)
    assert splits >= 1 and _units(m, n, splits) <= max(SMS, _units(m, n, 1))
    r = _ranges(k, splits)
    assert r[-1][1] == k and all(a < b for a, b in r)
    assert sum(b - a for a, b in r) == k


def test_split_sums_rebuild_x_w1():
    """The ranges' float32 partials added in range order, rebuilt in
    float64 per range at Nt 1024's plan (16 ranges of a K of 327680, 8 rows
    and 256 columns to keep it small): -90 dB of float64 x @ W1."""
    k = 327680
    splits = sig_proj_splits(128, 1024, k, SMS)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32)) \
        .to(BF16).double().numpy()
    w = torch.from_numpy((rng.standard_normal((k, 256)) / k ** 0.5)
                         .astype(np.float32)).to(BF16).double().numpy()
    acc = np.zeros((8, 256), np.float32)
    for a, b in _ranges(k, splits):
        acc = acc + (x[:, a:b] @ w[a:b]).astype(np.float32)
    ref = x @ w
    db = 10 * np.log10(np.sum((acc - ref) ** 2) / np.sum(ref ** 2))
    assert db <= -90.0


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
    """The float32 mode (3xTF32, its epilogues need the whole sum) takes
    one range at any shape."""
    L, h = 5120, 256
    x = torch.zeros((2, 3, L))
    w1 = torch.zeros((2, L, h))
    ff.factored_sig_proj(x, w1, torch.zeros((2, 2, h, L)))
    (_, _, args), = launches
    assert args[6] == 2 and args[7] is None and args[8] == 1
