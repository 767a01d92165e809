"""The bf16 per-head rows kernel (``csrc/fused_factored.cu``,
``factored_heads_kernel``, launched by ``factored_heads`` for every
model the fused tail does not take), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 5l holds it
bit for bit to the plain version's bf16 rows there). Here, on inputs
made from a seed:

- a Python model of its launch: a grid of (ceil(S / HEADS_WARPS),
  ceil(H / HEADS_CHUNK), 2) blocks of 32·HEADS_WARPS threads, warp w of
  block (x, y, p) the sample x·HEADS_WARPS + w of plane p, lane l the
  columns y·HEADS_CHUNK + 8l .. + 7, walking the heads t in order and
  writing row s·nt + t (the constants read from the source): every
  element of the (2, S·nt, H) rows written exactly once, none past S or
  H, and the rows so written equal to ``_heads_plain``'s rounded to bf16
  (the wrapper's CPU answer), at H1 96, 1152 and 2048 (ragged, one and
  several chunks) and S not a multiple of HEADS_WARPS;
- the binding of ``factored_heads_launch`` against its C declaration;
- the wrapper's CUDA branch (the device test answering CUDA, a library
  that records each launch): the launch gets the contiguous sig_proj,
  hb, a1, c1, the output, (S, nt, H1) and mode 0, and is counted once.
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
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels import fused_factored as ff

BF16 = torch.bfloat16
CFG = SimConfig(num_tx=8, num_rx=2)
SRC = (Path(ff.__file__).resolve().parents[2] / "csrc"
       / "fused_factored.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _model_rows(p, sp):
    """The rows (2, S·nt, H) bf16 as the kernel's grid writes them, and
    how many times each element was written."""
    warps, chunk = _const("HEADS_WARPS"), _const("HEADS_CHUNK")
    _, S, H = sp.shape
    nt = p["hb"].shape[1]
    out = torch.zeros((2, S * nt, H), dtype=BF16)
    hits = np.zeros((2, S * nt, H), np.int64)
    hb, a1 = p["hb"], p["a1"].reshape(2, H)
    c1 = p["c1"].reshape(2, H)
    for z in range(2):
        for y in range(-(-H // chunk)):
            for x in range(-(-S // warps)):
                for w in range(warps):
                    s = x * warps + w
                    for lane in range(32):
                        k = y * chunk + 8 * lane
                        if s >= S or k >= H:
                            continue
                        cols = slice(k, k + 8)
                        for t in range(nt):
                            v = torch.relu(sp[z, s, cols] + hb[z, t, cols]) \
                                * a1[z, cols] + c1[z, cols]
                            out[z, s * nt + t, cols] = v.to(BF16)
                            hits[z, s * nt + t, cols] += 1
    return out, hits


def _prepared(h1, seed):
    tcfg = TrainConfig(hidden=(h1, 128))
    tp, tb = mlp.init_stacked(torch.Generator().manual_seed(seed), CFG, tcfg)
    p = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
    g = torch.Generator().manual_seed(seed + 1)
    for k in ("hb", "a1", "c1"):                 # values that show a slip
        p[k] = torch.randn(p[k].shape, generator=g) + (0.5 if k == "a1"
                                                       else 0.0)
    return p


@pytest.mark.parametrize("h1, s", [(96, 3), (1152, 9), (2048, 2)])
def test_grid_writes_every_row_once_as_the_plain_version(h1, s):
    p = _prepared(h1, seed=h1)
    H = p["hb"].shape[-1]
    sp = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, s, H)).astype(np.float32))
    got, hits = _model_rows(p, sp)
    assert (hits == 1).all()
    assert torch.equal(got, ff.factored_heads(p, sp))


def test_heads_binding_matches_the_c_signature(monkeypatch):
    """factored_heads_launch keeps its C signature."""
    class _Fake:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    fake = _Fake()
    monkeypatch.setattr(_build, "library", lambda name, defines=(): fake)
    ff._ff_lib()
    m = re.search(r"int factored_heads_launch\(([^)]*)\)", SRC)
    assert len(fake.factored_heads_launch.argtypes) == \
        len(m.group(1).split(","))


def test_cuda_branch_launches_the_rows_kernel(monkeypatch):
    calls = []

    class _Lib:
        def __getattr__(self, fn):
            def f(*args):
                calls.append((fn, args))
                return 0
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(ff, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library", lambda name, defines=(): _Lib())
    p = _prepared(256, seed=4)
    sp = torch.zeros((2, 5, 256))
    before = (ff.factored_heads.launches, ff.factored_heads.launches_f32)
    h = ff.factored_heads(p, sp)
    (fn, args), = calls
    assert fn == "factored_heads_launch"
    assert args[0] == sp.data_ptr()
    assert args[1:4] == tuple(p[k].data_ptr() for k in ("hb", "a1", "c1"))
    assert args[4] == h.data_ptr() and args[5:9] == (5, CFG.num_tx, 256, 0)
    assert h.dtype == BF16 and tuple(h.shape) == (2, 5 * CFG.num_tx, 256)
    assert (ff.factored_heads.launches, ff.factored_heads.launches_f32) == (
        before[0] + 1, before[1])
