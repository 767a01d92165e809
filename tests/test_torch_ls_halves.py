"""The LS body at 256 symbols a sample (``csrc/ls_sm90.cuh``,
``ls_body_halves``: ``ls_body<2>``, kernels 1, 3 and 4 at Nt 256 and a
seq rank of 256 symbols), on the CPU.

The CUDA body runs only on the card (``chip_smoke.py`` phases 5l and 5m
hold kernels 1, 3 and 4 at Nt 256 to their plain versions there; the
float32 mode, ``ls_body_f32_halves``, takes the same schedule with 3
TF32 products a k-step). Here the schedule is rebuilt in float64 from
numpy planes made from a seed and the kernels' constants, and held to
the plain versions:

- one sample a unit; per symbol half i = 0, 1 the k-steps of 64 samples,
  16 boxes of 8 symbols (box g: symbols 8g .. 8g + 7 of half i) a stage;
  warpgroup w takes set w of the block's columns (0 real, 1 imaginary)
  into z_i; then h_0 = z_lo + z_hi, h_1 = z_lo - z_hi, the 128-symbol
  despread on each, the swap (warpgroup 0 hands h_1's real part over
  for h_0's imaginary part) and each warpgroup's store of half a = w at
  rows a·128 + b: against ``ls_planes_v2``'s plain version in full mode
  at Nt 256 and as seq rank 1 of 2 at Nt 512 (256 symbols a rank: n = 2
  copies, each with the sign H_2[c, rank]), -120 dB (float64 against
  float32 sums in another order);
- the per-tile sums of h² the store takes from those values (tile 2t +
  a, n copies) against the plain version's, 1e-5 relative;
- the three LS launch functions' ctypes bindings against the C sources;
- which body each store takes at 256 symbols (every store, bf16 and
  float32, the halves body), as the sources dispatch it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mamimo_tpu.ops.ltf import _hadamard_np as j_hadamard
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import _build, fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_kernel_constants,
    ls_planes_v2,
)

REBUILD_DB = -120.0                 # float64 rebuild against float32 sums
CSRC = Path(fused_ls.__file__).resolve().parents[2] / "csrc"


def _db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                         / np.sum(np.abs(ref) ** 2))


def _wht_rows(a):
    """The 128-symbol despread on the rows of a (128, n): symbol bit k
    of the row index, lo + hi at bit 0 and lo - hi at bit 1 (Sylvester
    order, as ls90::despread on the accumulators)."""
    a = a.copy()
    r = np.arange(128)
    for b in range(7):
        lo = r[(r >> b) & 1 == 0]
        hi = lo | (1 << b)
        a[lo], a[hi] = a[lo] + a[hi], a[lo] - a[hi]
    return a


def _rebuild_halves(cfg, x, rank=0, n=1):
    """(h (S, num_tx, C) complex128, ssq (2 S, 2, C)) as ls_body_halves
    and the v2 store compute them from x (2, S, 256·sym_len), a rank of
    n: rows c·256 + a·128 + b of sample t hold H_n[c, rank] times half a,
    and tile 2t + a's sums count the n copies."""
    ke, fft, cpl, sym_len = 64, cfg.fft_length, cfg.cp_length, cfg.sym_len
    C, s = cfg.num_carriers, x.shape[1]
    cpad = -(-C // 128) * 128
    bt = ls_kernel_constants(cfg, dtype=torch.float32).double().numpy()
    nk0 = 2 * fft // ke
    xr = x.astype(np.float64).reshape(2, s, 256, sym_len)
    hmat = j_hadamard(n)
    out = np.zeros((s, 256 * n, C), np.complex128)
    ssq = np.zeros((2 * s, 2, C))
    for t in range(s):
        # z[w][i]: warpgroup w's set (0 real, 1 imaginary), symbol half i
        z = np.zeros((2, 2, 128, cpad))
        for i in range(2):
            for k0 in range(nk0):
                plane = int(k0 >= nk0 // 2)
                col = cpl + (k0 % (nk0 // 2)) * ke
                stage = np.zeros((128, ke))
                for g in range(16):             # box g: 8 symbols
                    for rib in range(8):
                        sym = 8 * g + rib + (i << 7)
                        stage[8 * g + rib] = xr[plane, t, sym, col:col + ke]
                for w in range(2):
                    z[w, i] += stage @ bt[k0 * ke:(k0 + 1) * ke,
                                          w * cpad:(w + 1) * cpad]
        # per warpgroup (h_0, h_1) of its set, despread
        held = {w: [_wht_rows(z[w, 0] + z[w, 1]),
                    _wht_rows(z[w, 0] - z[w, 1])] for w in range(2)}
        # the swap: warpgroup 0 gives h_1's real part for h_0's imaginary
        held[0][1], held[1][0] = held[1][0], held[0][1]
        for w in range(2):                      # half a = w
            re, im = held[w][0][:, :C], held[w][1][:, :C]
            for c in range(n):
                out[t, c * 256 + w * 128:c * 256 + w * 128 + 128] = \
                    hmat[c, rank] * (re + 1j * im)
            ssq[2 * t + w, 0] = n * np.sum(re ** 2, axis=0)
            ssq[2 * t + w, 1] = n * np.sum(im ** 2, axis=0)
    return out, ssq


@pytest.mark.parametrize("nt, seq", [(256, None), (512, (1, 2))])
def test_halves_schedule_rebuilds_kernel1(nt, seq):
    """The halves body's schedule, swap and store give the plain
    estimate and its per-tile sums: Nt 256 in full mode, and a rank of
    256 symbols at Nt 512 (seq rank 1 of 2)."""
    cfg = SimConfig(num_tx=nt, num_rx=2)
    loc = nt if seq is None else nt // seq[1]
    assert loc == 256
    x = np.random.default_rng(nt).standard_normal(
        (2, 2, loc * cfg.sym_len)).astype(np.float32)
    got, ssq = _rebuild_halves(cfg, x, *(seq or (0, 1)))
    h, ref_ssq = ls_planes_v2(cfg, torch.from_numpy(x), seq_shard=seq,
                              with_ssq=True)
    ref = h[0].double().numpy() + 1j * h[1].double().numpy()
    assert _db(got, ref) <= REBUILD_DB
    np.testing.assert_allclose(ssq, ref_ssq.double().numpy(), rtol=1e-5)


def _c_arity(src, fn):
    m = re.search(rf"int {fn}\(([^)]*)\)", (CSRC / f"{src}.cu").read_text())
    assert m, fn
    return len(m.group(1).split(","))


class _FakeLib:
    """Stands in for a built library: keeps each binding's argtypes."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("src, fn, lib", [
    ("ls_v2", "ls_planes_v2_launch", "_ls_lib"),
    ("ls_v1", "ls_planes_v1_launch", "_ls_v1_lib"),
    ("ls_pair", "ls_pair_launch", "_ls_pair_lib")])
def test_ls_binding_matches_the_c_signature(monkeypatch, src, fn, lib):
    """The launches of the three kernels on the halves body keep their C
    signatures: each binding passes as many arguments as the source
    declares."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda name, defines=(): fake)
    getattr(fused_ls, lib)()
    assert len(getattr(fake, fn).argtypes) == _c_arity(src, fn)


def _body(text, fn):
    body = text[text.index(f"void {fn}(const CUtensorMap* ma"):]
    return body[:body.index("\n}\n")]


def test_halves_body_serves_loc_256():
    """ls_body and ls_body_f32 dispatch NH = 2 (256 symbols) to the halves
    bodies for every store (no epilogue chooses a body: the launch
    sources carry no switch), and NH = 0 and 1 to the tile bodies, which
    take no NH = 2; both halves bodies share halves_consume, their
    combine, despread, swap and store."""
    text = (CSRC / "ls_sm90.cuh").read_text()
    bf = _body(text, "ls_body")
    assert "if constexpr (NH == 2)\n    ls_body_halves(" in bf
    assert "ls_body_tiles<NH>(" in bf
    f32 = _body(text, "ls_body_f32")
    assert "if constexpr (NH == 2)\n    ls_body_f32_halves(" in f32
    assert "ls_body_f32_tiles<NH>(" in f32
    for tiles in ("ls_body_tiles", "ls_body_f32_tiles"):
        assert 'static_assert(NH == 0 || NH == 1' in _body(text, tiles)
    for halves in ("ls_body_halves", "ls_body_f32_halves"):
        assert "halves_consume(" in _body(text, halves)
    for src in ("ls_v2", "ls_v1", "ls_pair"):
        assert "HALVES" not in (CSRC / f"{src}.cu").read_text()
