"""The constants and plain versions of the two Hopper LS kernels
(csrc/ls_sm90.cuh: ls_planes_v2 in ops.kernels.fused_ls, full and
sequence-sharded mode, and ls_pair_kernel) on the CPU.

The kernels read the DFT-select matrix K-major, Bᵀ (2·Cp, 2·fft), with
its rows permuted so that one block owns the real and the imaginary
column of each of its carriers (``ls_sm90_row_order``); here that
layout is held to ls_kernel_constants' B and to JAX's v2 constants, the
permutation to the product it stands for, and the wrappers' CUDA
branches (their device test made to answer CUDA, the launch cut off
before any build) to their refusal of constants of the other layout.
The plain versions, which the kernels are held to on the card
(chip_smoke.py), are held to JAX's Pallas kernels in interpret mode at
the new kernels' tile edges: one sample, rows past the last full
128-row tile, and seq ranks of n = 2, 4 and num_tx (one symbol a rank).
Tolerance: 2e-4 of the largest reference value, as the other LS tests
(float32 sums over a few thousand terms on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.ops.ltf import _hadamard_np as j_hadamard
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_estimate_pallas as j_ls_pallas,
    ls_planes_pallas_v2 as j_ls_v2,
    ls_planes_pallas_v2_constants as j_v2_constants,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.kernels import fused_ls
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    LsSm90Constants,
    ls_estimate_pallas,
    ls_kernel_constants,
    ls_pair_kernel,
    ls_planes_v1,
    ls_planes_v2,
    ls_sm90_constants,
    ls_sm90_row_order,
    pair_planes,
)
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
CONFIGS = [(CFG, JCFG), (SimConfig(), JSimConfig())]
BF16 = torch.bfloat16


def _planes(cfg, s, seed, nsym=None):
    """float32 planes (2, s, nsym·sym_len), standard normal."""
    n = (nsym or cfg.num_tx) * cfg.sym_len
    return np.random.default_rng(seed).standard_normal(
        (2, s, n)).astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("cfg,jcfg", CONFIGS)
def test_sm90_constants_are_the_permuted_transpose(cfg, jcfg):
    """Bᵀ is ls_kernel_constants transposed, rows in ls_sm90_row_order,
    and its columns are JAX's v2 constants: columns < fft (the xr
    coefficients) are rows cp: of [At_r | At_i], columns fft: (the xi
    ones) the same rows as [−At_i | At_r]."""
    k = ls_sm90_constants(cfg)
    assert isinstance(k, LsSm90Constants)
    bt, b = k.bt, ls_kernel_constants(cfg)
    cp_, fft = b.shape[1] // 2, cfg.fft_length
    assert bt.dtype == BF16 and bt.is_contiguous()
    assert tuple(bt.shape) == (2 * cp_, 2 * fft)
    order = ls_sm90_row_order(cp_)
    assert torch.equal(bt, b.T[torch.from_numpy(order)])
    unperm = torch.empty_like(bt)
    unperm[torch.from_numpy(order)] = bt
    assert torch.equal(unperm.T, b)
    jb, _ = j_v2_constants(jcfg, 1)
    jb = torch.from_numpy(np.array(jb)[cfg.cp_length:]).to(BF16)
    jr, ji = jb[:, :cp_], jb[:, cp_:]                  # (fft, Cp) each
    assert torch.equal(unperm[:, :fft].T, torch.cat([jr, ji], 1))
    assert torch.equal(unperm[:, fft:].T, torch.cat([-ji, jr], 1))


@pytest.mark.parametrize("cpad", [128, 256, 512])
def test_row_order_slabs(cpad):
    """A permutation whose slab q (rows 128q ..) is the real rows of
    carriers 64q .. 64q + 63, then their imaginary rows."""
    order = ls_sm90_row_order(cpad)
    assert sorted(order.tolist()) == list(range(2 * cpad))
    for q in range(cpad // 64):
        slab = order[128 * q:128 * q + 128]
        carriers = np.arange(64 * q, 64 * q + 64)
        np.testing.assert_array_equal(slab[:64], carriers)
        np.testing.assert_array_equal(slab[64:], cpad + carriers)


def test_row_order_refuses_odd_padding():
    with pytest.raises(ValueError, match="multiple of 64"):
        ls_sm90_row_order(100)


@pytest.mark.parametrize("cfg,jcfg", CONFIGS)
def test_permuted_columns_map_back(cfg, jcfg):
    """The kernel's product with the permuted Bᵀ is the plain product's
    columns in ls_sm90_row_order: column p of block q = p // 128 is the
    real part (p % 128 < 64) or the imaginary part of carrier 64q + p %
    64, as the kernels' stores read them."""
    x = _planes(cfg, 3, seed=1)
    rows = x.reshape(2, -1, cfg.sym_len)[:, :, cfg.cp_length:]
    a = torch.from_numpy(np.concatenate([rows[0], rows[1]], 1)).double()
    b = ls_kernel_constants(cfg).double()
    bt = ls_sm90_constants(cfg).bt.double()
    z, zp = a @ b, a @ bt.T
    cp_ = b.shape[1] // 2
    order = torch.from_numpy(ls_sm90_row_order(cp_))
    assert torch.equal(zp, z[:, order])
    p = torch.arange(2 * cp_)
    carrier = 64 * (p // 128) + p % 64
    imag = (p % 128) >= 64
    assert torch.equal(zp[:, ~imag], z[:, carrier[~imag]])
    assert torch.equal(zp[:, imag], z[:, cp_ + carrier[imag]])


class _Stop(Exception):
    pass


def _kernel_branch(monkeypatch):
    """Make the wrappers' device test answer CUDA and stop at the build
    of any kernel library, so the CUDA branches run up to the launch."""
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)

    def no_build(name, defines=()):
        raise _Stop(name)

    monkeypatch.setattr(fused_ls._build, "library", no_build)


def _calls(which):
    x = torch.from_numpy(_planes(CFG, 2, seed=2)).to(BF16)
    xq = x[:, :, :CFG.len_ltf // 2].contiguous()
    rx = torch.complex(x[0].float(), x[1].float()).view(
        1, CFG.num_rx, CFG.len_ltf).transpose(1, 2)
    old = ls_kernel_constants(CFG)
    return {
        "v2": lambda: ls_planes_v2(CFG, x, old),
        "v2 seq": lambda: ls_planes_v2(CFG, xq, old, seq_shard=(1, 2)),
        "pair": lambda: ls_pair_kernel(CFG, x, CFG.num_rx, old),
        "estimate_pallas": lambda: ls_estimate_pallas(CFG, rx, consts=old),
        "v1": lambda: ls_planes_v1(CFG, x, old),
    }[which]


@pytest.mark.parametrize("which", ["v2", "v2 seq", "pair", "estimate_pallas",
                                   "v1"])
def test_kernel_branches_refuse_the_other_layout(monkeypatch, which):
    """Every LS kernel (v2, v1, per pair) takes only LsSm90Constants and
    refuses the (2·fft, 2·Cp) matrix of ls_kernel_constants: at BS32 both
    are 512 × 512 bf16, so the type, not the shape, tells them apart."""
    _kernel_branch(monkeypatch)
    with pytest.raises(TypeError, match="ls_sm90_constants|"
                       "ls_kernel_constants"):
        _calls(which)()


@pytest.mark.parametrize("bad, match", [
    (LsSm90Constants(torch.zeros((512, 256), dtype=BF16)), r"\(512, 512\)"),
    (LsSm90Constants(torch.zeros((512, 512))), "bfloat16"),
    (LsSm90Constants(torch.zeros((512, 512), dtype=BF16, device="meta")),
     "constants on meta")])
def test_kernel_branch_checks_sm90_constants(monkeypatch, bad, match):
    """Constants of the right type but the wrong shape, dtype or device
    are refused before any launch."""
    _kernel_branch(monkeypatch)
    x = torch.from_numpy(_planes(CFG, 2, seed=3)).to(BF16)
    with pytest.raises((TypeError, ValueError), match=match):
        ls_planes_v2(CFG, x, bad)


@pytest.mark.parametrize("call", ["v2", "pair"])
def test_kernel_branch_builds_constants_when_omitted(monkeypatch, call):
    """Without constants the CUDA branch builds ls_sm90_constants and
    reaches the launch (cut off here at the library build)."""
    _kernel_branch(monkeypatch)
    x = torch.from_numpy(_planes(CFG, 2, seed=4)).to(BF16)
    with pytest.raises(_Stop, match="ls_v2" if call == "v2" else "ls_pair"):
        if call == "v2":
            ls_planes_v2(CFG, x)
        else:
            ls_pair_kernel(CFG, x, CFG.num_rx)


def test_v2_empty_batch_counts_no_launch(monkeypatch):
    _kernel_branch(monkeypatch)
    before = ls_planes_v2.launches
    out = ls_planes_v2(CFG, torch.empty((2, 0, CFG.len_ltf), dtype=BF16))
    assert tuple(out.shape) == (2, 0, CFG.num_tx, CFG.num_carriers)
    assert ls_planes_v2.launches == before


def test_sharded_seq_copies_the_constants_per_rank():
    """sharded_ls_pallas_v2 takes LsSm90Constants and moves them to each
    rank's device (``to``), keeping the type."""
    k = ls_sm90_constants(CFG)
    moved = k.to("cpu")
    assert isinstance(moved, LsSm90Constants) and torch.equal(moved.bt, k.bt)
    x = torch.from_numpy(_planes(CFG, 4, seed=5))
    mesh = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    got = sharded.sharded_ls_pallas_v2(CFG, mesh, x, mode="seq", consts=k)
    ref = ls_planes_v2(CFG, x)
    _close(torch.view_as_real(got).numpy(),
           torch.view_as_real(torch.complex(ref[0], ref[1])).numpy())


def _j_v2(x, seq=None, block_samples=4):
    """JAX's v2 kernel in interpret mode, densified to (S, nt, C): the
    whole preamble, or rank i of n's partial with its rectangular K."""
    s = x.shape[1]
    consts = None
    if seq is not None:
        i, n = seq
        loc = JCFG.num_tx // n
        b, _ = j_v2_constants(JCFG, block_samples)
        p = j_hadamard(JCFG.num_tx).astype(np.float32)[:, i * loc:
                                                       (i + 1) * loc]
        consts = (b, jnp.asarray(np.kron(np.eye(block_samples,
                                                dtype=np.float32), p)))
    h, _ = j_ls_v2(JCFG, jnp.asarray(x), consts,
                   block_samples=block_samples, interpret=True)
    return np.asarray(j_v2_to_complex(JCFG, h, s))


@pytest.mark.parametrize("s", [1, 3, 17])
def test_v2_plain_matches_jax_at_tile_edges(s):
    """S = 1 (8 of a tile's 128 rows), 3 and 17 samples (the last tile
    partly past S·nt rows)."""
    x = _planes(CFG, s, seed=10 + s)
    got = ls_planes_v2(CFG, torch.from_numpy(x)).numpy()
    _close(got[0] + 1j * got[1], _j_v2(x))


@pytest.mark.parametrize("s, seq", [(1, (1, 2)), (3, (3, 4)), (3, (5, 8)),
                                    (17, (0, 8))])
def test_v2_seq_plain_matches_jax(s, seq):
    """A seq rank's partial despread (n = 2, 4 and num_tx, where a rank
    holds one symbol a sample) against JAX's rectangular-K kernel."""
    i, n = seq
    loc = CFG.num_tx // n
    x = _planes(CFG, s, seed=20 + i, nsym=loc)
    got = ls_planes_v2(CFG, torch.from_numpy(x), seq_shard=seq).numpy()
    _close(got[0] + 1j * got[1], _j_v2(x, seq))


@pytest.mark.parametrize("packets", [1, 5])
def test_pair_plain_matches_jax_at_tile_edges(packets):
    """1 packet (16 of a tile's 128 rows) and 5 packets (80 rows)."""
    rng = np.random.default_rng(30 + packets)
    shape = (packets, CFG.len_ltf, CFG.num_rx)
    rx = (rng.standard_normal(shape)
          + 1j * rng.standard_normal(shape)).astype(np.complex64)
    got = ls_estimate_pallas(CFG, torch.from_numpy(rx)).numpy()
    ref = np.asarray(j_ls_pallas(JCFG, jnp.asarray(rx), interpret=True))
    _close(np.stack([got.real, got.imag]), np.stack([ref.real, ref.imag]))


def test_pair_kernel_input_is_the_flat_planes_layout():
    """The per-pair kernel's rows are the flat planes' rows: sample
    b·num_rx + r, so the same Bᵀ and row tiles serve both kernels."""
    rng = np.random.default_rng(40)
    rx = torch.from_numpy((rng.standard_normal((2, CFG.len_ltf, CFG.num_rx))
                           + 1j * rng.standard_normal(
                               (2, CFG.len_ltf, CFG.num_rx))
                           ).astype(np.complex64))
    pl = pair_planes(rx).float()
    want = rx.transpose(1, 2).reshape(-1, CFG.len_ltf)
    assert torch.equal(pl[0], want.real.to(BF16).float())
    assert torch.equal(pl[1], want.imag.to(BF16).float())
