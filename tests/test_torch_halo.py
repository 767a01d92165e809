"""The launch plan and the complex form of kernel 7's wrapper
(mamimo_tpu_torch.parallel.rdma_halo), on the CPU.

``_launch_plan`` is a pure function of the axis's devices, so it is
checked on ``torch.device("cuda", i)`` objects (no card is needed to make
one); the complex form's plain version is held bit for bit to
``ext_block_plain`` on the same data. Inputs are made with numpy.
"""

import numpy as np
import pytest
import torch

from mamimo_tpu_torch.parallel.mesh import make_mesh
from mamimo_tpu_torch.parallel.rdma_halo import (
    MAX_RANKS_PER_CARD,
    _ext_complex_plain,
    _halo_exchange_complex,
    _launch_plan,
    ext_block_plain,
    halo_exchange_pallas,
)


def _c(i):
    return torch.device("cuda", i)


# mesh (card of each rank) -> (cards in launch order, their ranks, the
# pairs r -> r + 1 that cross cards)
PLANS = {
    "one card, 4 ranks": ([0, 0, 0, 0], [0], [[0, 1, 2, 3]], []),
    "4 cards": ([0, 1, 2, 3], [0, 1, 2, 3], [[0], [1], [2], [3]],
                [0, 1, 2]),
    "2 ranks a card": ([0, 0, 1, 1], [0, 1], [[0, 1], [2, 3]], [1]),
    "interleaved": ([0, 1, 0, 1], [0, 1], [[0, 2], [1, 3]], [0, 1, 2]),
    "3 ranks": ([2, 0, 0], [2, 0], [[0], [1, 2]], [0]),
    "8 ranks on one card": ([0] * 8, [0], [list(range(8))], []),
    "9 ranks over 2 cards": ([0] * 8 + [1], [0, 1], [list(range(8)), [8]],
                             [7]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_launch_plan(name):
    cards, want_cards, want_ranks, want_cross = PLANS[name]
    devs = [_c(i) for i in cards]
    plan = _launch_plan(devs)
    # one launch per card, over that card's ranks
    assert [dev for dev, _ in plan] == [_c(i) for i in want_cards]
    assert [[s.rank for s in slots] for _, slots in plan] == want_ranks
    slots = {s.rank: (dev, s) for dev, ss in plan for s in ss}
    assert sorted(slots) == list(range(len(devs)))
    d = len(devs)
    for r, (dev, s) in slots.items():
        assert dev == devs[r]
        # who puts into whom: r into r + 1, the last rank nowhere
        assert s.right == (r + 1 if r + 1 < d else None)
        # rank 0 zeroes its halo, no other rank does
        assert s.zero_halo == (r == 0)
        # flags exactly on the pairs that cross cards, on both sides
        assert s.right_remote == (r in want_cross)
        assert s.left_remote == (r - 1 in want_cross)
    assert slots[d - 1][1].right is None and not slots[d - 1][1].right_remote


def test_launch_plan_refuses_more_ranks_than_a_card_takes():
    with pytest.raises(ValueError, match="at most 8 a card"):
        _launch_plan([_c(0)] * (MAX_RANKS_PER_CARD + 1))
    with pytest.raises(ValueError, match="9 ranks on cuda:1"):
        _launch_plan([_c(0)] + [_c(1)] * 9)


def _complex(shape, seed):
    z = np.random.default_rng(seed).standard_normal(
        (*shape, 2)).astype(np.float32)
    return torch.tensor(z[..., 0] + 1j * z[..., 1])


@pytest.mark.parametrize("chunk,halo,nt", [(50, 7, 3), (320, 96, 8),
                                           (40, 0, 4)])
def test_complex_plain_equals_planes_plain(chunk, halo, nt):
    """The complex form's plain version is ext_block_plain on the same
    samples, bit for bit (real and imaginary parts), rank 0 and a rank
    with a left neighbour."""
    x, left = _complex((chunk, nt), 1), _complex((chunk, nt), 2)
    planes = lambda c: torch.stack([c.real, c.imag])      # noqa: E731
    for lft in (None, left):
        got = _ext_complex_plain(x, lft, halo)
        want = ext_block_plain(planes(x), None if lft is None
                               else planes(lft), halo)
        assert got.shape == (halo + chunk, nt) and got.dtype == x.dtype
        assert torch.equal(planes(got), want)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_complex_exchange_matches_planes_exchange(d):
    """_halo_exchange_complex on a mesh of CPU ranks gives, rank by rank,
    the blocks halo_exchange_pallas builds from the same samples' planes;
    rank 0's halo is zero."""
    chunk, halo, nt = 24, 5, 6
    mesh = make_mesh({"seq": d}, devices=["cpu"] * d)
    xs = [_complex((chunk, nt), 10 + r) for r in range(d)]
    got = _halo_exchange_complex(mesh, xs, halo)
    want = halo_exchange_pallas(mesh, [torch.stack([x.real, x.imag])
                                       for x in xs], halo)
    assert len(got) == d
    for g, w in zip(got, want):
        assert torch.equal(torch.stack([g.real, g.imag]), w)
    assert torch.equal(got[0][:halo], torch.zeros((halo, nt),
                                                  dtype=torch.complex64))


def test_complex_exchange_refuses_bad_chunks():
    mesh = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    x = [_complex((16, 4), r) for r in range(2)]
    with pytest.raises(ValueError, match="exceed the halo"):
        _halo_exchange_complex(mesh, x, 16)
    with pytest.raises(ValueError, match="chunks for 2 ranks"):
        _halo_exchange_complex(mesh, x[:1], 4)
    with pytest.raises(ValueError, match="complex64"):
        _halo_exchange_complex(mesh, [t.real for t in x], 4)
    with pytest.raises(ValueError, match="rank 1"):
        _halo_exchange_complex(mesh, [x[0], x[1][:8]], 4)
