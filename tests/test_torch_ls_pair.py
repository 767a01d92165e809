"""The port's per-pair LS (mamimo_tpu_torch.ops.estimate::
ls_estimate_matmul and ops.kernels.fused_ls::ls_estimate_pallas) against
the JAX package on the CPU.

The same complex preambles, made with numpy, go through both packages;
the JAX kernel runs in interpret mode. The port's wrapper runs its plain
version here (the CUDA kernel runs only on the card, chip_smoke.py).
Every comparison is held at a relative error of 2e-4, the JAX package's
own bound for its per-pair kernel (tests/test_pallas.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.ops.estimate import ls_estimate_matmul as j_ls_matmul
from mamimo_tpu.ops.pallas.fused_ls import ls_estimate_pallas as j_ls_pallas
from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.estimate import (
    ls_estimate_matmul,
    ls_estimate_planes,
    ls_matmul_constants,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_estimate_pallas,
    ls_pair_kernel,
    ls_sm90_constants,
    pair_planes,
)

REL = 2e-4


@pytest.fixture(scope="module")
def pcfg(small_cfg):
    """The port's config with the fields of the JAX small_cfg."""
    return SimConfig(num_tx=small_cfg.num_tx, num_rx=small_cfg.num_rx,
                     n_scatterers=small_cfg.n_scatterers,
                     n_rays=small_cfg.n_rays)


def _rx(cfg, packets, seed):
    rng = np.random.default_rng(seed)
    shape = (packets, cfg.len_ltf, cfg.num_rx)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_constants_match_jax(small_cfg, pcfg):
    from mamimo_tpu.ops.estimate import ls_matmul_constants as j_consts

    a, p = ls_matmul_constants(pcfg)
    ja, jp = j_consts(small_cfg)
    assert a.dtype == torch.complex64 and p.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_ls_estimate_matmul_matches_jax(small_cfg, pcfg):
    rx = _rx(pcfg, 3, 0)
    got = ls_estimate_matmul(pcfg, torch.from_numpy(rx))
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (3, pcfg.num_carriers, pcfg.num_tx,
                                pcfg.num_rx)
    assert _rel(got.numpy(), j_ls_matmul(small_cfg, jnp.asarray(rx))) < REL


@pytest.mark.parametrize("packets,per_block", [(3, 4), (1, 8)])
def test_ls_estimate_pallas_matches_jax_interpret(small_cfg, pcfg, packets,
                                                  per_block):
    """Pair counts (6, 2) not divisible by pairs_per_block (4, 8)."""
    rx = _rx(pcfg, packets, 1 + packets)
    got = ls_estimate_pallas(pcfg, torch.from_numpy(rx),
                             pairs_per_block=per_block)
    ref = j_ls_pallas(small_cfg, jnp.asarray(rx), pairs_per_block=per_block,
                      interpret=True)
    assert _rel(got.numpy(), ref) < REL


def test_per_pair_forms_match_planes(pcfg):
    """Both per-pair forms equal the flat-planes LS rearranged: (S, nt, C)
    rx-major → (B, C, nt, num_rx) time-major."""
    b, nrx = 4, pcfg.num_rx
    rx = torch.from_numpy(_rx(pcfg, b, 9))
    sig = rx.transpose(1, 2).reshape(b * nrx, pcfg.len_ltf)
    h = ls_estimate_planes(pcfg, torch.stack([sig.real, sig.imag]))
    ref = h.reshape(b, nrx, pcfg.num_tx, pcfg.num_carriers).permute(0, 3, 2, 1)
    for got in (ls_estimate_matmul(pcfg, rx), ls_estimate_pallas(pcfg, rx)):
        assert _rel(got.numpy(), ref.numpy()) < REL


def test_pair_planes_layout(pcfg):
    """The CUDA path's input: bf16 planes (2, B·num_rx, len_ltf), sample
    b·num_rx + r, from a contiguous or a transposed-view rx."""
    rx = torch.from_numpy(_rx(pcfg, 3, 5))
    want = rx.transpose(1, 2).reshape(-1, pcfg.len_ltf)
    want = torch.stack([want.real, want.imag]).to(torch.bfloat16)
    for r in (rx, rx.transpose(1, 2).contiguous().transpose(1, 2)):
        got = pair_planes(r)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, want)


def test_empty_batch_counts_no_launch(pcfg):
    """No pairs: the kernel wrapper returns an empty answer before any
    launch, so its launch count does not move."""
    before = ls_pair_kernel.launches
    planes = torch.empty((2, 0, pcfg.len_ltf), dtype=torch.bfloat16)
    out = ls_pair_kernel(pcfg, planes, pcfg.num_rx, ls_sm90_constants(pcfg))
    assert tuple(out.shape) == (0, pcfg.num_carriers, pcfg.num_tx,
                                pcfg.num_rx)
    assert ls_pair_kernel.launches == before
