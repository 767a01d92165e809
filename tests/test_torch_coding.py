"""The port's coding and modulation (mamimo_tpu_torch.ops.coding) against
the JAX package's ``ops/coding.py`` on the same numpy-made inputs: the
trellis, the encoder and the pilots exactly, the Viterbi decoder bit for
bit (batched and one codeword at a time), the QPSK/16-QAM maps and LLRs
to 1e-6 relative, the equalizer to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.ops import coding as jc
from mamimo_tpu_torch.ops import coding as pc

K = 200          # information bits of the test codewords


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_trellis_tables_equal_jax():
    for a, b in zip(pc._trellis(), jc._trellis()):
        np.testing.assert_array_equal(a, b)


def test_conv_encode_equals_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, K)).astype(np.int32)
    got = pc.conv_encode(torch.tensor(bits))
    assert tuple(got.shape) == (3, 3 * (K + 6))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jc.conv_encode(bits[b])))
    np.testing.assert_array_equal(
        pc.conv_encode(torch.tensor(bits[0]), terminated=False).numpy(),
        np.asarray(jc.conv_encode(bits[0], terminated=False)))


@pytest.fixture(scope="module")
def noisy_llrs():
    """JAX's encoder and QPSK LLRs of 4 codewords at three noise levels
    (σ 0.5, 1.0, 1.6: error-free, a few errors, many), and JAX's
    decisions on each."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (4, K)).astype(np.int32)
    dec = jax.jit(lambda l: jc.viterbi_decode(l, K))
    out = {}
    for sigma in (0.5, 1.0, 1.6):
        coded = np.stack([np.asarray(jc.conv_encode(b)) for b in bits])
        syms = np.stack([np.asarray(jc.qpsk_mod(c)) for c in coded])
        n = (rng.standard_normal(syms.shape)
             + 1j * rng.standard_normal(syms.shape)) * sigma / np.sqrt(2)
        y = (syms + n).astype(np.complex64)
        llr = np.stack([np.asarray(jc.qpsk_demod_llr(jnp.asarray(v),
                                                     sigma ** 2))
                        for v in y])
        want = np.stack([np.asarray(dec(jnp.asarray(x))) for x in llr])
        out[sigma] = (bits, llr, want)
    return out


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.6])
def test_viterbi_decodes_as_jax(noisy_llrs, sigma):
    bits, llr, want = noisy_llrs[sigma]
    got = pc.viterbi_decode(torch.tensor(llr), K)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(len(llr)):                     # one codeword at a time
        np.testing.assert_array_equal(
            pc.viterbi_decode(torch.tensor(llr[b]), K).numpy(), want[b])
    errors = int((want != bits).sum())
    if sigma == 0.5:
        assert errors == 0
    if sigma == 1.6:
        assert errors > 0                         # the decoder is exercised


def test_viterbi_unterminated_equals_jax(noisy_llrs):
    _, llr, _ = noisy_llrs[1.0]
    x = llr[0][: 3 * (K + 6)]
    want = np.asarray(jc.viterbi_decode(jnp.asarray(x), K + 6,
                                        terminated=False))
    got = pc.viterbi_decode(torch.tensor(x), K + 6, terminated=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_qpsk_maps_and_llrs_match_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, 64)).astype(np.int32)
    got = pc.qpsk_mod(torch.tensor(bits))
    for b in range(3):
        assert _rel(got[b].numpy(), jc.qpsk_mod(bits[b])) < 1e-6
    np.testing.assert_allclose(pc.qpsk_constellation().numpy(),
                               np.asarray(jc.qpsk_constellation()),
                               rtol=1e-6)
    y = (rng.standard_normal((3, 32)) + 1j * rng.standard_normal((3, 32))
         ).astype(np.complex64)
    nv = np.asarray([0.3, 1.0, 2.5], np.float32)
    got = pc.qpsk_demod_llr(torch.tensor(y), torch.tensor(nv))
    for b in range(3):
        assert _rel(got[b].numpy(), jc.qpsk_demod_llr(y[b], nv[b])) < 1e-6


def test_qam16_tables_maps_and_llrs_match_jax():
    for a, b in zip(pc._qam_tables(16), jc._qam_tables(16)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, 64)).astype(np.int32)
    got = pc.qam_mod(torch.tensor(bits), 16)
    y = (rng.standard_normal((2, 16)) + 1j * rng.standard_normal((2, 16))
         ).astype(np.complex64)
    llr = pc.qam_demod_approx_llr(torch.tensor(y), 16, 0.7)
    for b in range(2):
        assert _rel(got[b].numpy(), jc.qam_mod(bits[b], 16)) < 1e-6
        assert _rel(llr[b].numpy(),
                    jc.qam_demod_approx_llr(y[b], 16, 0.7)) < 1e-6


@pytest.mark.parametrize("nsts", [1, 2])
def test_mimo_equalize_matches_jax(nsts):
    rng = np.random.default_rng(4 + nsts)
    c, nsym, nr = 30, 5, 4

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    rx, h = cn(2, c, nsym, nr), cn(2, c, nsts, nr)
    eq, csi = pc.mimo_equalize(torch.tensor(rx), torch.tensor(h))
    fn = jax.jit(jc.mimo_equalize)
    for b in range(2):
        w_eq, w_csi = fn(jnp.asarray(rx[b]), jnp.asarray(h[b]))
        assert _rel(eq[b].numpy(), w_eq) < 1e-5
        assert _rel(csi[b].numpy(), w_csi) < 1e-5


@pytest.mark.parametrize("nsym,nsts", [(10, 1), (4, 2), (130, 3)])
def test_gen_pilots_equal_jax(nsym, nsts):
    np.testing.assert_array_equal(pc._pilot_polarity_np(nsym),
                                  jc._pilot_polarity_np(nsym))
    np.testing.assert_array_equal(pc.gen_pilots(nsym, nsts).numpy(),
                                  np.asarray(jc.gen_pilots(nsym, nsts)))
