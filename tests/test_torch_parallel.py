"""The port's sharded forms against the JAX package on meshes of CPU ranks
(mamimo_tpu_torch.parallel.{mesh,halo,rdma_halo,sharded} and the
sequence-sharded mode of ops.kernels.fused_ls.ls_planes_v2).

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py,
its Pallas kernels in interpret mode, as the JAX package's own tests
run them; the port's ranks are repeats of the CPU device, where each
wrapper runs its kernel's plain version. Inputs are made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models.mlp import init_stacked as j_init_stacked
from mamimo_tpu.parallel import halo as jhalo
from mamimo_tpu.parallel import sharded as jsh
from mamimo_tpu.parallel.mesh import make_mesh as j_make_mesh
from mamimo_tpu_torch.channel import scattering as ps
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import params_from_jax, predict_all_pairs
from mamimo_tpu_torch.ops.estimate import ls_estimate_matmul
from mamimo_tpu_torch.ops.kernels.fused_ls import ls_planes_v2
from mamimo_tpu_torch.ops.ltf import _hadamard_np
from mamimo_tpu_torch.parallel import halo, sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh
from mamimo_tpu_torch.parallel.rdma_halo import (
    halo_exchange_pallas,
    sharded_apply_channel_rdma,
)

KW = dict(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)   # small_cfg
CFG, JCFG = SimConfig(**KW), JSimConfig(**KW)


def _cpu_mesh(**axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _jax_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return j_make_mesh(axes, devices=jax.devices()[:n])


def _rx(b, seed):
    z = np.random.default_rng(seed).standard_normal(
        (b, CFG.len_ltf, CFG.num_rx, 2)).astype(np.float32)
    return (z[..., 0] + 1j * z[..., 1]).astype(np.complex64)


def test_make_mesh():
    m = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2}
    assert m.first == torch.device("cpu")
    assert m.axis_devices("model") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 3 devices, got 8"):
        make_mesh({"data": 3}, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        m.device(seq=0)
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3}


@pytest.fixture(scope="module")
def channel():
    """test_halo_sharded_channel_conv's problem (tests/test_parallel.py):
    the padded preamble through a 512-tap realization, each of 8 chunks
    longer than the channel memory; JAX's realization as numpy."""
    from mamimo_tpu.channel.scattering import make_scenario, realize_channel
    from mamimo_tpu.ops.ltf import gen_preamble
    from mamimo_tpu.pipeline.sounding import pad_signal as j_pad

    key = jax.random.PRNGKey(6)
    scen = make_scenario(JCFG, key)
    jchan = realize_channel(JCFG, jax.random.fold_in(key, 0), scen)
    sig = j_pad(JCFG, jnp.asarray(gen_preamble(JCFG, JCFG.num_tx)))
    n = max(((sig.shape[0] + 7) // 8) * 8, 8 * 520)
    sig = jnp.concatenate(
        [sig, jnp.zeros((n - sig.shape[0], JCFG.num_tx), sig.dtype)])
    jtaps = jhalo.channel_taps(JCFG, jchan, n_taps=512)
    chan = ps.ChannelRealization(*(torch.tensor(np.asarray(a))
                                   for a in jchan))
    return jchan, chan, sig, jtaps


def test_taps_and_unsharded_conv_match_jax(channel):
    jchan, chan, sig, jtaps = channel
    taps = halo.channel_taps(CFG, chan, n_taps=512)
    ref = np.asarray(jtaps)
    assert taps.shape == ref.shape and taps.dtype == torch.complex64
    np.testing.assert_allclose(taps.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    ref = np.asarray(jhalo.apply_channel_taps(sig, jtaps))
    got = halo.apply_channel_taps(torch.tensor(np.asarray(sig)),
                                  torch.tensor(np.asarray(jtaps)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    # the FIR form against the exact phase-ramp application
    exact = ps.apply_channel(CFG, torch.tensor(np.asarray(sig)), chan,
                             fft_size=8192).numpy()
    assert np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact) < 5e-2


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_apply_channel_matches_jax(channel, d):
    _, _, sig, jtaps = channel
    ref = np.asarray(jhalo.sharded_apply_channel(JCFG, _jax_mesh(seq=d), sig,
                                                 jtaps))
    unsharded = np.asarray(jhalo.apply_channel_taps(sig, jtaps))
    mesh = _cpu_mesh(seq=d)
    x, taps = torch.tensor(np.asarray(sig)), torch.tensor(np.asarray(jtaps))
    for fn in (halo.sharded_apply_channel, sharded_apply_channel_rdma):
        got = fn(CFG, mesh, x, taps).numpy()
        assert got.shape == ref.shape and got.dtype == np.complex64
        for want in (ref, unsharded):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-4 * np.abs(want).max())
        err = np.linalg.norm(got - unsharded) / np.linalg.norm(unsharded)
        assert err < 1e-4, (fn.__name__, d, err)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_apply_channel_rdma_matches_jax_rdma(channel, d):
    """The port's fused convolution (complex chunks through kernel 7's
    plain version) against JAX's sharded_apply_channel_rdma, its Pallas
    exchange in interpret mode, with test_sharded_apply_channel_matches_jax's
    tolerances."""
    from mamimo_tpu.parallel.rdma_halo import (
        sharded_apply_channel_rdma as j_rdma,
    )

    _, _, sig, jtaps = channel
    ref = np.asarray(j_rdma(JCFG, _jax_mesh(seq=d), sig, jtaps))
    unsharded = np.asarray(jhalo.apply_channel_taps(sig, jtaps))
    got = sharded_apply_channel_rdma(
        CFG, _cpu_mesh(seq=d), torch.tensor(np.asarray(sig)),
        torch.tensor(np.asarray(jtaps))).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
    err = np.linalg.norm(got - unsharded) / np.linalg.norm(unsharded)
    assert err < 1e-4, (d, err)


def test_halo_block_bit_equal_to_jax_kernel():
    """The port's extended blocks equal, bit for bit, those of the JAX
    kernel run under shard_map in interpret mode (tests/test_rdma_halo.py's
    shapes: 4 ranks, chunk 320, halo 96)."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import PartitionSpec as P

    from mamimo_tpu.parallel.rdma_halo import halo_exchange_pallas as j_halo

    n_dev, chunk, halo_n, nt = 4, 320, 96, 8
    planes = np.random.default_rng(1).standard_normal(
        (2, n_dev * chunk, nt)).astype(np.float32)
    ext = jax.shard_map(
        lambda p: j_halo(p, halo_n, axis="seq",
                         interpret=pltpu.InterpretParams()),
        mesh=_jax_mesh(seq=n_dev), in_specs=P(None, "seq", None),
        out_specs=P(None, "seq", None), check_vma=False,
    )(jnp.asarray(planes))
    ref = np.asarray(ext).reshape(2, n_dev, halo_n + chunk, nt)
    got = halo_exchange_pallas(
        _cpu_mesh(seq=n_dev),
        [torch.tensor(planes[:, r * chunk:(r + 1) * chunk])
         for r in range(n_dev)], halo_n)
    assert len(got) == n_dev
    for r, blk in enumerate(got):
        assert blk.shape == (2, halo_n + chunk, nt)
        np.testing.assert_array_equal(blk.numpy(), ref[:, r])
    np.testing.assert_array_equal(got[0][:, :halo_n].numpy(), 0.0)


def test_halo_exchange_refuses_bad_blocks():
    mesh = _cpu_mesh(seq=2)
    x = [torch.zeros((2, 16, 4)) for _ in range(2)]
    with pytest.raises(ValueError, match="exceed the halo"):
        halo_exchange_pallas(mesh, x, 16)
    with pytest.raises(ValueError, match="planes for"):
        halo_exchange_pallas(mesh, x[:1], 4)
    with pytest.raises(ValueError, match="float32"):
        halo_exchange_pallas(mesh, [x[0], x[1].double()], 4)
    with pytest.raises(ValueError):
        halo.sharded_apply_channel(
            CFG, mesh, torch.zeros((30, 8), dtype=torch.complex64),
            torch.zeros((16, 8, 2), dtype=torch.complex64))


@pytest.mark.parametrize("nt", [8, 32])
def test_kronecker_identity_of_the_seq_despread(nt):
    """P = H_n ⊗ H_loc: rank i's partial despread P[:, i·loc:(i+1)·loc] z
    is the loc-point Walsh–Hadamard transform w = H_loc z, stored to row
    a·loc + b as (−1)^popcount(a & i)·w[b] — the seq-mode store of
    csrc/ls_v2.cu, checked here in float64."""
    p = _hadamard_np(nt).astype(np.float64)
    z_all = np.random.default_rng(nt).standard_normal((nt, 5))
    for n in (1, 2, 4, 8):
        loc = nt // n
        h_loc = _hadamard_np(loc)
        total = np.zeros((nt, 5))
        for i in range(n):
            z = z_all[i * loc:(i + 1) * loc]
            w = h_loc @ z
            part = np.stack([(-1.0) ** bin(a & i).count("1") * w[b]
                             for a in range(n) for b in range(loc)])
            for a in range(n):
                for m in range(loc):
                    for b in range(loc):
                        assert p[a * loc + b, i * loc + m] == \
                            (-1.0) ** bin(a & i).count("1") * h_loc[b, m]
            np.testing.assert_allclose(part, p[:, i * loc:(i + 1) * loc] @ z,
                                       rtol=0, atol=1e-12)
            total += part
        np.testing.assert_allclose(total, p @ z_all, rtol=0, atol=1e-12)


def test_ls_planes_v2_seq_partials_sum_to_the_estimate():
    s, cfg = 3, CFG
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32))
    full = ls_planes_v2(cfg, x)
    for n in (2, 4, 8):
        L = cfg.len_ltf // n
        parts = [ls_planes_v2(cfg, x[:, :, i * L:(i + 1) * L],
                              seq_shard=(i, n)) for i in range(n)]
        assert all(p.shape == full.shape for p in parts)
        np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), rtol=0,
                                   atol=2e-4)
    with pytest.raises(ValueError, match="planes must be"):
        ls_planes_v2(cfg, x, seq_shard=(0, 2))
    with pytest.raises(ValueError, match="seq_shard"):
        ls_planes_v2(cfg, x[:, :, :cfg.len_ltf // 3], seq_shard=(0, 3))


def test_sharded_ls_pallas_v2_matches_jax():
    """Data (4 ranks) and seq (2, 4 ranks) modes against JAX's
    sharded_ls_pallas_v2 (its kernel in interpret mode on the CPU mesh,
    as tests/test_parallel.py runs it)."""
    s = 8
    planes = np.random.default_rng(11).standard_normal(
        (2, s, CFG.len_ltf)).astype(np.float32)
    x = torch.tensor(planes)
    for mode, n in (("data", 4), ("seq", 2), ("seq", 4)):
        axis = {mode: n}
        ref = np.asarray(jsh.sharded_ls_pallas_v2(
            JCFG, _jax_mesh(**axis), jnp.asarray(planes), mode=mode,
            block_samples=2))
        got = sharded.sharded_ls_pallas_v2(CFG, _cpu_mesh(**axis), x,
                                           mode=mode)
        assert got.shape == ref.shape and got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4,
                                   err_msg=f"{mode} {n}")
    with pytest.raises(ValueError, match="mode"):
        sharded.sharded_ls_pallas_v2(CFG, _cpu_mesh(seq=2), x, mode="model")


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sum_onto_leaves_the_partials(n):
    parts = [torch.full((2, 3), float(i + 1)) for i in range(n)]
    total = sharded.sum_onto(parts, torch.device("cpu"))
    np.testing.assert_array_equal(total.numpy(), n * (n + 1) / 2)
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(p.numpy(), float(i + 1))
    assert all(total.data_ptr() != p.data_ptr() for p in parts)


@pytest.mark.parametrize("n_seq", [2, 4, 8])
def test_sharded_ls_estimate_matches_jax(n_seq):
    rx = _rx(3, seed=n_seq)
    ref = np.asarray(jsh.sharded_ls_estimate(JCFG, _jax_mesh(seq=n_seq),
                                             jnp.asarray(rx)))
    got = sharded.sharded_ls_estimate(CFG, _cpu_mesh(seq=n_seq),
                                      torch.tensor(rx)).numpy()
    assert got.shape == (3, CFG.num_carriers, CFG.num_tx, CFG.num_rx)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    unsharded = ls_estimate_matmul(CFG, torch.tensor(rx)).numpy()
    np.testing.assert_allclose(got, unsharded, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def model():
    tcfg, jtcfg = TrainConfig(hidden=(64, 32)), JTrainConfig(hidden=(64, 32))
    jp, jb = jax.tree.map(np.asarray, j_init_stacked(jax.random.PRNGKey(0),
                                                     JCFG, jtcfg))
    rng = np.random.default_rng(2)
    jb = {"mean": [rng.normal(0, 0.1, m.shape).astype(np.float32)
                   for m in jb["mean"]],
          "var": [rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                  for v in jb["var"]]}
    return tcfg, jtcfg, jp, jb


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_predict_all_pairs_matches_jax(model, n):
    tcfg, jtcfg, jp, jb = model
    rx = _rx(2, seed=20 + n)
    ref = np.asarray(jsh.sharded_predict_all_pairs(
        JCFG, jtcfg, _jax_mesh(antenna=n), jp, jb, jnp.asarray(rx)))
    params, bn = params_from_jax(jp, jb)
    got = sharded.sharded_predict_all_pairs(CFG, tcfg, _cpu_mesh(antenna=n),
                                            params, bn, torch.tensor(rx))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), predict_all_pairs(CFG, tcfg, params, bn,
                                       torch.tensor(rx)).numpy(),
        rtol=0, atol=2e-4)


def test_sharded_estimate_combined_matches_jax(model):
    tcfg, jtcfg, jp, jb = model
    rx = _rx(4, seed=9)
    axes = {"data": 2, "seq": 2, "antenna": 2}
    ref_ls, ref_dnn = jsh.sharded_estimate_combined(
        JCFG, jtcfg, _jax_mesh(**axes), jp, jb, jnp.asarray(rx))
    params, bn = params_from_jax(jp, jb)
    h_ls, h_dnn = sharded.sharded_estimate_combined(
        CFG, tcfg, _cpu_mesh(**axes), params, bn, torch.tensor(rx))
    ref_ls, ref_dnn = np.asarray(ref_ls), np.asarray(ref_dnn)
    assert h_ls.shape == ref_ls.shape and h_dnn.shape == ref_dnn.shape
    np.testing.assert_allclose(h_ls.numpy(), ref_ls, rtol=0,
                               atol=2e-5 * np.abs(ref_ls).max())
    np.testing.assert_allclose(h_dnn.numpy(), ref_dnn, rtol=2e-4, atol=2e-4)
