"""The port's DP+TP training step (parallel/sharded.py: param_shardings,
make_sharded_train_step), fit(mesh=...) and the CLI's train --dp/--tp
against the JAX package on the CPU, at Nt 8, Nr 2.

The port runs on meshes of repeated CPU devices; JAX's sharded step on
the 8 virtual CPU devices of tests/conftest.py. Weights come from JAX's
init_fn and move to the port through params_from_jax and place_state;
batches are made with numpy from a seed. Where JAX and the port are
compared, dropout is 0 and the method 'default' (no draws): loss to 2e-4
relative and parameters to 2e-4 absolute (JAX's own tolerances in
tests/test_parallel.py), fit histories to 1e-4 relative (as
tests/test_torch_fit.py). The port's sharded step is held to its
single-card step on the same generator at 1e-5 relative: the loss, the
new BN statistics and the Adam moments (the gradients, leaf by leaf
against its largest value); the parameters at 2e-4 absolute, as JAX's
test (Adam's first step is about -lr·sign(g): an element whose gradient
is near 0 moves by up to lr on the order of the sums).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.parallel import mesh as jmesh
from mamimo_tpu.parallel import sharded as jsh
from mamimo_tpu.pipeline.dataset import CSIDataset as JCSIDataset
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu.train import loop as jloop
from mamimo_tpu_torch.cli import main
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.parallel import sharded
from mamimo_tpu_torch.parallel.mesh import make_mesh
from mamimo_tpu_torch.pipeline.dataset import generate_dataset
from mamimo_tpu_torch.train import loop

CFG = SimConfig(num_tx=8, num_rx=2, n_scatterers=10, n_rays=20)
JCFG = JSimConfig(**dataclasses.asdict(CFG))
BS = 16


def _tcfgs(**kw):
    kw = {"hidden": (64, 64), "batch_size": BS, "dropout": 0.0,
          "method": "default", "seed": 0, **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _batch(seed=0, bs=BS):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((2, bs, CFG.len_ltf)).astype(np.float32)
    pilot = rng.standard_normal((bs, CFG.num_tx)).astype(np.float32)
    y2 = rng.standard_normal((2, bs, CFG.num_carriers)).astype(np.float32)
    return x2, pilot, y2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _vec(leaves):
    return np.concatenate([np.asarray(l, np.float64).ravel() for l in leaves])


def _host(tree):
    return [t.numpy() for t in mlp.tree_leaves(sharded.gather_tree(tree))]


@pytest.fixture(scope="module")
def jax_model():
    """JAX's sharded init on data 4 x model 2 (hidden 64, 64): the JAX
    arrays and their numpy copies."""
    _, jtcfg = _tcfgs()
    jm = jmesh.make_mesh({"data": 4, "model": 2})
    init_fn, step_fn = jsh.make_sharded_train_step(JCFG, jtcfg, jm)
    params, bn, opt_state = init_fn(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, (params, bn))
    return {"params": params, "bn": bn, "opt": opt_state, "step": step_fn,
            "host": host}


# ---- (a) shard shapes --------------------------------------------------

@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"data": 8},
                                  {"data": 2, "model": 4}])
def test_shard_shapes_match_jax(axes, jax_model):
    """Each rank's piece of every leaf has the shape of JAX's addressable
    shard on the same mesh, and param_shardings names the same specs."""
    _, jtcfg = _tcfgs()
    tcfg, _ = _tcfgs()
    jm = jmesh.make_mesh(axes)
    init_fn, _ = jsh.make_sharded_train_step(JCFG, jtcfg, jm)
    jp, jb, _ = init_fn(jax.random.PRNGKey(0))
    mesh = _mesh(axes)
    p_init, _ = sharded.make_sharded_train_step(CFG, tcfg, mesh)
    tp, tb, topt = p_init(torch.Generator().manual_seed(0))
    jsp, jsb = jsh.param_shardings(jm, jp, jb)
    tsp, tsb = sharded.param_shardings(mesh, tp, tb)
    for jl, tl, js, ts in zip(jax.tree.leaves((jp, jb)),
                              mlp.tree_leaves((tp, tb)),
                              jax.tree.leaves((jsp, jsb)),
                              mlp.tree_leaves((tsp, tsb))):
        want = {s.data.shape for s in jl.addressable_shards}
        got = {tuple(t.shape) for _, t in tl.local()}
        assert got == want, (tl, got, want)
        assert tuple(js.spec) == ts.spec.axes
        assert len(tl.local()) == mesh.size
    if "model" in axes:
        w0 = tp["dense"][0]["w"]
        assert {tuple(t.shape) for _, t in w0.local()} == {
            (2, CFG.len_ltf + CFG.num_tx, 64 // axes["model"])}
    # Adam's moments are laid out as the parameters, its count replicated
    for a, b in zip(mlp.tree_leaves(topt.mu), mlp.tree_leaves(tp)):
        assert a.sharding == b.sharding
    assert topt.count.sharding.spec == sharded.P()


# ---- (b) one step against JAX's sharded step and the single card ------

def _port_sharded_step(axes, jp, jb, batch, tcfg, gen=None, lr=1e-3,
                       avg_sig_pow=0.0):
    mesh = _mesh(axes)
    params, bn = mlp.params_from_jax(jp, jb)
    opt = loop.make_optimizer(tcfg)
    state = sharded.place_state(mesh, params, bn, opt.init(params))
    _, step = sharded.make_sharded_train_step(CFG, tcfg, mesh,
                                              avg_sig_pow=avg_sig_pow)
    x2, pilot, y2 = (torch.from_numpy(a) for a in batch)
    return step(*state, x2, pilot, y2, gen, lr)


def _port_single_step(jp, jb, batch, tcfg, gen=None, lr=1e-3,
                      avg_sig_pow=0.0):
    params, bn = mlp.params_from_jax(jp, jb)
    opt = loop.make_optimizer(tcfg)
    upd, _ = loop.make_batch_update(CFG, tcfg, avg_sig_pow, opt)
    x2, pilot, y2 = (torch.from_numpy(a) for a in batch)
    return upd(params, bn, opt.init(params), x2, pilot, y2, gen, lr)


def _hold_to_single(sh, one, p0):
    """The sharded step's outputs against the single card's at 1e-5."""
    params, bn, st, loss = sh
    params1, bn1, st1, loss1 = one
    assert _rel(loss.numpy(), loss1.numpy()) <= 1e-5
    for a, b in zip(_host(bn), mlp.tree_leaves(bn1)):
        assert _rel(a, b.numpy()) <= 1e-5
    for a, b in zip(_host(st.mu) + _host(st.nu),
                    mlp.tree_leaves(st1.mu) + mlp.tree_leaves(st1.nu)):
        assert _rel(a, b.numpy()) <= 1e-5
    assert all(int(t) == 1 for _, t in st.count.local())
    np.testing.assert_allclose(
        _vec(_host(params)),
        _vec(t.numpy() for t in mlp.tree_leaves(params1)), rtol=0,
        atol=2e-4)


def test_step_matches_jax_sharded_step(jax_model):
    """One step on data 4 x model 2 (dropout 0, method 'default') against
    JAX's sharded step on the same mesh shape, weights and batch."""
    tcfg, _ = _tcfgs()
    batch = _batch(0)
    jp_, jb_ = jax_model["host"]
    j_out = jax_model["step"](
        jax.tree.map(jnp.asarray, jp_), jax.tree.map(jnp.asarray, jb_),
        jax_model["opt"], *map(jnp.asarray, batch), jax.random.PRNGKey(7),
        1e-3)
    jp1, jb1, _, jloss = jax.tree.map(np.asarray, j_out)
    params, bn, _, loss = _port_sharded_step({"data": 4, "model": 2}, jp_,
                                             jb_, batch, tcfg)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=2e-4)
    for a, b in zip(_host(params), jax.tree.leaves(jp1)):
        np.testing.assert_allclose(a, b, atol=2e-4)
    for a, b in zip(_host(bn), jax.tree.leaves(jb1)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"data": 4},
                                  {"data": 2, "model": 2}, {"model": 2}])
def test_step_matches_single_card(axes, jax_model):
    tcfg, _ = _tcfgs()
    jp, jb = jax_model["host"]
    batch = _batch(1)
    _hold_to_single(_port_sharded_step(axes, jp, jb, batch, tcfg),
                    _port_single_step(jp, jb, batch, tcfg),
                    _vec(jax.tree.leaves(jp)))


# ---- (c) BatchNorm over the global batch -------------------------------

def test_bn_statistics_are_global(jax_model):
    """Each data rank's rows are scaled and shifted differently, so the
    per-rank statistics are far from the global ones; the sharded step's
    new BN state equals the single card's (1e-5)."""
    tcfg, _ = _tcfgs()
    jp, jb = jax_model["host"]
    x2, pilot, y2 = _batch(2)
    scale = np.repeat([0.2, 1.0, 3.0, 7.0], BS // 4).astype(np.float32)
    x2 = x2 * scale[None, :, None] + scale[None, :, None]
    batch = (x2, pilot, y2)
    sh = _port_sharded_step({"data": 4, "model": 2}, jp, jb, batch, tcfg)
    one = _port_single_step(jp, jb, batch, tcfg)
    _hold_to_single(sh, one, _vec(jax.tree.leaves(jp)))
    # the per-rank statistics of layer 0 would have been far off
    params, bn = mlp.params_from_jax(jp, jb)
    xin = mlp.preprocess_input(CFG, tcfg, torch.from_numpy(x2),
                               torch.stack([torch.from_numpy(pilot)] * 2))
    h = torch.relu(xin @ params["dense"][0]["w"]
                   + params["dense"][0]["b"][:, None])
    whole = h.mean(-2)
    per_rank = [h[:, 4 * i:4 * (i + 1)].mean(-2) for i in range(4)]
    assert max(_rel(p.numpy(), whole.numpy()) for p in per_rank) > 0.1


# ---- (d) AWGN and dropout on -------------------------------------------

@pytest.mark.parametrize("awgn_rng", ["rbg_clt", "threefry"])
def test_draws_match_single_card(awgn_rng, jax_model):
    """default_snr with AWGN and dropout 0.15: the sharded step draws the
    SNR indices, the noise and the masks of the single-card step from the
    same generator, at the global shapes."""
    tcfg, _ = _tcfgs(dropout=0.15, method="default_snr", awgn_rng=awgn_rng)
    jp, jb = jax_model["host"]
    batch = _batch(3)
    sh = _port_sharded_step({"data": 4, "model": 2}, jp, jb, batch, tcfg,
                            gen=torch.Generator().manual_seed(11),
                            avg_sig_pow=1.0)
    one = _port_single_step(jp, jb, batch, tcfg,
                            gen=torch.Generator().manual_seed(11),
                            avg_sig_pow=1.0)
    _hold_to_single(sh, one, _vec(jax.tree.leaves(jp)))


def test_gather_step_and_eval_match_array_form(jax_model):
    """step_fn.gather on a replicated device dataset equals the array step
    on the same gathered batch; gather_eval equals array_eval."""
    tcfg, _ = _tcfgs()
    jp, jb = jax_model["host"]
    mesh = _mesh({"data": 4, "model": 2})
    rng = np.random.default_rng(4)
    data = {"rx": torch.from_numpy((rng.standard_normal((3, CFG.len_ltf, 2))
                                    + 1j * rng.standard_normal(
                                        (3, CFG.len_ltf, 2)))
                                   .astype(np.complex64)),
            "h": torch.from_numpy((rng.standard_normal((3, 234, 8, 2))
                                   + 0j).astype(np.complex64)),
            "P": torch.from_numpy(rng.choice([-1.0, 1.0], (8, 8))
                                  .astype(np.float32))}
    idx = rng.permutation(48)[:BS]
    batch = loop._gather_batch(CFG, data, torch.as_tensor(idx))
    rep = sharded.replicate(mesh, data)
    _, step = sharded.make_sharded_train_step(CFG, tcfg, mesh)
    outs = []
    for use_gather in (True, False):
        params, bn = mlp.params_from_jax(jp, jb)
        opt = loop.make_optimizer(tcfg)
        state = sharded.place_state(mesh, params, bn, opt.init(params))
        ev = (step.gather_eval(*state[:2], rep, idx) if use_gather
              else step.array_eval(*state[:2], *batch))
        out = (step.gather(*state, rep, idx, None, 1e-3) if use_gather
               else step(*state, *batch, None, 1e-3))
        outs.append((ev, out[3], _host(out[0])))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_array_equal(a, b)


# ---- (e) fit(mesh=...) in its three modes, and resume ------------------

def _jax_ds(ds):
    return JCSIDataset(
        cfg=JCFG, rx=ds.rx, h_ls=ds.h_ls, h_perfect=ds.h_perfect,
        snr_cs=ds.snr_cs, noise_db=ds.noise_db, tau=ds.tau,
        chan_delay=ds.chan_delay, snr_target=ds.snr_target, seed=ds.seed,
        scenario=None, h_mmse=ds.h_mmse)


@pytest.fixture(scope="module")
def corpora():
    tr = generate_dataset(CFG, seed=0, num_packets=12, snr_db=120.0,
                          chunk=12, fft_size=4096, device="cpu")
    va = generate_dataset(CFG, seed=7, num_packets=4, snr_db=120.0,
                          chunk=4, fft_size=4096, device="cpu")
    return {"train": (tr, _jax_ds(tr)), "val": (va, _jax_ds(va))}


MODES = {"in_hbm": {}, "host_stream": {"host_stream": True},
         "window": {"host_stream": True, "stream_window_packets": 4}}


@pytest.mark.parametrize("mode", list(MODES))
def test_fit_mesh_matches_jax(mode, corpora, tmp_path):
    """fit(mesh=...) on data 4 x model 2 in each mode against JAX's
    fit(mesh=...) on the same mesh shape, both resumed from one JAX
    checkpoint (val on another placement): the histories agree to 1e-4,
    the best weights to 1e-3 of their norm. The checkpoint says epoch 1:
    JAX's mesh path re-places a checkpoint's arrays only past epoch 0 (at
    epoch 0 it draws its own initial weights); both skip the first
    epoch's shuffle."""
    tcfg, jtcfg = _tcfgs(hidden=(32, 32), lr=1e-3, epochs=3, seed=1,
                         early_stop_patience=50)
    (tr, jtr), (va, jva) = corpora["train"], corpora["val"]
    p, b = jmlp.init_stacked(jax.random.PRNGKey(5), JCFG, jtcfg)
    jckpt.save_checkpoint(str(tmp_path / "seed" / "last"), JCFG, jtcfg, p, b,
                          extra={"epoch": 1},
                          opt_state=jloop.make_optimizer(jtcfg).init(p))
    for who in ("jax", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / who)
    rj = jloop.fit(JCFG, jtcfg, jtr, val_ds=jva, verbose=False,
                   workdir=str(tmp_path / "jax"), resume=True,
                   mesh=jmesh.make_mesh({"data": 4, "model": 2}),
                   **MODES[mode])
    rp = loop.fit(CFG, tcfg, tr, val_ds=va, verbose=False,
                  workdir=str(tmp_path / "port"), resume=True,
                  mesh=_mesh({"data": 4, "model": 2}), **MODES[mode])
    assert rp.epochs_ran == rj.epochs_ran
    assert rp.history["lr"] == rj.history["lr"]
    for k in ("loss_real", "loss_imag", "val_loss_real", "val_loss_imag"):
        np.testing.assert_allclose(rp.history[k], rj.history[k], rtol=1e-4,
                                   err_msg=k)
    vj = _vec(jax.tree.leaves(rj.params))
    vp = _vec(t.numpy() for t in mlp.tree_leaves(rp.params))
    assert np.linalg.norm(vp - vj) <= 1e-3 * np.linalg.norm(vj)
    for f in ("best.json", "last.json", "last_opt.npz", "history.json"):
        assert os.path.exists(tmp_path / "port" / f)


@pytest.mark.parametrize("mode", ["in_hbm", "window"])
def test_fit_mesh_resume_equals_uninterrupted(mode, corpora, tmp_path):
    """With the AWGN on (rbg_clt) and dropout, 2 epochs on the mesh then a
    resume to 3 (the checkpointed arrays, Adam's moments and count
    re-placed with param_shardings) equal 3 straight epochs; and the mesh
    fit equals the single-card fit on the same step generators."""
    tr, _ = corpora["train"]
    tcfg = TrainConfig(hidden=(32, 32), batch_size=16, epochs=3, seed=4,
                       early_stop_patience=50)
    mesh = _mesh({"data": 2, "model": 2})
    straight = loop.fit(CFG, tcfg, tr, verbose=False, mesh=mesh,
                        **MODES[mode])
    loop.fit(CFG, tcfg.replace(epochs=2), tr, workdir=str(tmp_path / "b"),
             verbose=False, mesh=mesh, **MODES[mode])
    resumed = loop.fit(CFG, tcfg, tr, workdir=str(tmp_path / "b"),
                       verbose=False, resume=True, mesh=mesh, **MODES[mode])
    single = loop.fit(CFG, tcfg, tr, verbose=False, device="cpu",
                      **MODES[mode])
    assert resumed.epochs_ran == straight.epochs_ran == 3
    for k in straight.history:
        np.testing.assert_allclose(resumed.history[k], straight.history[k],
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(single.history[k], straight.history[k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(
        _vec(t.numpy() for t in mlp.tree_leaves(resumed.params)),
        _vec(t.numpy() for t in mlp.tree_leaves(straight.params)),
        rtol=1e-6, atol=1e-7)


# ---- (g) the CLI --------------------------------------------------------

def test_cli_train_dp_tp(corpora, tmp_path):
    """train --dp 2 --tp 2 --device cpu trains over a data 2 x model 2 mesh
    of CPU ranks: its history equals fit(mesh=...)'s on the same data."""
    tr, _ = corpora["train"]
    tr.save(str(tmp_path / "train.npz"))
    args = ["train", "-x", str(tmp_path / "train.npz"), "-d",
            str(tmp_path / "model"), "--nn", "32", "32", "--bs", "16",
            "--epochs", "2", "--seed", "3", "--dp", "2", "--tp", "2",
            "--device", "cpu"]
    main(args)
    import json

    with open(tmp_path / "model" / "history.json") as f:
        hist = json.load(f)
    ck = loop.load_checkpoint(str(tmp_path / "model" / "best"))
    ref = loop.fit(CFG, ck["tcfg"], tr, verbose=False,
                   mesh=_mesh({"data": 2, "model": 2}))
    for k in ref.history:
        np.testing.assert_allclose(hist[k], ref.history[k], rtol=1e-6,
                                   err_msg=k)
    if not torch.cuda.is_available():
        # the default ranks are the visible cards, and there are none here
        with pytest.raises(RuntimeError, match="needs 4 cards"):
            main(args[:-2])


# ---- the multi-chip dry run ---------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_ranks(n):
    """dryrun_multichip on n CPU ranks at a small size (BS32 runs on the
    card, chip_smoke.py phase 5k): one DP+TP step, the sharded LS and
    inference forms, both convolutions, the LS in data and seq modes, and
    with 8 ranks the combined data x seq x antenna step; by default it
    wants the cards, and there are none here."""
    from mamimo_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(n, devices=["cpu"] * n,
                           cfg=SimConfig(num_tx=8, num_rx=2, n_scatterers=8),
                           tcfg=TrainConfig(hidden=(64, 64), batch_size=16))
    assert np.isfinite(out["loss"]).all()
    assert out["sharded_apply_channel_rdma_rel_err"] <= 2e-4
    assert ("sharded_estimate_combined h_dnn" in out) == (n >= 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA GPUs"):
            dryrun_multichip(n)
