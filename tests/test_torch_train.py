"""The port's training step (mamimo_tpu_torch.train.loop, the training
mode of models.mlp, the optimizer state of train.ckpt and
bench.run_train_bench) against the JAX package on the CPU, at Nt 8,
Nr 2 and hidden (64, 64).

Weights come from the JAX init_stacked and move to the port through
params_from_jax; batches are made with numpy from a seed; both packages
then run the same arrays. Dropout is 0 and the AWGN off (or injected)
wherever two steps are compared, since the two packages draw from
different generators. Tolerances are stated in each test: f32 to float32
rounding, bf16 to the bf16 rounding points the port reproduces.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.ops.ltf import pilot_p_matrix as j_pilot
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu.train import loop as jloop
from mamimo_tpu_torch import bench
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.train import ckpt, loop

HIDDEN = (64, 64)
BS = 16


@pytest.fixture(scope="module")
def cfgs(small_cfg):
    """(port SimConfig, JAX SimConfig) of the small configuration."""
    return SimConfig(**dataclasses.asdict(small_cfg)), small_cfg


def _tcfgs(**kw):
    kw = {"hidden": HIDDEN, "batch_size": BS, "dropout": 0.0,
          "method": "default", **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _model(jcfg, jtcfg, seed):
    """JAX parameters (numpy) with a non-trivial BN state and biases."""
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), jcfg, jtcfg))
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)                    # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    return jp, jb


def _batch(cfg, bs, seed):
    """(x2 (2, bs, L), pilot (bs, T), y2 (2, bs, C)) float32 numpy."""
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((2, bs, cfg.len_ltf)).astype(np.float32)
    pilot = np.asarray(j_pilot(cfg.num_tx))[
        :, rng.integers(0, cfg.num_tx, bs)].T.copy()
    y2 = rng.standard_normal((2, bs, cfg.num_carriers)).astype(np.float32)
    return x2, pilot, y2


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _nmse_db(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    err = np.sum((got - ref) ** 2)
    return -np.inf if err == 0 else 10 * np.log10(err / np.sum(ref ** 2))


def _rel(got, ref):
    """max |got − ref| / max |ref|."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _leaves(tree):
    return [_np(l) for l in mlp.tree_leaves(tree)]


def _jleaves(tree):
    return [_np(l) for l in jax.tree_util.tree_leaves(tree)]


def _jax_step(jcfg, jtcfg, jp, jb, batch, key=0, avg_sig_pow=1.0):
    jopt = jloop.make_optimizer(jtcfg)
    jstate = jopt.init(jp)
    upd, _ = jloop.make_array_train_step(jcfg, jtcfg, avg_sig_pow, jopt)
    x2, pilot, y2 = map(jnp.asarray, batch)
    out = upd(jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jb),
              jstate, x2, pilot, y2, jax.random.PRNGKey(key), jtcfg.lr)
    return jax.tree.map(np.asarray, out)


def _port_step(cfg, tcfg, jp, jb, batch, gen=None, avg_sig_pow=1.0):
    tp, tb = mlp.params_from_jax(jp, jb)
    opt = loop.make_optimizer(tcfg)
    state = opt.init(tp)
    upd, _ = loop.make_array_train_step(cfg, tcfg, avg_sig_pow, opt)
    x2, pilot, y2 = (torch.from_numpy(a) for a in batch)
    return upd(tp, tb, state, x2, pilot, y2,
               gen or torch.Generator().manual_seed(0), tcfg.lr)


def _assert_step_close(got, ref, jp, delta_db, stat_rel, moment_db=None,
                       per_leaf=True):
    """The port's (params, bn, opt_state, per_dim) against JAX's: the
    per-plane loss and the BN statistics to ``stat_rel`` relative; the
    Adam moments to ``moment_db`` NMSE (default ``delta_db``), leaf by
    leaf; the change of the parameters to ``delta_db`` NMSE, leaf by leaf
    or, with ``per_leaf=False``, over all of them as one vector."""
    tp, tb, ts, tloss = got
    jp1, jb1, js, jloss = ref
    assert _rel(tloss, jloss) <= stat_rel
    for t, j in zip(_leaves(tb), _jleaves(jb1)):
        assert _rel(t, j) <= stat_rel
    assert int(ts.count) == int(np.asarray(js.count))
    for t, j in zip(_leaves(ts.mu) + _leaves(ts.nu),
                    _jleaves(js.mu) + _jleaves(js.nu)):
        assert _nmse_db(t, j) <= (moment_db or delta_db)
    deltas = [(t - p0, j - p0) for t, j, p0 in
              zip(_leaves(tp), _jleaves(jp1), _jleaves(jp))]
    if per_leaf:
        for dt, dj in deltas:
            assert _nmse_db(dt, dj) <= delta_db
    else:
        flat = lambda i: np.concatenate(                    # noqa: E731
            [d[i].ravel() for d in deltas])
        assert _nmse_db(flat(0), flat(1)) <= delta_db


# f32: the loss and BN statistics to 1e-5 relative, Δparams and the Adam
# moments to -60 dB NMSE. bf16: the same products on the same bf16
# operands, at the same rounding points, so the same bounds apart from
# Δparams and moments at -40 dB (a bf16-rounded cotangent can round the
# other way after a reordered f32 sum).
@pytest.mark.parametrize("matmul_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("variant", [
    {}, {"input_norm": "rms"}, {"dims": ("real",)}, {"dims": ("imag",)}],
    ids=["both", "rms", "only_real", "only_imag"])
def test_array_step_matches_jax(cfgs, matmul_dtype, use_bn, variant):
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(matmul_dtype=matmul_dtype, use_bn=use_bn, **variant)
    jp, jb = _model(jcfg, jtcfg, seed=1)
    batch = _batch(cfg, BS, seed=2)
    ref = _jax_step(jcfg, jtcfg, jp, jb, batch)
    got = _port_step(cfg, tcfg, jp, jb, batch)
    _assert_step_close(got, ref, jp,
                       -60.0 if matmul_dtype == "f32" else -40.0, 1e-5)
    if "dims" in variant:               # the masked plane kept everything
        d = 1 if variant["dims"] == ("real",) else 0
        for t, p0 in zip(_leaves(got[0]), _jleaves(jp)):
            np.testing.assert_array_equal(t[d], p0[d])
        for t, b0 in zip(_leaves(got[1]), _jleaves(jb)):
            np.testing.assert_array_equal(t[d], b0[d])


@pytest.mark.parametrize("matmul_dtype", ["f32", "bf16"])
def test_awgn_step_matches_jax_with_its_noise(cfgs, monkeypatch,
                                             matmul_dtype):
    """method 'default_snr': JAX's SNR indices and noise, re-derived from
    its split(key, 3), injected into the port's draw; the per-plane SNR,
    the std and the rms normalization then match (bounds as above)."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(matmul_dtype=matmul_dtype, method="default_snr",
                         awgn_rng="threefry", input_norm="rms")
    jp, jb = _model(jcfg, jtcfg, seed=3)
    batch = _batch(cfg, BS, seed=4)
    avg = 0.7
    ref = _jax_step(jcfg, jtcfg, jp, jb, batch, key=5, avg_sig_pow=avg)
    k_snr, k_noise, _ = jax.random.split(jax.random.PRNGKey(5), 3)
    idx = np.array(jax.random.randint(
        k_snr, (2,), 0, len(jtcfg.awgn_snr_levels)))
    noise = np.array(jax.random.normal(k_noise, batch[0].shape))
    calls = []

    def injected(tcfg_, n_levels, shape, gen):
        calls.append((n_levels, tuple(shape)))
        return torch.from_numpy(idx).long(), torch.from_numpy(noise)

    monkeypatch.setattr(loop, "draw_awgn", injected)
    got = _port_step(cfg, tcfg, jp, jb, batch, avg_sig_pow=avg)
    assert calls == [(6, batch[0].shape)]
    if matmul_dtype == "f32":
        _assert_step_close(got, ref, jp, -60.0, 1e-5)
        return
    # bf16: the noisy input is cast to bf16 after float32 arithmetic whose
    # last bit can differ (the rms sums and the SNR power in another
    # order), and a one-ulp float32 difference can move a value by one bf16
    # ulp (0.03 at the -10 dB level's noise). So the loss and BN statistics
    # to 1e-4 and the moments to -45 dB; the first Adam step is about
    # -lr·sign(g), so the elements whose |g| lies under that gradient
    # error change sign, and Δparams is held to -20 dB over all parameters
    _assert_step_close(got, ref, jp, -20.0, 1e-4, moment_db=-45.0,
                       per_leaf=False)


@pytest.mark.parametrize("opt_dtype", ["f32", "bf16"])
def test_optimizer_matches_optax(opt_dtype):
    """make_optimizer against optax.scale_by_adam (mu_dtype None / bf16)
    for 3 updates from a state at count 4 carried over by
    opt_state_from_jax: updates and moments to 1e-6 relative, a bf16
    first moment bit for bit."""
    jtcfg = JTrainConfig(opt_dtype=opt_dtype)
    tcfg = TrainConfig(opt_dtype=opt_dtype)
    rng = np.random.default_rng(6)
    shapes = {"dense": [{"w": (2, 12, 8), "b": (2, 8)}],
              "out": {"w": (2, 8, 5), "b": (2, 5)}}
    mk = lambda: jax.tree.map(                               # noqa: E731
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jopt = jloop.make_optimizer(jtcfg)
    jstate = jopt.init(jax.tree.map(jnp.asarray, mk()))
    for _ in range(4):
        _, jstate = jopt.update(jax.tree.map(jnp.asarray, mk()), jstate)
    state = loop.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert state.count.dtype == torch.int32 and int(state.count) == 4
    want_mu = torch.bfloat16 if opt_dtype == "bf16" else torch.float32
    assert all(m.dtype == want_mu for m in mlp.tree_leaves(state.mu))
    opt = loop.make_optimizer(tcfg)
    for _ in range(3):
        g = mk()
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate)
        tu, state = opt.update(mlp.tree_map(torch.from_numpy, g), state)
        for t, j in zip(_leaves(tu), _jleaves(ju)):
            assert _rel(t, j) <= 1e-6
        for t, j in zip(_leaves(state.nu), _jleaves(jstate.nu)):
            assert _rel(t, j) <= 1e-6
        for t, j in zip(mlp.tree_leaves(state.mu),
                        jax.tree_util.tree_leaves(jstate.mu)):
            if opt_dtype == "bf16":
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(),
                    np.asarray(j).view(np.int16))
            else:
                assert _rel(t, j) <= 1e-6
    assert int(state.count) == int(jstate.count) == 7


def _data(cfg, packets, seed):
    """A dataset dict in numpy: rx (B, L, R), h (B, C, T, R) complex64,
    P (T, T) float32."""
    rng = np.random.default_rng(seed)
    c = lambda *s: (rng.standard_normal(s)                  # noqa: E731
                    + 1j * rng.standard_normal(s)).astype(np.complex64)
    return {"rx": c(packets, cfg.len_ltf, cfg.num_rx),
            "h": c(packets, cfg.num_carriers, cfg.num_tx, cfg.num_rx),
            "P": np.array(j_pilot(cfg.num_tx), np.float32)}


def test_gather_batch_matches_jax(cfgs):
    cfg, jcfg = cfgs
    data = _data(cfg, 3, seed=7)
    idx = np.random.default_rng(8).integers(
        0, 3 * cfg.num_tx * cfg.num_rx, 40)
    ref = jloop._gather_batch(jcfg, jax.tree.map(jnp.asarray, data),
                              jnp.asarray(idx))
    got = loop._gather_batch(cfg, {k: torch.from_numpy(v)
                                   for k, v in data.items()},
                             torch.from_numpy(idx))
    for t, j in zip(got, ref):
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("matmul_dtype", ["f32", "bf16"])
def test_train_step_multi_matches_jax(cfgs, matmul_dtype):
    """make_train_step's .multi (3 steps from the same idx2), the single
    step, and eval_step and its .multi against JAX's: losses and BN to
    1e-5 relative (1e-4 for bf16 after three steps), the Adam moments to
    -80 dB (-70 dB bf16), Δparams over all parameters to -60 dB (-40 dB
    bf16).

    Δparams is one vector here: a unit whose ReLU is on for every sample
    of a batch, followed by BN, has a layer-0 bias gradient that is zero
    but for rounding (about 1e-8), and Adam scales such noise to a
    sizeable step in either package, so that bias leaf alone can be as
    far as -46 dB after three steps."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(matmul_dtype=matmul_dtype)
    jp, jb = _model(jcfg, jtcfg, seed=9)
    data = _data(cfg, 4, seed=10)
    idx2 = np.random.default_rng(11).integers(
        0, 4 * cfg.num_tx * cfg.num_rx, (3, BS))
    jdata = jax.tree.map(jnp.asarray, data)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    jopt = jloop.make_optimizer(jtcfg)
    jtrain, jeval = jloop.make_train_step(jcfg, jtcfg, jdata, 1.0, jopt)
    opt = loop.make_optimizer(tcfg)
    ttrain, teval = loop.make_train_step(cfg, tcfg, tdata, 1.0, opt)
    tp, tb = mlp.params_from_jax(jp, jb)
    tstate = opt.init(tp)
    jargs = (jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jb),
             jopt.init(jp))

    # eval before training
    ref_e = np.asarray(jeval.multi(jargs[0], jargs[1], jnp.asarray(idx2)))
    got_e = teval.multi(tp, tb, torch.from_numpy(idx2))
    assert _rel(got_e, ref_e) <= 1e-5
    assert _rel(teval(tp, tb, torch.from_numpy(idx2[0])),
                np.asarray(jeval(jargs[0], jargs[1],
                                 jnp.asarray(idx2[0])))) <= 1e-5

    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref = jax.tree.map(np.asarray, jtrain.multi(
        *jargs, jnp.asarray(idx2), keys, jtcfg.lr))
    got = ttrain.multi(tp, tb, tstate, torch.from_numpy(idx2),
                       torch.Generator().manual_seed(0), tcfg.lr)
    bf16 = matmul_dtype == "bf16"
    _assert_step_close(got, ref, jp, -40.0 if bf16 else -60.0,
                       1e-4 if bf16 else 1e-5,
                       moment_db=-70.0 if bf16 else -80.0, per_leaf=False)
    assert int(got[2].count) == 3
    stat = 1e-4 if bf16 else 1e-5

    # one more single step from both carried states
    jp3 = jax.tree.map(jnp.asarray, ref[0])
    jb3 = jax.tree.map(jnp.asarray, ref[1])
    js3 = jax.tree.map(jnp.asarray, ref[2])
    ref1 = jax.tree.map(np.asarray, jtrain(
        jp3, jb3, js3, jnp.asarray(idx2[1]), keys[0], jtcfg.lr))
    got1 = ttrain(*got[:3], torch.from_numpy(idx2[1]),
                  torch.Generator().manual_seed(0), tcfg.lr)
    assert _rel(got1[3], ref1[3]) <= stat
    assert int(got1[2].count) == 4


def test_training_forward_matches_jax(cfgs):
    """stacked_apply(train=True) with dropout 0: outputs and the new BN
    statistics (biased batch variance, Keras momentum) to 1e-5 relative;
    gradients of the summed MSE by autograd against jax.grad to -80 dB."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs()
    jp, jb = _model(jcfg, jtcfg, seed=12)
    x2, pilot, y2 = _batch(cfg, BS, seed=13)
    pil2 = np.stack([pilot, pilot])
    jx = jmlp.preprocess_input(jcfg, jtcfg, jnp.asarray(x2),
                               jnp.asarray(pil2))

    def jloss(p):
        pred, nb = jmlp.stacked_apply(jtcfg, p, jb, jx, train=True,
                                      rng=jax.random.PRNGKey(0))
        return jnp.sum(jnp.mean((pred - y2) ** 2, axis=(1, 2))), (pred, nb)

    (_, (jpred, jnb)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tp, tb = mlp.params_from_jax(jp, jb)
    live = mlp.tree_map(lambda t: t.requires_grad_(), tp)
    tx = mlp.preprocess_input(cfg, tcfg, torch.from_numpy(x2),
                              torch.from_numpy(pil2))
    pred, nb = mlp.stacked_apply(tcfg, live, tb, tx, train=True)
    loss = ((pred - torch.from_numpy(y2)) ** 2).mean(dim=(1, 2)).sum()
    grads = torch.autograd.grad(loss, mlp.tree_leaves(live))
    assert _rel(pred, jpred) <= 1e-5
    for t, j in zip(_leaves(nb), _jleaves(jnb)):
        assert _rel(t, j) <= 1e-5
    for t, j in zip(grads, _jleaves(jg)):
        assert _nmse_db(t, j) <= -80.0


def test_bf16_dense_backward_rounding_points():
    """Bf16Dense's forward and its dx, dw against jax.grad of JAX's bf16
    product (float32 result; cotangents rounded to bf16 at the operands):
    forward to 1e-6 relative, dx and dw to -80 dB, and bf16-valued."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.standard_normal((2, 40, 16)).astype(np.float32)
    c = rng.standard_normal((2, 24, 16)).astype(np.float32)

    def jf(x, w):
        y = jnp.matmul(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * c), y

    (_, jy), (jdx, jdw) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(x, w)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = mlp.Bf16Dense.apply(tx, tw)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(c)).sum(), (tx, tw))
    assert y.dtype == torch.float32 and _rel(y, jy) <= 1e-6
    for t, j in ((dx, jdx), (dw, jdw)):
        assert t.dtype == torch.float32
        assert torch.equal(t, t.to(torch.bfloat16).float())
        assert _nmse_db(t, j) <= -80.0


@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "nobn"])
def test_matmul_dtype_bf16_inference_matches_jax(cfgs, use_bn):
    """matmul_dtype='bf16' in eval mode: stacked_apply(train=False) and
    predict_complex round both operands to bf16 with a float32 result, as
    JAX does, to -100 dB NMSE (a port that ignores the option is about
    -48 dB away)."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(matmul_dtype="bf16", use_bn=use_bn)
    jp, jb = _model(jcfg, jtcfg, seed=15)
    tp, tb = mlp.params_from_jax(jp, jb)
    rng = np.random.default_rng(16)
    sig = (rng.standard_normal((32, cfg.len_ltf))
           + 1j * rng.standard_normal((32, cfg.len_ltf))).astype(np.complex64)
    pilot = np.asarray(j_pilot(cfg.num_tx))[
        :, rng.integers(0, cfg.num_tx, 32)].T.copy()
    ref = jmlp.predict_complex(jcfg, jtcfg, jp, jb, jnp.asarray(sig),
                               jnp.asarray(pilot))
    got = mlp.predict_complex(cfg, tcfg, tp, tb, torch.from_numpy(sig),
                              torch.from_numpy(pilot))
    ref, got = np.asarray(ref), got.numpy()
    err = np.sum(np.abs(got - ref) ** 2) / np.sum(np.abs(ref) ** 2)
    assert 10 * np.log10(err) <= -100.0
    x2 = np.stack([np.concatenate([sig.real, pilot], -1),
                   np.concatenate([sig.imag, pilot], -1)]).astype(np.float32)
    jy, jnb = jmlp.stacked_apply(jtcfg, jp, jb, jnp.asarray(x2))
    ty, tnb = mlp.stacked_apply(tcfg, tp, tb, torch.from_numpy(x2))
    assert _nmse_db(ty, jy) <= -100.0
    assert tnb is tb


def test_dropout_keep_rate_and_not_after_the_last_layer():
    """Identity layers on positive inputs expose the dropout mask: after
    the first hidden layer each value is kept (scaled by 1/keep) at the
    keep rate, within 5 binomial standard deviations; a single hidden
    layer (the last) is never dropped. The masks come from the generator
    passed, and a seed repeats them."""
    n, rows, p = 256, 64, 0.15
    tcfg = TrainConfig(hidden=(n, n), use_bn=False, dropout=p)
    eye = torch.eye(n)
    layer = lambda: {"w": eye.clone(), "b": torch.zeros(n)}  # noqa: E731
    params = {"dense": [layer(), layer()], "out": layer(), "bn": []}
    x = torch.rand((rows, n), generator=torch.Generator().manual_seed(0)) \
        + 0.5
    y, _ = mlp.csi_mlp_apply(tcfg, params, {"mean": [], "var": []}, x,
                             train=True, gen=torch.Generator().manual_seed(1))
    keep = 1 - p
    kept = y != 0
    assert torch.allclose(y[kept], (x / keep)[kept], rtol=1e-6, atol=0)
    frac = float(kept.float().mean())
    sd = np.sqrt(keep * p / kept.numel())
    assert abs(frac - keep) <= 5 * sd
    y2, _ = mlp.csi_mlp_apply(tcfg, params, {"mean": [], "var": []}, x,
                              train=True,
                              gen=torch.Generator().manual_seed(1))
    assert torch.equal(y, y2)
    one = {"dense": [layer()], "out": layer(), "bn": []}
    y1, _ = mlp.csi_mlp_apply(TrainConfig(hidden=(n,), use_bn=False,
                                          dropout=p), one,
                              {"mean": [], "var": []}, x, train=True,
                              gen=torch.Generator().manual_seed(1))
    assert torch.equal(y1, x)


def test_rbg_clt_moments_and_bound():
    """rbg_clt: the Irwin-Hall(4) byte sum, (s − 510)/147.80054 — mean 0
    and variance 1 within 5 standard errors over 2^20 draws, excess
    kurtosis −0.3 ± 0.02, every value within ±3.4506 and on the lattice
    of the byte sums; the SNR indices lie in [0, 6)."""
    tcfg = TrainConfig(awgn_rng="rbg_clt")
    idx, x = loop.draw_awgn(tcfg, 6, (2, 512, 1024),
                            torch.Generator().manual_seed(0))
    assert idx.shape == (2,) and bool(((idx >= 0) & (idx < 6)).all())
    assert x.shape == (2, 512, 1024) and x.dtype == torch.float32
    v = x.double().flatten()
    n = v.numel()
    assert abs(float(v.mean())) <= 5 / np.sqrt(n)
    var = float(v.var())
    assert abs(var - 1.0) <= 5 * np.sqrt(2.0 / n)
    kurt = float(((v - v.mean()) ** 4).mean()) / var ** 2 - 3.0
    assert abs(kurt + 0.3) <= 0.02
    assert float(v.abs().max()) <= 3.4506
    s = v * 147.80054 + 510.0
    assert float((s - s.round()).abs().max()) <= 1e-3
    # the other draws are torch.randn
    _, z = loop.draw_awgn(TrainConfig(awgn_rng="rbg"), 6, (4096,),
                          torch.Generator().manual_seed(0))
    assert torch.equal(z, torch.randn(
        4096, generator=_advanced(torch.Generator().manual_seed(0))))


def _advanced(g):
    """g after the two SNR-index draws of draw_awgn."""
    torch.randint(6, (2,), generator=g)
    return g


@pytest.mark.parametrize("opt_dtype", ["f32", "bf16"])
def test_opt_state_checkpoint_jax_to_port(cfgs, tmp_path, opt_dtype):
    """A JAX checkpoint with its _opt.npz loads in the port, leaf for
    leaf (a bf16 first moment bit for bit)."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(opt_dtype=opt_dtype)
    jp, jb = _model(jcfg, jtcfg, seed=17)
    jopt = jloop.make_optimizer(jtcfg)
    js = jopt.init(jax.tree.map(jnp.asarray, jp))
    _, js = jopt.update(jax.tree.map(jnp.asarray, jp), js)
    prefix = str(tmp_path / "last")
    jckpt.save_checkpoint(prefix, jcfg, jtcfg, jp, jb, opt_state=js)
    tp, _ = mlp.params_from_jax(jp, jb)
    like = loop.make_optimizer(tcfg).init(tp)
    ck = ckpt.load_checkpoint(prefix, like_opt_state=like)
    state = loop.opt_state_from_jax(ck["opt_state"])
    assert isinstance(state, loop.AdamState) and int(state.count) == 1
    _assert_same_state(state, js)


@pytest.mark.parametrize("opt_dtype", ["f32", "bf16"])
def test_opt_state_checkpoint_port_to_jax(cfgs, tmp_path, opt_dtype):
    """The port's checkpoint with its optimizer state loads in the JAX
    package into optax's state structure, leaf for leaf; has_opt is set."""
    cfg, jcfg = cfgs
    tcfg, jtcfg = _tcfgs(opt_dtype=opt_dtype)
    jp, jb = _model(jcfg, jtcfg, seed=18)
    tp, tb = mlp.params_from_jax(jp, jb)
    opt = loop.make_optimizer(tcfg)
    _, state = opt.update(tp, opt.init(tp))
    prefix = str(tmp_path / "last")
    ckpt.save_checkpoint(prefix, cfg, tcfg, tp, tb, opt_state=state)
    jopt = jloop.make_optimizer(jtcfg)
    ck = jckpt.load_checkpoint(prefix, like_opt_state=jopt.init(jp))
    assert type(ck["opt_state"]).__name__ == "ScaleByAdamState"
    _assert_same_state(state, ck["opt_state"])
    assert ckpt.load_checkpoint(prefix)["params"] is not None
    with open(prefix + ".json") as f:
        assert json.load(f)["has_opt"] is True


def _assert_same_state(state, js):
    assert int(state.count) == int(np.asarray(js.count))
    for t, j in zip(mlp.tree_leaves(state.mu) + mlp.tree_leaves(state.nu),
                    jax.tree_util.tree_leaves(js.mu)
                    + jax.tree_util.tree_leaves(js.nu)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_run_train_bench_on_the_cpu(monkeypatch, capsys):
    """run_train_bench(device="cpu") at Nt 8, Nr 2, hidden (64, 64): one
    JSON line with every default variant, the JAX line's keys, and the
    JAX bench's FLOP count. CPU times are host times."""
    monkeypatch.setenv("BENCH_NT", "8")
    monkeypatch.setenv("BENCH_NR", "2")
    monkeypatch.delenv("BENCH_TRAIN_VARIANTS", raising=False)
    monkeypatch.delenv("BENCH_TRAIN_BATCHES", raising=False)
    out = bench.run_train_bench(batch_sizes=(8, 16), steps_per_call=2,
                                calls=1, num_packets=2, hidden=HIDDEN,
                                device="cpu")
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == out
    assert out["metric"] == "train_step_tflops" and out["unit"] == "TFLOP/s"
    assert out["extra"]["device"] == "cpu"
    assert out["extra"]["steps_per_call"] == 2
    paths = out["extra"]["paths"]
    assert set(paths) == {f"{v}_bs{b}" for v in ("f32", "bf16", "f32_rbg")
                          for b in (8, 16)}
    for name, r in paths.items():
        assert set(r) == {"step_ms", "steps_per_s", "samples_per_s",
                          "achieved_tflops"}
        assert r["step_ms"] > 0 and np.isfinite(r["achieved_tflops"])
        bs = int(name.rsplit("_bs", 1)[1])
        assert r["samples_per_s"] == pytest.approx(bs * r["steps_per_s"])
    assert out["value"] == max(r["achieved_tflops"] for r in paths.values())
    cfg = SimConfig(num_tx=8, num_rx=2)
    in_dim = cfg.len_ltf + 8
    assert bench.train_flops(cfg, TrainConfig(hidden=HIDDEN, batch_size=16)) \
        == 3 * 2 * 2 * 16 * (in_dim * 64 + 64 * 64 + 64 * 234)


@pytest.mark.parametrize("name,want", [
    ("f32", ("f32", "threefry", "default_snr", "f32")),
    ("bf16", ("bf16", "threefry", "default_snr", "f32")),
    ("f32_rbg", ("f32", "rbg", "default_snr", "f32")),
    ("bf16_rbgclt_mubf16", ("bf16", "rbg_clt", "default_snr", "bf16")),
    ("f32_noawgn", ("f32", "threefry", "default", "f32"))])
def test_train_variant_grammar(name, want):
    t = bench.train_variant_config(name, 256, 16)
    assert (t.matmul_dtype, t.awgn_rng, t.method, t.opt_dtype) == want
    assert (t.batch_size, t.steps_per_call, t.hidden) == (256, 16,
                                                          (1024, 1024))


def test_bs32_train_flops():
    """BS32: 36.27 GFLOP a step at bs 256 and 145.08 at bs 1024."""
    cfg = SimConfig()
    for bs, gflop in ((256, 36.27), (1024, 145.08)):
        f = bench.train_flops(cfg, TrainConfig(batch_size=bs))
        assert f / 1e9 == pytest.approx(gflop, abs=0.005)


def test_run_train_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.run_train_bench(batch_sizes=(8,), steps_per_call=1, calls=1,
                              print_result=False)

