"""The port's per-pair estimation step (mamimo_tpu_torch.bench::
make_estimation_fn, the bench path ``pallas_full`` and its other
branches) against the JAX package's make_estimation_fn on the CPU.

The same flat float32 planes, made with numpy, go through both. With
use_pallas the JAX step runs its kernels in interpret mode, with bf16
products in mlp_infer_pallas, and the port's CPU path rounds the same
operands: h_ls is held at a relative 2e-4 (float32 on both sides, the
JAX package's bound for the per-pair LS) and h_dnn at a relative 1e-2
(bf16 operands on both sides, differing only where a sum's order flips a
rounding). The float32 branch is held at 2e-4 on both halves; the bf16
factored branch's DNN at ≤ −40 dB (its bf16 operands are rounded at
other places than XLA's bf16 matmuls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu import bench as jbench
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu_torch.bench import (
    ESTIMATION_PATHS,
    _planes_to_time_major,
    make_estimation_fn,
)
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp

PACKETS = 3


@pytest.fixture(scope="module")
def case(small_cfg, tcfg):
    """A model with non-trivial BN statistics and the flat planes of
    PACKETS packets."""
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(11), small_cfg, tcfg))
    rng = np.random.default_rng(11)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    cfg = SimConfig(num_tx=small_cfg.num_tx, num_rx=small_cfg.num_rx,
                    n_scatterers=small_cfg.n_scatterers,
                    n_rays=small_cfg.n_rays)
    planes = f32(rng.standard_normal(
        (2, PACKETS * cfg.num_rx, cfg.len_ltf)))
    return (cfg, TrainConfig(hidden=tuple(tcfg.hidden)), small_cfg, tcfg,
            (jp, jb), mlp.params_from_jax(jp, jb), planes)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _db(got, ref):
    return 20 * np.log10(_rel(got, ref))


def test_planes_to_time_major_matches_jax(case):
    cfg, _, _, _, _, _, planes = case
    got = _planes_to_time_major(torch.from_numpy(planes), cfg.num_rx)
    ref = jbench._planes_to_time_major(jnp.asarray(planes), cfg.num_rx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("branch,opts,tol", [
    ("pallas_full", ESTIMATION_PATHS["pallas_full"], (2e-4, 1e-2)),
    ("float32", {"from_planes": True}, (2e-4, 2e-4)),
    ("bf16_factored", {"from_planes": True, "use_bf16": True}, (2e-4, None)),
])
def test_estimation_fn_matches_jax(case, branch, opts, tol):
    cfg, tcfg, jcfg, jtcfg, (jp, jb), (tp, tb), planes = case
    h_ls, h_dnn = make_estimation_fn(cfg, tcfg, tp, tb, **opts)(
        torch.from_numpy(planes))
    r_ls, r_dnn = jbench.make_estimation_fn(jcfg, jtcfg, jp, jb, **opts)(
        jnp.asarray(planes))
    shape = (PACKETS, cfg.num_carriers, cfg.num_tx, cfg.num_rx)
    for h in (h_ls, h_dnn):
        assert h.dtype == torch.complex64 and tuple(h.shape) == shape
    assert _rel(h_ls.numpy(), r_ls) < tol[0]
    if tol[1] is None:
        assert _db(h_dnn.numpy(), r_dnn) <= -40.0
    else:
        assert _rel(h_dnn.numpy(), r_dnn) < tol[1]


def test_time_major_input(case):
    """Without from_planes the step takes the time-major complex form of
    the same planes and gives the same answer."""
    cfg, tcfg, _, _, _, (tp, tb), planes = case
    fn = make_estimation_fn(cfg, tcfg, tp, tb, use_pallas=True)
    rx = _planes_to_time_major(torch.from_numpy(planes), cfg.num_rx)
    got = fn(rx.contiguous())
    want = make_estimation_fn(cfg, tcfg, tp, tb,
                              **ESTIMATION_PATHS["pallas_full"])(
        torch.from_numpy(planes))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("branch", ["pallas_full", "float32"])
def test_input_on_another_device_refused(case, branch):
    """Planes on another device than the parameters raise ValueError
    before any work (here CPU parameters and planes on the meta device)."""
    cfg, tcfg, _, _, _, (tp, tb), planes = case
    opts = {"from_planes": True, "use_pallas": branch == "pallas_full"}
    fn = make_estimation_fn(cfg, tcfg, tp, tb, **opts)
    with pytest.raises(ValueError, match="rx is on meta"):
        fn(torch.from_numpy(planes).to("meta"))
