"""The port's bf16-input planes estimation paths
(mamimo_tpu_torch.bench::make_estimation_fn_planes) against the JAX
package's building blocks of the same paths, on the CPU.

Each of the four bench paths runs once on bf16 planes made with numpy;
the same bf16 values go to the JAX blocks as float32. The LS half is
held at atol 2e-4 (plus one bf16 rounding step for the bf16 serving
output); the bf16 DNN half at ≤ −40 dB against the float32 factored DNN
(bf16 operands cost about −48 dB); the int8 DNN half at ≤ −50 dB against
JAX's int8 path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.models import quant as jquant
from mamimo_tpu.ops.estimate import ls_estimate_planes as j_ls
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_planes_pallas as j_ls_planes_pallas,
)
from mamimo_tpu_torch.bench import PATHS, make_estimation_fn_planes
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp

CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
TCFG = TrainConfig(hidden=(128, 128))
JTCFG = JTrainConfig(hidden=(128, 128))
S = 10


def nmse_db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                         / np.sum(np.abs(ref) ** 2))


@pytest.fixture(scope="module")
def case():
    """One model with a non-trivial BN state, bf16 planes, and the JAX
    blocks' answers on the same values."""
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(7), JCFG, JTCFG))
    rng = np.random.default_rng(7)
    jb = {"mean": [rng.normal(0, 0.1, m.shape).astype(np.float32)
                   for m in jb["mean"]],
          "var": [rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                  for v in jb["var"]]}
    x16 = torch.from_numpy(rng.standard_normal((2, S, CFG.len_ltf)
                                               ).astype(np.float32)
                           ).to(torch.bfloat16)
    x = jnp.asarray(x16.float().numpy())
    jq = jquant.quantize_params_int8(JTCFG, jp, jb, sig_len=CFG.len_ltf)
    ref = {
        "ls": np.asarray(j_ls(JCFG, x)),
        "ls_raw_bf16": j_ls_planes_pallas(JCFG, x, raw=True,
                                          out_dtype=jnp.bfloat16),
        "dnn_f32": np.asarray(jmlp.predict_all_pairs_planes_flat(
            JCFG, JTCFG, jp, jb, x)),
        "dnn_int8": np.asarray(jquant.predict_all_pairs_planes_flat_int8(
            JCFG, JTCFG, jq, x)),
    }
    return mlp.params_from_jax(jp, jb), x16, ref


@pytest.mark.parametrize("name", list(PATHS))
def test_planes_paths_match_jax_blocks(case, name):
    (tp, tb), x16, ref = case
    opts = PATHS[name]
    fn = make_estimation_fn_planes(CFG, TCFG, tp, tb, input_bf16=True, **opts)
    h_ls, h_dnn = fn(x16)
    shape = (S, CFG.num_tx, CFG.num_carriers)
    if opts.get("serving_planes"):
        for got, want in zip(h_ls, ref["ls_raw_bf16"]):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == tuple(want.shape) == (16 * 8, 256)
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                rtol=2.0 ** -7, atol=2e-4)
        assert h_dnn.dtype == torch.bfloat16
        assert tuple(h_dnn.shape) == (2,) + shape
        h_dnn = torch.complex(h_dnn[0].float(), h_dnn[1].float())
    else:
        assert h_ls.dtype == torch.complex64 and tuple(h_ls.shape) == shape
        np.testing.assert_allclose(h_ls.numpy(), ref["ls"], rtol=0,
                                   atol=2e-4)
    assert tuple(h_dnn.shape) == shape
    if opts.get("dnn_int8"):
        assert nmse_db(h_dnn.numpy(), ref["dnn_int8"]) <= -50.0
    else:
        assert nmse_db(h_dnn.numpy(), ref["dnn_f32"]) <= -40.0


def test_planes_paths_refuse_float32(case):
    """Only the bf16-input paths are ported, and they take bf16 planes."""
    (tp, tb), x16, _ = case
    with pytest.raises(ValueError, match="bf16-input"):
        make_estimation_fn_planes(CFG, TCFG, tp, tb, ls_pallas=True)
    fn = make_estimation_fn_planes(CFG, TCFG, tp, tb, input_bf16=True,
                                   dnn_int8=True)
    with pytest.raises(TypeError, match="bfloat16"):
        fn(x16.float())
