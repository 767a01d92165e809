"""Serving every model the port trains, on the CPU against the JAX
package: the factored DNN at 1 and 3 hidden layers and above 1024 hidden
units (``prepare_factored_weights`` and the plain versions of kernel 2's
chain, routed by depth in ``fused_factored_planes``), and kernel 1 at 256
Tx antennas (its Σh² tiling of two tiles a sample), each through both
packages' ``CSIPredictor.estimate_full`` on one checkpoint written by
JAX (so ``params_from_jax`` carries every depth and width).

Inputs are made with numpy and go to both packages. Tolerances (ROADMAP
ground rules):

- the bf16 DNN (bf16 weights and planes) against JAX's
  ``_factored_all_pairs(dtype=bfloat16)``: ≤ −40 dB NMSE, as the depth-2
  test of ``test_torch_bench_serving.py``: the two round at other places
  (the port's plain versions round each product's operands to bf16 and
  add in float32, JAX rounds after every bias and affine; bf16 operands
  alone cost about −48 dB);
- float32 serving (``estimate_full`` on the CPU): 1e-4 of the largest
  value, as ``test_torch_predictor.py``;
- kernel 1's bf16 store at Nt 256: ≤ −45 dB against JAX's kernel in
  interpret mode; its sums: each row within 1e-3 relative of the sums of
  JAX's float32 estimate over the same 128 rows, and the total within
  1e-3 of JAX's sums / 8; the float32 store 2e-4 of the largest value.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamimo_tpu.config import SimConfig as JSimConfig
from mamimo_tpu.config import TrainConfig as JTrainConfig
from mamimo_tpu.models import mlp as jmlp
from mamimo_tpu.models.predictor import CSIPredictor as JPredictor
from mamimo_tpu.ops.pallas.fused_ls import (
    ls_planes_pallas_v2 as j_ls_v2,
    ls_v2_to_complex as j_v2_to_complex,
)
from mamimo_tpu.train import ckpt as jckpt
from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models import mlp
from mamimo_tpu_torch.models.predictor import CSIPredictor
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels import fused_factored as ff
from mamimo_tpu_torch.ops.kernels import fused_ls
from mamimo_tpu_torch.ops.kernels import mlp_infer as mi
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_planes_v2,
    ls_sm90_constants,
    ls_v2_tiles,
)

BF16 = torch.bfloat16
CFG = SimConfig(num_tx=8, num_rx=2)
JCFG = JSimConfig(num_tx=8, num_rx=2)
CFG256 = SimConfig(num_tx=256, num_rx=4)
JCFG256 = JSimConfig(num_tx=256, num_rx=4)
# depth 1, depth 3 (widths padded apart to 128, 128, 128), and a first
# layer above 1024 units with a second of another width
HIDDEN = [(96,), (64, 96, 80), (1152, 640)]


def _db(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    with np.errstate(divide="ignore"):          # an exact match is -inf
        return 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                             / np.sum(np.abs(ref) ** 2))


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _jax_model(jcfg, hidden, seed):
    """JAX parameters with non-trivial biases and BN state."""
    jtcfg = JTrainConfig(hidden=hidden)
    jp, jb = jax.tree.map(np.asarray, jmlp.init_stacked(
        jax.random.PRNGKey(seed), jcfg, jtcfg))
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    jb = {"mean": [f32(rng.normal(0, 0.1, m.shape)) for m in jb["mean"]],
          "var": [f32(rng.uniform(0.5, 2.0, v.shape)) for v in jb["var"]]}
    jp["bn"] = [{"scale": f32(rng.uniform(0.5, 1.5, l["scale"].shape)),
                 "bias": f32(rng.normal(0, 0.1, l["bias"].shape))}
                for l in jp["bn"]]
    jp["dense"] = [{"w": l["w"], "b": f32(rng.normal(0, 0.05, l["b"].shape))}
                   for l in jp["dense"]]
    return jtcfg, jp, jb


def _planes(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, cfg.len_ltf)).astype(np.float32)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_kernel2_plain_chain_matches_jax_bf16(hidden):
    """Nt 8, S = 8: the prepared bf16 weights (each layer padded to its
    own multiple of 128) through the plain versions of kernel 2's chain,
    which ``fused_factored_planes`` routes by depth, against JAX's bf16
    factored all-pairs; each wrapper of the chain composes to the same."""
    jtcfg, jp, jb = _jax_model(JCFG, hidden, seed=len(hidden))
    tcfg = TrainConfig(hidden=hidden)
    tp, tb = mlp.params_from_jax(jp, jb)
    prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
    d = len(hidden)
    assert ff.factored_depth(prep) == d
    widths = [-(-h // 128) * 128 for h in hidden]
    assert tuple(prep["w1"].shape) == (2, CFG.len_ltf, widths[0])
    for k in range(2, d + 1):
        assert tuple(prep[f"w{k}"].shape) == (2, widths[k - 2],
                                              widths[k - 1])
        assert torch.equal(prep[f"w{k}t"], prep[f"w{k}"].transpose(1, 2))
    assert tuple(prep[f"w{d + 1}t"].shape) == (2, 256, widths[-1])

    x = _planes(CFG, 8, seed=11)
    xb = torch.from_numpy(x).to(BF16)
    ref = np.asarray(jmlp._factored_all_pairs(
        JCFG, jtcfg, jp, jb, jnp.asarray(x).astype(jnp.bfloat16),
        dtype=jnp.bfloat16).astype(jnp.float32))
    got = ff.fused_factored_planes(CFG, tcfg, prep, xb)
    assert got.dtype == torch.float32
    assert _db(got.numpy(), ref) <= -40.0
    # the float32 model (what the bf16 rounding is measured against)
    f32 = mlp._factored_all_pairs(CFG, tcfg, tp, tb, torch.from_numpy(x))
    assert _db(got.numpy(), f32.numpy()) <= -40.0
    # the chain, wrapper by wrapper, is the one plain tail
    sp = ff.factored_sig_proj(xb, prep["w1"])
    tail = ff._tail_plain(prep, sp, CFG.num_carriers)
    np.testing.assert_allclose(got.numpy(), tail.numpy(), rtol=0,
                               atol=1e-5 * float(tail.abs().max()))
    if d == 2 and widths[0] <= 1024:
        return
    h = ff.factored_heads(prep, sp)
    assert h.dtype == BF16 and tuple(h.shape) == (2, 8 * 8, widths[0])
    for k in range(2, d):
        h = ff.factored_dense(prep, k, h)
        assert h.dtype == BF16 and h.shape[-1] == widths[k - 1]
    y = ff.factored_dense(prep, 2, h, CFG.num_carriers) if d == 1 \
        else ff.factored_rows_tail(prep, h, CFG.num_carriers)
    assert torch.equal(y.reshape(got.shape), got)


class _Launch(Exception):
    """Raised by the stub library: the call got past every check."""


def _stub():
    raise _Launch


def test_kernel2_cuda_branches_take_every_depth(monkeypatch):
    """The CUDA branches' checks (shown without a card: the device test
    answers CUDA and the library raises at first use) take the depth-1,
    depth-3 and 1152-unit trees on the routed kernels, and refuse what a
    kernel does not serve, naming the limit: the fused tail takes 2
    hidden layers of at most 1024 units in the first, the tails at most
    256 output columns, rows of the layer's own width."""
    monkeypatch.setattr(ff, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ff, "_ff_lib", _stub)
    C = CFG.num_carriers
    for hidden in HIDDEN:
        d = len(hidden)
        tcfg = TrainConfig(hidden=hidden)
        tp, tb = mlp.init_stacked(torch.Generator().manual_seed(1), CFG,
                                  tcfg)
        prep = ff.prepare_factored_weights(CFG, tcfg, tp, tb)
        h1 = prep["w1"].shape[2]
        sp = torch.zeros((2, 3, h1))
        rows = torch.zeros((2, 3 * CFG.num_tx, h1), dtype=BF16)
        with pytest.raises(_Launch):
            ff.factored_heads(prep, sp)
        if d == 1:
            with pytest.raises(_Launch):
                ff.factored_dense(prep, 2, rows, C)
            with pytest.raises(ValueError, match="2 or more hidden layers"):
                ff.factored_rows_tail(prep, rows, C)
        else:
            if d > 2:
                with pytest.raises(_Launch):
                    ff.factored_dense(prep, 2, rows)
                rows = rows[:, :, :prep[f"w{d}"].shape[1]]
            with pytest.raises(_Launch):
                ff.factored_rows_tail(prep, rows, C)
            with pytest.raises(ValueError, match="C <= 256"):
                ff.factored_rows_tail(prep, rows, 300)
            wide = torch.cat([rows, rows], -1)
            with pytest.raises(ValueError, match=f"rows of {rows.shape[2]}"):
                ff.factored_rows_tail(prep, wide, C)
        match = "H1 <= 1024" if d == 2 else "2 hidden layers, got"
        with pytest.raises(ValueError, match=match):
            ff.factored_tail(prep, sp, C)
    with pytest.raises(ValueError, match="at least 1 hidden layer"):
        ff.prepare_factored_weights(CFG, TrainConfig(hidden=()), {}, {})


class _FakeLib:
    """Stands in for a built library: records each launch function's
    ctypes signature."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def _c_arity(src, fn):
    """The number of parameters of launch function ``fn`` in
    ``csrc/<src>.cu``."""
    text = (Path(ff.__file__).resolve().parents[2] / "csrc" /
            f"{src}.cu").read_text()
    m = re.search(rf"int {fn}\(([^)]*)\)", text)
    assert m, fn
    return len(m.group(1).split(","))


def test_launch_bindings_match_the_c_signatures(monkeypatch):
    """Each wrapper's ctypes binding gives its launch function as many
    arguments as the C source declares (a missing one is a TypeError
    only on the card)."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda name, defines=(): fake)
    ff._ff_lib()
    fused_ls._ls_lib()
    fused_ls._ls_v1_lib()
    fused_ls._ls_pair_lib()
    fused_ls._ls_parts_lib()
    mi._mlp_lib()
    for src, fns in (("fused_factored", (
            "factored_sig_proj_launch", "factored_tail_launch",
            "factored_heads_launch", "factored_dense_launch",
            "factored_rows_tail_launch")),
            ("ls_v2", ("ls_planes_v2_launch",)),
            ("ls_v1", ("ls_planes_v1_launch",)),
            ("ls_pair", ("ls_pair_launch",)),
            ("ls_parts", ("ls_parts_launch",)),
            ("mlp_infer", ("mlp_layer1_launch", "mlp_tail_launch"))):
        for fn in fns:
            assert len(getattr(fake, fn).argtypes) == _c_arity(src, fn), fn


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One JAX-written checkpoint per model, served by both packages on
    the CPU: the three widths at Nt 8 and hidden (64, 64) at Nt 256."""
    out = {}
    for key, jcfg, hidden in [(h, JCFG, h) for h in HIDDEN] \
            + [("nt256", JCFG256, (64, 64))]:
        d = tmp_path_factory.mktemp("model")
        jtcfg, jp, jb = _jax_model(jcfg, hidden, seed=5)
        jckpt.save_checkpoint(str(d / "best"), jcfg, jtcfg, jp, jb)
        out[key] = (JPredictor(str(d)), CSIPredictor(str(d), device="cpu"))
    return out


@pytest.mark.parametrize("key", HIDDEN + ["nt256"])
def test_estimate_full_matches_jax(models, key):
    """The serving call of a model of each depth and width, and at Nt 256,
    from one checkpoint written by JAX: both estimates within float32
    (the loaded weights equal JAX's leaf for leaf)."""
    jpred, pred = models[key]
    for a, b in zip(mlp.tree_leaves(pred.params),
                    jax.tree_util.tree_leaves(jpred.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = CFG256 if key == "nt256" else CFG
    s = cfg.num_rx                                    # one packet
    flat = _planes(cfg, s, seed=9)
    ref = jpred.estimate_full(flat)
    got = pred.estimate_full(flat)
    for g, r in zip(got, ref):
        assert g.shape == (s, cfg.num_tx, cfg.num_carriers)
        _close(g, r, 1e-4)


@pytest.fixture(scope="module")
def nt256_ls():
    """One packet at Nt 256 (S = 4): JAX's v2 kernel in interpret mode
    with the float32 store, and with the bf16 store and its sums."""
    x = _planes(CFG256, CFG256.num_rx, seed=21)
    jx = jnp.asarray(x)
    s = x.shape[1]
    h32, _ = j_ls_v2(JCFG256, jx, block_samples=1, interpret=True)
    h16, ssq = j_ls_v2(JCFG256, jx, block_samples=1, interpret=True,
                       with_ssq=True, out_dtype=jnp.bfloat16)
    dense = lambda h: np.asarray(j_v2_to_complex(            # noqa: E731
        JCFG256, h.astype(jnp.float32), s))
    return x, dense(h32), dense(h16), np.asarray(ssq)


def test_kernel1_plain_at_nt256_matches_jax(nt256_ls):
    """Kernel 1's plain version at Nt 256: the float32 store, the bf16
    store, and the sums of h² of two tiles a sample (rows 0..127 and
    128..255 of each sample), against JAX's kernel."""
    x, ref32, ref16, ref_ssq = nt256_ls
    cfg = CFG256
    s, nt, C = x.shape[1], cfg.num_tx, cfg.num_carriers
    h = ls_planes_v2(cfg, torch.from_numpy(x))
    assert tuple(h.shape) == (2, s, nt, C) and h.dtype == torch.float32
    got32 = h[0].numpy() + 1j * h[1].numpy()
    _close(got32, ref32, 2e-4)
    h16, ssq = ls_planes_v2(cfg, torch.from_numpy(x), out_dtype=BF16,
                            with_ssq=True)
    assert h16.dtype == BF16
    got16 = h16[0].float().numpy() + 1j * h16[1].float().numpy()
    assert _db(got16, ref16) <= -45.0
    assert ls_v2_tiles(s, nt) == 2 * s
    assert tuple(ssq.shape) == (2 * s, 2, C)
    halves = ref32.reshape(s, 2, 128, C)                 # (s, part, row, C)
    want = np.stack([(halves.real ** 2).sum(2), (halves.imag ** 2).sum(2)],
                    axis=2).reshape(2 * s, 2, C)
    np.testing.assert_allclose(ssq.numpy(), want, rtol=1e-3)
    np.testing.assert_allclose(float(ssq.double().sum()),
                               float(ref_ssq.astype(np.float64).sum()) / 8.0,
                               rtol=1e-3)


def test_kernel1_cuda_branch_takes_nt256(monkeypatch):
    """The LS kernels' shape checks take num_tx = 256 (full mode and a seq
    rank of 2) and 512 (whose first launch is the part transform's), and
    refuse 4096, naming the limit (2048)."""
    monkeypatch.setattr(fused_ls, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fused_ls, "_ls_lib", _stub)
    monkeypatch.setattr(fused_ls, "_ls_v1_lib", _stub)
    monkeypatch.setattr(fused_ls, "_ls_pair_lib", _stub)
    monkeypatch.setattr(fused_ls, "_ls_parts_lib", _stub)
    consts = ls_sm90_constants(CFG256)
    planes = torch.zeros((2, 4, CFG256.len_ltf), dtype=BF16)
    for call in (lambda: ls_planes_v2(CFG256, planes, consts),
                 lambda: ls_planes_v2(CFG256, planes[..., :128 * 320],
                                      consts, seq_shard=(1, 2),
                                      with_ssq=True),
                 lambda: fused_ls.ls_planes_v1(CFG256, planes, consts),
                 lambda: fused_ls.ls_pair_kernel(CFG256, planes, 4, consts)):
        with pytest.raises(_Launch):
            call()
    cfg512 = SimConfig(num_tx=512, num_rx=1)
    with pytest.raises(_Launch):
        ls_planes_v2(cfg512, torch.zeros((2, 1, cfg512.len_ltf),
                                         dtype=BF16),
                     ls_sm90_constants(cfg512))
    cfg4096 = SimConfig(num_tx=4096, num_rx=1)
    with pytest.raises(ValueError, match="power of 2 <= 2048"):
        ls_planes_v2(cfg4096, torch.zeros((2, 1, cfg4096.len_ltf),
                                          dtype=BF16),
                     ls_sm90_constants(cfg4096))
