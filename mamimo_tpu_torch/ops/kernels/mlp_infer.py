"""Fused 3-layer MLP inference on the materialized input: wrappers of the
hand-written CUDA kernels in ``csrc/mlp_infer.cu`` (the counterpart of
``mamimo_tpu/ops/pallas/mlp_infer.py``).

    h1 = rd(relu(x @ W1 + b1) · s1 + t1)          mlp_infer_layer1
    h2 = rd(relu(h1 @ W2 + b2) · s2 + t2)         mlp_infer_tail
    y  = h2 @ W3 + b3                             mlp_infer_tail

(s, t) are the eval-mode BatchNorm affines folded after each ReLU
(``fold_bn_into_dense``). The products take operands rounded (rd) to the
weights' dtype, the tree's ``dot_dtype``, and sum in float32: bf16 (the
kernels' bf16 mode) or float32 (their float32 mode, 3xTF32 on the
tensor cores, float32 accuracy; h1 stays float32). On CUDA tensors each
wrapper launches its kernel, in the mode of the tree's dtype; on CPU
tensors it runs the kernel's plain version, which rounds the same
operands.
"""

from __future__ import annotations

import ctypes

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import _bn_affine, plane, preprocess_input
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import (
    _round_up,
    count_launch,
    kmajor_weight,
    on_cuda,
    tf32_split,
    tma_operand,
)

_OP = 256           # the tail kernel's padded output width
_MAX_RESIDENT = 1024    # the widest bf16 h1 the fused tail keeps whole


def fold_bn_into_dense(tcfg: TrainConfig, params, bn_state):
    """Fold inference-mode BatchNorm into post-ReLU affines, one plane.

    Returns (ws, bs, scales, shifts): the dense weights and biases of the
    three layers, and per hidden layer the (scale, shift) applied to the
    output of its ReLU (identity without BN), all float32.
    """
    ws = [l["w"] for l in params["dense"]] + [params["out"]["w"]]
    bs = [l["b"] for l in params["dense"]] + [params["out"]["b"]]
    scales, shifts = [], []
    for i in range(len(params["dense"])):
        if params["bn"]:
            a, c = _bn_affine(tcfg, params, bn_state, i)
        else:
            a = torch.ones(ws[i].shape[1], device=ws[i].device)
            c = torch.zeros(ws[i].shape[1], device=ws[i].device)
        scales.append(a)
        shifts.append(c)
    return ws, bs, scales, shifts


def _padded(t: torch.Tensor, shape) -> torch.Tensor:
    """t zero-padded at the end of each dimension to ``shape``."""
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _prepare_plane(tcfg: TrainConfig, params, bn_state, dot_dtype):
    if len(params["dense"]) != 2:
        raise ValueError("the fused MLP kernel supports 2 hidden layers, "
                         f"got {len(params['dense'])}")
    (w1, w2, w3), (b1, b2, b3), (s1, s2), (t1, t2) = \
        fold_bn_into_dense(tcfg, params, bn_state)
    k, c = w1.shape[0], w3.shape[1]
    # both hidden widths zero-padded to one multiple of 128 (the kernels'
    # tile): a padded unit has weight, bias, scale and shift 0, so it is 0
    # after the ReLU and its affine and adds nothing downstream
    hp = _round_up(max(w1.shape[1], w2.shape[1]), 128)
    w1p = _padded(w1, (_round_up(k, 32), hp))
    w2 = _padded(w2, (hp, hp))
    w3p = _padded(w3, (hp, _round_up(c, _OP)))
    b1, s1, t1, b2, s2, t2 = (_padded(v, (hp,))
                              for v in (b1, s1, t1, b2, s2, t2))
    f32 = lambda t: t.float().contiguous()                   # noqa: E731
    w1p, w2, w3p = (w.to(dot_dtype) for w in (w1p, w2, w3p))
    out = {"w1": w1p, "w1t": w1p.T.contiguous(), "b1": f32(b1),
           "s1": f32(s1), "t1": f32(t1), "w2": w2.contiguous(),
           "w2t": w2.T.contiguous(), "b2": f32(b2), "s2": f32(s2),
           "t2": f32(t2), "w3": w3p, "w3t": w3p.T.contiguous(),
           "b3": f32(b3)}
    if dot_dtype == torch.float32:
        for k in ("w1t", "w2t", "w3t"):
            out[f"{k}_tf32"] = tf32_split(out.pop(k))
    return out


def prepare_mlp_infer_weights(tcfg: TrainConfig, params, bn_state,
                              dot_dtype=torch.bfloat16):
    """The kernels' weights for both planes of stacked parameters, folded
    once: a dict of stacked (plane-leading) tensors, the weights in
    ``dot_dtype`` (bfloat16, or float32 for the kernels' float32 mode)

      w1 (2, Kp, H) — rows past in_dim zero, Kp = round_up(in_dim, 32)
      w1t (2, H, Kp) — w1 transposed, the layer-1 kernel's K-major B
                       operand
      b1, s1, t1 (2, H) f32 — bias and post-ReLU affine of layer 1
      w2 (2, H, H); b2, s2, t2 (2, H) f32
      w2t (2, H, H) — w2 transposed, the tail kernel's K-major layer-2
                      operand
      w3 (2, H, 256) — carriers zero-padded
      w3t (2, 256, H) — w3 transposed, the tail kernel's K-major layer-3
                        operand
      b3 (2, C) f32

    where with dot_dtype float32 the K-major weights come split instead:

      w1t_tf32 (2, 2, H, Kp), w2t_tf32 (2, 2, H, H), w3t_tf32 (2, 2,
        256, H) — the TF32 high and low parts of w1t, w2t, w3t
        (``tf32_split``; on CUDA the split kernel), the operands the
        float32 kernels load, in place of w1t, w2t, w3t; the plain
        versions use w1, w2, w3

    H is both hidden widths rounded up to one multiple of 128, the
    kernels' tile (as ``prepare_factored_weights``): the extra units get
    zero weights, biases and BN affines, so they stay 0 through ReLU and
    the answer is exact. The bf16 tail kernel keeps h1 in shared memory up
    to H = 1024, two GEMMs take wider h1 (``tail_route``); the float32
    tail streams h1's slabs at any width.

    Run it under ``full_f32_matmul()`` on the card, as the serving paths
    do. ``plane(prepared, d)`` is one plane's tree for ``mlp_infer_pallas``.
    """
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dot_dtype must be bfloat16 or float32, got "
                        f"{dot_dtype}")
    planes = [_prepare_plane(tcfg, plane(params, d), plane(bn_state, d),
                             dot_dtype) for d in range(2)]
    return {k: torch.stack([p[k] for p in planes]) for k in planes[0]}


def _prepared(tcfg, params, bn_state, dot_dtype):
    """One plane's kernel tree: ``params`` as it is when it is one
    already, else folded from the JAX-style (params, bn_state) (with
    dot_dtype float32 its K-major weights split per call)."""
    if "w1" in params:
        return params
    return _prepare_plane(tcfg, params, bn_state, dot_dtype)


def _mm(a: torch.Tensor, w: torch.Tensor, dot_dtype) -> torch.Tensor:
    """a @ w with both rounded to dot_dtype, multiplied and summed in
    float32."""
    return a.to(dot_dtype).float() @ w.to(dot_dtype).float()


def _layer1_plain(p, x: torch.Tensor, dot_dtype=torch.bfloat16):
    """Plain version of the layer-1 kernel: h1 (M, H1) in dot_dtype."""
    h = torch.relu(_mm(x, p["w1"][:x.shape[1]], dot_dtype) + p["b1"])
    return (h * p["s1"] + p["t1"]).to(dot_dtype)


def _tail_plain(p, h1: torch.Tensor, dot_dtype=torch.bfloat16):
    """Plain version of the tail kernel: y (M, C) float32."""
    h2 = torch.relu(_mm(h1, p["w2"], dot_dtype) + p["b2"])
    h2 = h2 * p["s2"] + p["t2"]
    c = p["b3"].shape[-1]
    return _mm(h2, p["w3"][:, :c], dot_dtype) + p["b3"]


def _tree_mode(p, who: str) -> int:
    """The launch mode of a tree's weights: 0 bf16, 2 float32 (the float32
    mode); a tree whose weights mix dtypes raises TypeError."""
    dts = {p[k].dtype for k in ("w1", "w1t", "w2", "w2t", "w3", "w3t")
           if k in p}
    if len(dts) != 1 or not dts <= {torch.bfloat16, torch.float32}:
        raise TypeError(f"{who} takes a tree of bf16 or of float32 weights "
                        f"(prepare_mlp_infer_weights' dot_dtype), got "
                        f"{sorted(map(str, dts))}")
    return 2 * (dts == {torch.float32})


def mlp_infer_layer1(p, x: torch.Tensor) -> torch.Tensor:
    """Layer 1 of one plane: x (M, in_dim) → h1 (M, H1) in the tree's
    dtype.

    CUDA: the K-streamed GEMM kernel with the bias, ReLU, affine and
    rounding in its epilogue; it reads W1 K-major, the tree's ``w1t``
    (``prepare_mlp_infer_weights``; a float32 tree's ``w1t_tf32``, its
    TF32 parts). A bf16 tree takes x float32 (cast to bf16 first) or
    bf16; a float32 tree runs the float32 mode on float32 x as it is
    (bf16 x raises). CPU: the plain version."""
    if not on_cuda(x, *(p[k] for k in ("w1", "b1", "s1", "t1"))):
        return _layer1_plain(p, x, p["w1"].dtype)
    w1 = p["w1"]
    mode = _tree_mode(p, "mlp_infer_layer1")
    m, k = x.shape
    kp, h1 = w1.shape
    if mode and x.dtype != torch.float32:
        raise TypeError(f"the float32 mode of mlp_infer_layer1 takes "
                        f"float32 x, got {x.dtype}")
    pitch = 4 if mode else 8
    if k % pitch or kp != _round_up(k, 32) or h1 % 128:
        raise ValueError(f"the layer-1 kernel needs in_dim % {pitch} == 0, "
                         f"w1 of round_up(in_dim, 32) rows and H1 % 128 == "
                         f"0; got x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    w1t = kmajor_weight(p, "w1t_tf32", (2, h1, kp), "mlp_infer_layer1",
                        torch.float32) if mode else \
        kmajor_weight(p, "w1t", (h1, kp), "mlp_infer_layer1")
    x = tma_operand(x.to(w1.dtype))
    out = torch.empty((m, h1), dtype=w1.dtype, device=x.device)
    if m == 0:
        return out
    lib = _mlp_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mlp_layer1_launch(
            x.data_ptr(), w1t.data_ptr(),
            *(p[n].contiguous().data_ptr() for n in ("b1", "s1", "t1")),
            out.data_ptr(), m, k, kp, h1, mode, stream)
    _build.check(rc, lib, "mlp_infer_error_string", "mlp_infer_layer1")
    count_launch(mlp_infer_layer1, mode)
    return out


# launches of the kernel, and of those its float32 mode's
mlp_infer_layer1.launches = mlp_infer_layer1.launches_f32 = 0


def mlp_infer_tail(p, h1: torch.Tensor) -> torch.Tensor:
    """Layers 2 and 3 of one plane: h1 (M, H1) in the tree's dtype → y
    (M, C) float32. CUDA: the kernel that keeps h2 on chip (bf16 up to H1
    = 1024, h1 too; float32, the float32 mode: h1's slabs stream, h2 is
    staged in shared memory), or for bf16 h1 above 1024 units
    (``tail_route``) two GEMMs on ``mm_sm90.cuh``'s gemm_coop walk, h2 =
    bf16(relu(h1 @ W2 + b2)·s2 + t2) through device memory, then y; both
    read W2 and W3 K-major from the tree's ``w2t`` and ``w3t``
    (``prepare_mlp_infer_weights``; a float32 tree's ``w2t_tf32`` and
    ``w3t_tf32``, their TF32 parts), required there. CPU: the plain
    version."""
    keys = ("w2", "b2", "s2", "t2", "w3", "b3")
    if not on_cuda(h1, *(p[k] for k in keys)):
        return _tail_plain(p, h1, p["w2"].dtype)
    q = {k: p[k].contiguous() for k in keys}
    m, H1 = h1.shape
    H2 = q["w2"].shape[1]
    c = q["b3"].shape[-1]
    mode = _tree_mode({k: p[k] for k in ("w2", "w3")}, "mlp_infer_tail")
    dt = q["w2"].dtype
    if h1.dtype != dt:
        raise TypeError(f"mlp_infer_tail takes h1 of the weights' dtype "
                        f"({dt}), got {h1.dtype}")
    if H1 % 128 or H2 % 128 or c > _OP \
            or tuple(q["w2"].shape) != (H1, H2) \
            or tuple(q["w3"].shape) != (H2, _OP):
        raise ValueError(f"the tail kernel needs H1, H2 % 128 == 0, w3 (H2, "
                         f"{_OP}) and C <= {_OP}; got H1={H1}, w2 "
                         f"{tuple(q['w2'].shape)}, w3 "
                         f"{tuple(q['w3'].shape)}, C={c}")
    sfx, parts = ("t_tf32", (2,)) if mode else ("t", ())
    q["w2t"] = kmajor_weight(p, f"w2{sfx}", (*parts, H2, H1),
                             "mlp_infer_tail", dt)
    q["w3t"] = kmajor_weight(p, f"w3{sfx}", (*parts, _OP, H2),
                             "mlp_infer_tail", dt)
    out = torch.empty((m, c), dtype=torch.float32, device=h1.device)
    if m == 0:
        return out
    h1 = tma_operand(h1)
    lib = _mlp_lib()
    ptrs = [q[k].data_ptr() for k in ("w2t", "b2", "s2", "t2", "w3t", "b3")]
    gemms = tail_route(H1, dt) == "gemms"
    h2 = torch.empty((m, H2), dtype=dt, device=h1.device) if gemms else None
    with torch.cuda.device(h1.device):
        stream = torch.cuda.current_stream().cuda_stream
        if gemms:
            rc = lib.mlp_tail_gemms_launch(
                h1.data_ptr(), *ptrs, out.data_ptr(), h2.data_ptr(), m, H1,
                H2, c, stream)
        else:
            rc = lib.mlp_tail_launch(h1.data_ptr(), *ptrs, out.data_ptr(),
                                     m, H1, H2, c, mode, stream)
    _build.check(rc, lib, "mlp_infer_error_string", "mlp_infer_tail")
    count_launch(mlp_infer_tail, mode)
    mlp_infer_tail.launches_gemms += gemms
    return out


# launches of the tail, and of those the float32 mode's and the two-GEMM
# route's
mlp_infer_tail.launches = mlp_infer_tail.launches_f32 = 0
mlp_infer_tail.launches_gemms = 0


def tail_route(h1: int, dtype) -> str:
    """Which kernels run ``mlp_infer_tail`` on the card for h1 of ``h1``
    units in ``dtype``: "fused" (h2 on chip: bf16 up to 1024 units,
    float32 at any width) or "gemms" (bf16 above 1024 units: the two
    GEMMs, h2 through device memory; a fused kernel that streamed h1's
    slabs beside W2's tiles took 1.8x as long at 2048 units on an H100,
    PERF.md). Up to 1024 units the fused kernel stays."""
    return "gemms" if dtype == torch.bfloat16 and h1 > _MAX_RESIDENT \
        else "fused"


def mlp_infer_pallas(tcfg: TrainConfig, params, bn_state, x: torch.Tensor,
                     *, block_b: int = 256, block_k: int = 1152,
                     dot_dtype=torch.bfloat16, interpret=None):
    """Fused inference of one plane on a preprocessed batch.

    Args:
      params, bn_state: ONE plane's parameters (no stacked axis), or one
        plane of ``prepare_mlp_infer_weights`` (bn_state then unused). Two
        hidden layers (the paper's 1024/1024).
      x: (B, in_dim) float32 or bfloat16.
      dot_dtype: the products' operand type, bfloat16 or float32 (the
        kernels' float32 mode; x is then taken as float32). Raw
        parameters are folded in it; a prepared tree must be of it.
      block_b, block_k, interpret: accepted for the JAX signature and
        ignored (the CUDA kernels pick their own tiling).

    Returns:
      (B, out_dim) float32. CUDA: ``mlp_infer_layer1`` then
      ``mlp_infer_tail``, h1 in device memory in dot_dtype. CPU: the
      plain version, every operand rounded to dot_dtype.
    """
    del block_b, block_k, interpret
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dot_dtype must be bfloat16 or float32, got "
                        f"{dot_dtype}")
    p = _prepared(tcfg, params, bn_state, dot_dtype)
    if not on_cuda(x):
        return _tail_plain(p, _layer1_plain(p, x, dot_dtype), dot_dtype)
    if p["w1"].dtype != dot_dtype:
        raise TypeError(f"dot_dtype {dot_dtype} differs from the prepared "
                        f"tree's {p['w1'].dtype} (prepare_mlp_infer_weights'"
                        f" dot_dtype)")
    return mlp_infer_tail(p, mlp_infer_layer1(p, x))


def predict_complex_pallas(cfg: SimConfig, tcfg: TrainConfig, params,
                           bn_state, sig: torch.Tensor, pilot: torch.Tensor,
                           **kw) -> torch.Tensor:
    """Complex CSI prediction through the fused kernels (both planes): the
    real plane through plane 0's weights, the imaginary plane through
    plane 1's. Drop-in fast path for ``models.mlp.predict_complex``.

    params: stacked parameters (with bn_state) or the stacked tree of
    ``prepare_mlp_infer_weights``. sig: (B, len_ltf) complex; pilot:
    (B, num_tx). Returns (B, num_carriers) complex64."""
    bn = bn_state if "dense" in params else {}
    ys = [mlp_infer_pallas(
        tcfg, plane(params, d), plane(bn, d),
        preprocess_input(cfg, tcfg, part.float(), pilot), **kw)
        for d, part in enumerate((sig.real, sig.imag))]
    return torch.complex(ys[0], ys[1])


def _mlp_lib() -> ctypes.CDLL:
    lib = _build.library("mlp_infer")
    f = lib.mlp_layer1_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    f = lib.mlp_tail_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    f = lib.mlp_tail_gemms_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib
