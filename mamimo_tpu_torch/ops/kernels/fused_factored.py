"""Fused factored all-pairs DNN: wrappers of the hand-written CUDA kernels
in ``csrc/fused_factored.cu`` (the counterpart of
``mamimo_tpu/ops/pallas/fused_factored.py``).

    sig_proj = x @ W1[:L]                                  factored_sig_proj
    h[s,t]   = relu(sig_proj[s] + hb[t]) · a1 + c1         factored_tail
    y[s,t]   = (relu(h @ W2 + b2) · a2 + c2) @ W3 + b3     factored_tail

``hb[t] = P[:,t] @ W1[L:] + b1`` folds the pilot column and the layer-1
bias into one row per head; (a_i, c_i) are the eval-mode BatchNorm
affines. On CUDA tensors each wrapper launches its kernel; on CPU tensors
it runs the kernel's plain version, which mirrors the TPU kernel's body:
operands are rounded to the weights' dtype, products and sums are
float32.
"""

from __future__ import annotations

import ctypes

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import _bn_affine, plane, require_full_input
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import (
    _round_up,
    kmajor_weight,
    on_cuda,
    tma_operand,
)
from mamimo_tpu_torch.ops.ltf import pilot_p_matrix

_TAIL_OP = 256      # the tail kernel's padded output width


def prepare_factored_weights(cfg: SimConfig, tcfg: TrainConfig, params,
                             bn_state, dot_dtype=torch.bfloat16):
    """Fold BN and the pilot heads into kernel-ready tensors (once per set
    of weights). Returns a dict of stacked (plane-leading) tensors:

      w1   (2, L, H)       dot_dtype — signal half of layer 1
      w1t  (2, H, L)       dot_dtype — w1 transposed, the layer-1
                                       kernel's K-major B operand
      hb   (2, num_tx, H)  f32       — per-head bias P[:,t]@W1[L:] + b1
      a1,c1,a2,c2 (2,1,H)  f32       — eval-mode BN affines (identity
                                       without BN)
      w2   (2, H, H)       dot_dtype
      w2t  (2, H, H)       dot_dtype — w2 transposed, the tail kernel's
                                       K-major layer-2 operand
      b2   (2, 1, H)       f32
      w3   (2, H, OP)      dot_dtype — OP = round_up(num_carriers, 128)
      w3t  (2, OPT, H)     dot_dtype — w3 zero-padded to OPT = max(OP,
                                       256) columns and transposed, the
                                       tail kernel's K-major layer-3
                                       operand
      b3   (2, 1, OP)      f32

    H is both hidden widths rounded up to one multiple of 128, the
    kernels' tile: the extra units get zero weights, biases and BN
    affines, so they stay 0 through ReLU and add nothing to any output.
    """
    if len(tcfg.hidden) != 2:
        raise ValueError("the fused kernels support 2 hidden layers, got "
                         f"{len(tcfg.hidden)}")
    require_full_input(tcfg)
    L, C = cfg.len_ltf, cfg.num_carriers
    op = _round_up(C, 128)
    w1_full = params["dense"][0]["w"].float()          # (2, L+ntx, H)
    dev = w1_full.device
    P = pilot_p_matrix(cfg.num_tx, device=dev)
    hb = torch.einsum("tj,djh->dth", P.T, w1_full[:, L:]) \
        + params["dense"][0]["b"][:, None, :]
    h1, h2 = tcfg.hidden
    H = _round_up(max(h1, h2), 128)
    hb = _pad_to(hb, H)
    w1_full = _pad_to(w1_full, H)
    w2 = _pad_to(_pad_to(params["dense"][1]["w"], H), H, dim=-2)
    w3 = _pad_to(params["out"]["w"], H, dim=-2)

    def bn_affine(i, h_dim):
        if params["bn"]:
            a, c = zip(*(_bn_affine(tcfg, plane(params, d),
                                    plane(bn_state, d), i) for d in range(2)))
            a, c = torch.stack(a), torch.stack(c)
        else:
            a = torch.ones((2, h_dim), device=dev)
            c = torch.zeros((2, h_dim), device=dev)
        return (_pad_to(a[:, None, :].float(), H),
                _pad_to(c[:, None, :].float(), H))

    a1, c1 = bn_affine(0, h1)
    a2, c2 = bn_affine(1, h2)
    w3p = torch.zeros((2, w3.shape[1], op), device=dev)
    w3p[:, :, :C] = w3
    b3p = torch.zeros((2, op), device=dev)
    b3p[:, :C] = params["out"]["b"]
    w1 = w1_full[:, :L].to(dot_dtype)
    w2 = w2.to(dot_dtype)
    w3t = torch.zeros((2, max(op, _TAIL_OP), w3.shape[1]), device=dev,
                      dtype=dot_dtype)
    w3t[:, :C] = w3.transpose(1, 2).to(dot_dtype)
    return {
        "w1": w1.contiguous(),
        "w1t": w1.transpose(1, 2).contiguous(),
        "hb": hb.float().contiguous(),
        "a1": a1, "c1": c1, "a2": a2, "c2": c2,
        "w2": w2.contiguous(),
        "w2t": w2.transpose(1, 2).contiguous(),
        "b2": _pad_to(params["dense"][1]["b"][:, None, :].float(), H)
        .contiguous(),
        "w3": w3p.to(dot_dtype).contiguous(),
        "w3t": w3t,
        "b3": b3p[:, None, :].contiguous(),
    }


def _pad_to(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """t zero-padded at the end of `dim` to n entries."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype and both taken in float32."""
    return a.to(w.dtype).float() @ w.float()


def factored_sig_proj(x: torch.Tensor, w1: torch.Tensor,
                      w1t: torch.Tensor | None = None) -> torch.Tensor:
    """Layer 1 of both planes: x (2, S, L) @ w1 (2, L, H) → (2, S, H)
    float32. CUDA: bfloat16 x and w1, the hand-written GEMM kernel, which
    reads W1 K-major from ``w1t`` (2, H, L), ``prepared["w1t"]``; it is
    required there. CPU: the plain version (w1t unused)."""
    if not on_cuda(x, w1):
        return _mm(x, w1)
    if x.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16:
        raise TypeError("factored_sig_proj takes bfloat16 x and w1 on CUDA")
    _, s, L = x.shape
    H = w1.shape[2]
    if tuple(w1.shape) != (2, L, H) or x.shape[0] != 2 or L % 8 or H % 128:
        raise ValueError(f"factored_sig_proj needs x (2,S,L), w1 (2,L,H) "
                         f"with L % 8 == 0 and H % 128 == 0, got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}")
    if w1t is None:
        raise ValueError("factored_sig_proj needs w1t, prepared['w1t'], on "
                         "CUDA")
    if tuple(w1t.shape) != (2, H, L) or w1t.dtype != torch.bfloat16:
        raise ValueError(f"factored_sig_proj needs w1t (2, {H}, {L}) bf16, "
                         f"got {tuple(w1t.shape)} {w1t.dtype}")
    out = torch.empty((2, s, H), dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    x, w1t = tma_operand(x), tma_operand(w1t)
    lib = _ff_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_sig_proj_launch(x.data_ptr(), w1t.data_ptr(),
                                          out.data_ptr(), s, L, H, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_sig_proj")
    factored_sig_proj.launches += 1
    return out


factored_sig_proj.launches = 0

_TAIL_KEYS = ("hb", "a1", "c1", "w2", "b2", "a2", "c2", "w3", "b3")
# the kernel's operands, in its launch order
_TAIL_ARGS = ("hb", "a1", "c1", "w2t", "b2", "a2", "c2", "w3t", "b3")


def _tail_plain(prepared, sig_proj: torch.Tensor, C: int) -> torch.Tensor:
    """Plain version of the tail kernel: (2, S, H) → (2, S, ntx, C)."""
    p = prepared
    h = torch.relu(sig_proj[:, :, None, :] + p["hb"][:, None, :, :])
    h = h * p["a1"][:, None] + p["c1"][:, None]
    h2 = torch.relu(_mm(h, p["w2"][:, None]) + p["b2"][:, None])
    h2 = h2 * p["a2"][:, None] + p["c2"][:, None]
    y = _mm(h2, p["w3"][:, None]) + p["b3"][:, None]
    return y[..., :C]


def factored_tail(prepared, sig_proj: torch.Tensor, C: int) -> torch.Tensor:
    """Heads, layers 2 and 3 of both planes from sig_proj (2, S, H) f32:
    returns y (2, S, num_tx, C) float32, rx-major. CUDA: the fused tail
    kernel, which reads W2 and W3 K-major from ``prepared["w2t"]`` and
    ``prepared["w3t"]`` (required there); h and h2 stay on chip. CPU: the
    plain version."""
    if not on_cuda(sig_proj, *(prepared[k] for k in _TAIL_KEYS)):
        return _tail_plain(prepared, sig_proj, C)
    p = {k: prepared[k].contiguous() for k in _TAIL_KEYS}
    sig_proj = sig_proj.contiguous()
    _, s, H = sig_proj.shape
    nt = p["hb"].shape[1]
    if p["w2"].dtype != torch.bfloat16 or p["w3"].dtype != torch.bfloat16 \
            or sig_proj.dtype != torch.float32:
        raise TypeError("factored_tail takes f32 sig_proj and bf16 w2, w3")
    # h (64 x H bf16) must fit in shared memory beside the ring
    if H % 128 or H > 1024 or tuple(p["w3"].shape) != (2, H, _TAIL_OP) \
            or C > _TAIL_OP or tuple(p["w2"].shape) != (2, H, H):
        raise ValueError(f"factored_tail needs H % 128 == 0, H <= 1024, "
                         f"w3 (2, H, {_TAIL_OP}) and C <= {_TAIL_OP}")
    for key, shape in (("w2t", (2, H, H)), ("w3t", (2, _TAIL_OP, H))):
        p[key] = kmajor_weight(prepared, key, shape, "factored_tail")
    out = torch.empty((2, s, nt, C), dtype=torch.float32,
                      device=sig_proj.device)
    if s == 0:
        return out
    lib = _ff_lib()
    with torch.cuda.device(sig_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_tail_launch(
            sig_proj.data_ptr(), *(p[k].data_ptr() for k in _TAIL_ARGS),
            out.data_ptr(), s, nt, H, C, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_tail")
    factored_tail.launches += 1
    return out


factored_tail.launches = 0


def fused_factored_planes(cfg: SimConfig, tcfg: TrainConfig, prepared,
                          planes: torch.Tensor) -> torch.Tensor:
    """The fused factored all-pairs inference on both planes.

    Args:
      prepared: from prepare_factored_weights (bf16 weights on CUDA).
      planes: (2, S, len_ltf), S = batch·num_rx rx-major; bfloat16 on
        CUDA.

    Returns:
      (2, S, num_tx, num_carriers) float32 — rx-major, the layout of
      ``_factored_all_pairs`` (the TPU kernel returned head-major
      (2, num_tx, S, C); this layout needs no transpose before the
      serving call's output).
    """
    require_full_input(tcfg)
    sig_proj = factored_sig_proj(planes, prepared["w1"], prepared["w1t"])
    return factored_tail(prepared, sig_proj, cfg.num_carriers)


def predict_all_pairs_planes_kernel(cfg: SimConfig, tcfg: TrainConfig,
                                    prepared, rx_planes: torch.Tensor):
    """All-pairs DNN CSI from rx-major planes (2, B, num_rx, len_ltf)
    through the fused kernels. Returns (B, num_rx, num_tx, num_carriers)
    complex64."""
    _, b, nrx, L = rx_planes.shape
    x = rx_planes.reshape(2, b * nrx, L)
    if x.is_cuda:
        x = x.to(prepared["w1"].dtype)
    y = fused_factored_planes(cfg, tcfg, prepared, x)
    return torch.complex(y[0], y[1]).reshape(b, nrx, cfg.num_tx,
                                             cfg.num_carriers)


def _ff_lib(defines=()) -> ctypes.CDLL:
    lib = _build.library("fused_factored", defines)
    f = lib.factored_sig_proj_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    f = lib.factored_tail_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib
