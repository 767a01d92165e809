"""Fused factored all-pairs DNN: wrappers of the hand-written CUDA kernels
in ``csrc/fused_factored.cu`` (the counterpart of
``mamimo_tpu/ops/pallas/fused_factored.py``).

    sig_proj = x @ W1[:L]                                  factored_sig_proj
    h[s,t]   = relu(sig_proj[s] + hb[t]) · a1 + c1         factored_tail
    y[s,t]   = (relu(h @ W2 + b2) · a2 + c2) @ W3 + b3     factored_tail

``hb[t] = P[:,t] @ W1[L:] + b1`` folds the pilot column and the layer-1
bias into one row per head; (a_i, c_i) are the eval-mode BatchNorm
affines. That is the two-hidden-layer model of up to 1024 units in its
first layer, whose heads run in one fused kernel (h stays in shared
memory). Any other model runs the per-head rows through device memory
in the weights' dtype: ``factored_heads`` writes h, ``factored_dense``
runs hidden layers 2 .. D-1 (or, at D = 1, the output layer), and
``factored_rows_tail`` the last hidden layer and the output (bf16: two
GEMMs, the last hidden layer's rows through device memory too).
``fused_factored_planes``
routes by depth and width. ``factored_sig_proj`` splits K across the
card where its tiles cannot fill it (few rows, long K: 512 and more Tx
antennas; ``sig_proj_splits``), in both modes.

The weights' dtype picks the mode (``prepare_factored_weights``'
``dot_dtype``): bfloat16 weights run the bf16 kernels, float32 weights
the float32 mode, every product at float32 accuracy (3xTF32 on the
tensor cores) on float32 rows, always through the per-head rows (the
fused tail keeps bf16 h only); the kernels read each K-major weight as
its TF32 high and low parts, split once by ``prepare_factored_weights``
(the ``<key>_tf32`` entries), and split the rows in registers. The
output layer's store takes ``out_dtype`` float32 or bfloat16 (the
float32 result rounded to nearest even). On CUDA tensors each wrapper
launches its kernel (or raises: a float32 request never runs the plain
version or a bf16 kernel); on CPU tensors it runs the kernel's plain
version, which mirrors the TPU kernel's body: operands are rounded to
the weights' dtype, products and sums are float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import _bn_affine, plane, require_full_input
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import (
    _round_up,
    count_launch,
    kmajor_weight,
    on_cuda,
    tf32_split,
    tma_operand,
)
from mamimo_tpu_torch.ops.ltf import pilot_p_matrix

_TAIL_OP = 256      # the tail kernel's padded output width
_MAX_RESIDENT = 1024    # the widest h the fused tail keeps in shared memory
_F32, _BF16 = torch.float32, torch.bfloat16
_MODE_BF16_OUT, _MODE_F32 = 1, 2    # the launch functions' mode bits


def _mode_of(dtype, who: str) -> int:
    """The float32-operands bit of a launch's mode for weights of dtype;
    raises TypeError for a dtype no kernel takes."""
    if dtype not in (_BF16, _F32):
        raise TypeError(f"{who} takes bfloat16 or float32 weights, got "
                        f"{dtype}")
    return _MODE_F32 * (dtype == _F32)


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in (_F32, _BF16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def prepare_factored_weights(cfg: SimConfig, tcfg: TrainConfig, params,
                             bn_state, dot_dtype=torch.bfloat16):
    """Fold BN and the pilot heads into kernel-ready tensors (once per set
    of weights), for any number D >= 1 of hidden layers. Returns a dict of
    stacked (plane-leading) tensors, layer k = 1 .. D the hidden layers
    and layer D + 1 the output:

      w1   (2, L, H1)      dot_dtype — signal half of layer 1
      w1t  (2, H1, L)      dot_dtype — w1 transposed, the layer-1
                                       kernel's K-major B operand
      hb   (2, num_tx, H1) f32       — per-head bias P[:,t]@W1[L:] + b1
      a1, c1 (2, 1, H1)    f32       — eval-mode BN affine of layer 1
                                       (identity without BN)
      for each hidden layer k = 2 .. D:
      wk   (2, H{k-1}, Hk) dot_dtype
      wkt  (2, Hk, H{k-1}) dot_dtype — wk transposed, K-major for the
                                       kernels
      bk, ak, ck (2, 1, Hk) f32      — bias and BN affine
      and the output layer k = D + 1:
      wk   (2, HD, OP)     dot_dtype — OP = round_up(num_carriers, 128)
      wkt  (2, OPT, HD)    dot_dtype — wk zero-padded to OPT = max(OP,
                                       256) columns and transposed, the
                                       kernels' K-major output operand
      bk   (2, 1, OP)      f32

    At D = 2 these are w1, w2, w3 with their transposes, as the fused
    kernels have always taken them. Hk is hidden width k rounded up to a
    multiple of 128, the kernels' tile: the extra units get zero
    weights, biases and BN affines, so they stay 0 through ReLU and add
    nothing to any output.

    With dot_dtype float32 each K-major weight ``wkt`` (w1t, the hidden
    ones and the output's) comes instead as ``wkt_tf32`` (2, 2, N, K):
    its TF32 high and low parts (``tf32_split`` at dim 1; on CUDA the
    split kernel), the operand the float32 kernels load. The plain
    versions use the unsplit ``wk``.
    """
    depth = len(tcfg.hidden)
    if depth < 1:
        raise ValueError("the factored kernels need at least 1 hidden "
                         "layer, got 0")
    require_full_input(tcfg)
    L, C = cfg.len_ltf, cfg.num_carriers
    op = _round_up(C, 128)
    widths = [_round_up(h, 128) for h in tcfg.hidden]
    w1_full = params["dense"][0]["w"].float()          # (2, L+ntx, h1)
    dev = w1_full.device
    P = pilot_p_matrix(cfg.num_tx, device=dev)
    hb = torch.einsum("tj,djh->dth", P.T, w1_full[:, L:]) \
        + params["dense"][0]["b"][:, None, :]

    def bn_affine(i, width):
        if params["bn"]:
            a, c = zip(*(_bn_affine(tcfg, plane(params, d),
                                    plane(bn_state, d), i) for d in range(2)))
            a, c = torch.stack(a), torch.stack(c)
        else:
            a = torch.ones((2, tcfg.hidden[i]), device=dev)
            c = torch.zeros((2, tcfg.hidden[i]), device=dev)
        return (_pad_to(a[:, None, :].float(), width).contiguous(),
                _pad_to(c[:, None, :].float(), width).contiguous())

    w1 = _pad_to(w1_full[:, :L], widths[0]).to(dot_dtype)
    out = {"w1": w1.contiguous(), "w1t": w1.transpose(1, 2).contiguous(),
           "hb": _pad_to(hb, widths[0]).float().contiguous()}
    out["a1"], out["c1"] = bn_affine(0, widths[0])
    for i in range(1, depth):
        k = i + 1
        w = _pad_to(_pad_to(params["dense"][i]["w"].float(), widths[i]),
                    widths[i - 1], dim=-2).to(dot_dtype)
        out[f"w{k}"] = w.contiguous()
        out[f"w{k}t"] = w.transpose(1, 2).contiguous()
        out[f"b{k}"] = _pad_to(params["dense"][i]["b"][:, None, :].float(),
                               widths[i]).contiguous()
        out[f"a{k}"], out[f"c{k}"] = bn_affine(i, widths[i])
    k = depth + 1
    w3 = _pad_to(params["out"]["w"].float(), widths[-1], dim=-2)
    w3p = torch.zeros((2, widths[-1], op), device=dev)
    w3p[:, :, :C] = w3
    b3p = torch.zeros((2, op), device=dev)
    b3p[:, :C] = params["out"]["b"]
    w3t = torch.zeros((2, max(op, _TAIL_OP), widths[-1]), device=dev,
                      dtype=dot_dtype)
    w3t[:, :C] = w3.transpose(1, 2).to(dot_dtype)
    out[f"w{k}"] = w3p.to(dot_dtype).contiguous()
    out[f"w{k}t"] = w3t
    out[f"b{k}"] = b3p[:, None, :].contiguous()
    if dot_dtype == _F32:
        for j in range(1, depth + 2):
            out[f"w{j}t_tf32"] = tf32_split(out.pop(f"w{j}t"), 1)
    return out


def factored_depth(prepared) -> int:
    """The number of hidden layers of prepare_factored_weights' dict."""
    return sum(1 for k in prepared if k[0] == "a" and k[1:].isdigit())


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


# the fewest k-steps a range of layer 1's split K holds: 16 of 64 in
# bf16, and the same 1024 elements of K, 32 k-steps of 32, in float32
SPLIT_MIN_KSTEPS = 16
SPLIT_MIN_KSTEPS_F32 = 32


def sig_proj_splits(m: int, n: int, k: int, sms: int,
                    float32: bool = False) -> int:
    """How many ranges of K the layer-1 kernel sums apart for x (2, m,
    k) @ w1 (2, k, n) on a card of ``sms`` SMs (``csrc/gemm_sm90.cuh``,
    the split walk; ``float32``: its float32 mode, ``gemm_tf32x3``'s): 1
    where its tile groups (two 128-row M-tiles of one N-tile of a plane,
    256 columns in bf16 and 128 in float32, one a 2-block cluster) are at
    least the sms // 2 clusters that fit; else the most ranges whose
    blocks (a range's: one an N-tile and plane at one M-tile, else two a
    pair of M-tiles) still fit on the sms, each range at least
    SPLIT_MIN_KSTEPS k-steps of 64 (float32: SPLIT_MIN_KSTEPS_F32 of 32),
    the count then trimmed so that no range of ceil(k-steps / splits) is
    empty."""
    bn, bk, least = (128, 32, SPLIT_MIN_KSTEPS_F32) if float32 else \
        (256, 64, SPLIT_MIN_KSTEPS)
    mt, nt = -(-m // 128), -(-n // bn)
    pairs = -(-mt // 2)
    if pairs * nt * 2 >= sms // 2:
        return 1
    kt = -(-k // bk)
    blocks = (1 if mt == 1 else 2 * pairs) * nt * 2
    splits = min(sms // blocks, kt // least)
    if splits < 2:
        return 1
    return -(-kt // -(-kt // splits))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def factored_sig_proj(x: torch.Tensor, w1: torch.Tensor,
                      w1t: torch.Tensor | None = None) -> torch.Tensor:
    """Layer 1 of both planes: x (2, S, L) @ w1 (2, L, H) → (2, S, H)
    float32. CUDA: x and w1 of one dtype, bfloat16 (the bf16 GEMM kernel,
    reading W1 K-major from ``w1t`` (2, H, L), ``prepared["w1t"]``) or
    float32 (its float32 mode, 3xTF32, reading W1's TF32 parts: ``w1t``
    is then ``prepared["w1t_tf32"]``, (2, 2, H, L) float32); w1t is
    required there. Either mode splits K where its tiles cannot fill the
    card (``sig_proj_splits``: the ranges' float32 partials in a
    workspace, summed in range order; counted in
    ``factored_sig_proj.launches_split``, the float32 mode's also in
    ``launches_split_f32``). CPU: the plain version (w1t unused)."""
    if not on_cuda(x, w1):
        return _mm(x, w1)
    mode = _mode_of(w1.dtype, "factored_sig_proj")
    if x.dtype != w1.dtype:
        raise TypeError(f"factored_sig_proj takes x of the weights' dtype "
                        f"on CUDA ({w1.dtype}), got {x.dtype}")
    _, s, L = x.shape
    H = w1.shape[2]
    pitch = 4 if mode else 8
    if tuple(w1.shape) != (2, L, H) or x.shape[0] != 2 or L % pitch \
            or H % 128:
        raise ValueError(f"factored_sig_proj needs x (2,S,L), w1 (2,L,H) "
                         f"with L % {pitch} == 0 and H % 128 == 0, got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}")
    key, shape = ("w1t_tf32", (2, 2, H, L)) if mode else ("w1t", (2, H, L))
    if w1t is None or tuple(w1t.shape) != shape or w1t.dtype != w1.dtype:
        got = "none" if w1t is None else f"{tuple(w1t.shape)} {w1t.dtype}"
        raise ValueError(f"factored_sig_proj needs w1t {shape} "
                         f"{str(w1.dtype)[6:]} (prepared['{key}']) on "
                         f"CUDA, got {got}")
    out = torch.empty((2, s, H), dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    x, w1t = tma_operand(x), tma_operand(w1t)
    splits = sig_proj_splits(s, H, L, _sm_count(x.device), bool(mode))
    ws = torch.empty((splits, 2, s, H), dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    lib = _ff_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_sig_proj_launch(
            x.data_ptr(), w1t.data_ptr(), out.data_ptr(), s, L, H, mode,
            None if ws is None else ws.data_ptr(), splits, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_sig_proj")
    count_launch(factored_sig_proj, mode & _MODE_F32)
    factored_sig_proj.launches_split += splits > 1
    factored_sig_proj.launches_split_f32 += splits > 1 and mode == _MODE_F32
    return out


# launches of the kernel, and of those its float32 mode's, its split
# walk's and the float32 mode's split walk's
factored_sig_proj.launches = factored_sig_proj.launches_f32 = 0
factored_sig_proj.launches_split = factored_sig_proj.launches_split_f32 = 0


def _hidden_plain(p, k: int, h: torch.Tensor) -> torch.Tensor:
    """Hidden layer k of the plain versions: relu(h @ wk + bk)·ak + ck,
    float32 (h of any leading shape, planes first; one batched product a
    plane)."""
    rows = h.reshape(2, -1, h.shape[-1])
    y = torch.relu(_mm(rows, p[f"w{k}"]) + p[f"b{k}"])
    y = y * p[f"a{k}"] + p[f"c{k}"]
    return y.reshape(*h.shape[:-1], y.shape[-1])


def _out_plain(p, h: torch.Tensor, C: int,
               out_dtype=torch.float32) -> torch.Tensor:
    """The output layer of the plain versions: (h @ w + b)[..., :C],
    float32 rounded to out_dtype."""
    k = factored_depth(p) + 1
    rows = h.reshape(2, -1, h.shape[-1])
    y = _mm(rows, p[f"w{k}"]) + p[f"b{k}"]
    return y.reshape(*h.shape[:-1], y.shape[-1])[..., :C].to(out_dtype)


def _heads_plain(p, sig_proj: torch.Tensor) -> torch.Tensor:
    """h = relu(sig_proj[s] + hb[t])·a1 + c1: (2, S, H1) → (2, S, ntx,
    H1) float32."""
    h = torch.relu(sig_proj[:, :, None, :] + p["hb"][:, None, :, :])
    return h * p["a1"][:, None] + p["c1"][:, None]


def _tail_plain(prepared, sig_proj: torch.Tensor, C: int,
                out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of everything after layer 1 at any depth, the fused
    tail kernel's at depth 2: (2, S, H1) → (2, S, ntx, C) out_dtype."""
    h = _heads_plain(prepared, sig_proj)
    for k in range(2, factored_depth(prepared) + 1):
        h = _hidden_plain(prepared, k, h)
    return _out_plain(prepared, h, C, out_dtype)


# the fused tail's operands (depth 2), in its launch order
_TAIL_ARGS = ("hb", "a1", "c1", "w2t", "b2", "a2", "c2", "w3t", "b3")


def factored_tail(prepared, sig_proj: torch.Tensor, C: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Heads, layers 2 and 3 of both planes of a two-hidden-layer model
    from sig_proj (2, S, H1) f32: returns y (2, S, num_tx, C) in
    out_dtype (float32, or bfloat16: the float32 result rounded),
    rx-major. CUDA: the fused tail kernel on bf16 weights (a float32
    model takes the per-head rows: fused_factored_planes routes it),
    which reads W2 and W3 K-major from ``prepared["w2t"]`` and
    ``prepared["w3t"]`` (required there); h (64 rows × H1 in shared
    memory, so H1 <= 1024) and h2 stay on chip. CPU: the plain version."""
    if factored_depth(prepared) != 2:
        raise ValueError(f"factored_tail is the fused tail of 2 hidden "
                         f"layers, got {factored_depth(prepared)}: "
                         f"fused_factored_planes routes other depths")
    _check_out_dtype(out_dtype)
    keys = ("hb", "a1", "c1", "w2", "b2", "a2", "c2", "w3", "b3")
    if not on_cuda(sig_proj, *(prepared[k] for k in keys)):
        return _tail_plain(prepared, sig_proj, C, out_dtype)
    p = {k: prepared[k].contiguous() for k in keys}
    sig_proj = sig_proj.contiguous()
    _, s, h1 = sig_proj.shape
    nt = p["hb"].shape[1]
    h2 = prepared["w2"].shape[2]
    if prepared["w2"].dtype != torch.bfloat16 or sig_proj.dtype != \
            torch.float32:
        raise TypeError("factored_tail takes f32 sig_proj and bf16 weights "
                        "(float32 weights run through factored_heads and "
                        "factored_rows_tail)")
    if h1 % 128 or h2 % 128 or h1 > _MAX_RESIDENT or C > _TAIL_OP \
            or tuple(p["hb"].shape) != (2, nt, h1):
        raise ValueError(f"factored_tail needs hidden widths % 128 == 0, "
                         f"H1 <= {_MAX_RESIDENT} and C <= {_TAIL_OP}, got "
                         f"H1={h1}, H2={h2}, C={C} (fused_factored_planes "
                         f"serves wider layers through factored_heads and "
                         f"factored_rows_tail)")
    for key, shape in (("w2t", (2, h2, h1)), ("w3t", (2, _TAIL_OP, h2))):
        p[key] = kmajor_weight(prepared, key, shape, "factored_tail")
    out = torch.empty((2, s, nt, C), dtype=out_dtype,
                      device=sig_proj.device)
    if s == 0:
        return out
    mode = _MODE_BF16_OUT * (out_dtype == _BF16)
    lib = _ff_lib()
    with torch.cuda.device(sig_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_tail_launch(
            sig_proj.data_ptr(), *(p[k].data_ptr() for k in _TAIL_ARGS),
            out.data_ptr(), s, nt, h1, h2, C, p["b3"].shape[-1], mode,
            stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_tail")
    factored_tail.launches += 1
    return out


factored_tail.launches = 0


def factored_heads(prepared, sig_proj: torch.Tensor) -> torch.Tensor:
    """The per-head rows of layer 1 for the models the fused tail does not
    take (a depth other than 2, H1 above 1024, or float32 weights): h =
    relu(sig_proj[s] + hb[t])·a1 + c1 as (2, S·num_tx, H1) rows (row
    s·num_tx + t) in the weights' dtype. CUDA: an elementwise kernel
    writing bf16 rows, or float32 rows for float32 weights. CPU: the
    plain version."""
    keys = ("hb", "a1", "c1")
    if not on_cuda(sig_proj, *(prepared[k] for k in keys)):
        h = _heads_plain(prepared, sig_proj)
        return h.reshape(2, -1, h.shape[-1]).to(prepared["w1"].dtype)
    mode = _mode_of(prepared["w1"].dtype, "factored_heads")
    sig_proj = sig_proj.contiguous()
    _, s, h1 = sig_proj.shape
    p = {k: prepared[k].contiguous() for k in keys}
    nt = p["hb"].shape[1]
    if sig_proj.dtype != torch.float32 or h1 % 8 \
            or tuple(p["hb"].shape) != (2, nt, h1):
        raise ValueError(f"factored_heads needs f32 sig_proj (2, S, H1) "
                         f"and hb (2, nt, H1), H1 % 8 == 0; got "
                         f"{tuple(sig_proj.shape)} {sig_proj.dtype}, "
                         f"{tuple(p['hb'].shape)}")
    out = torch.empty((2, s * nt, h1), dtype=prepared["w1"].dtype,
                      device=sig_proj.device)
    if s == 0:
        return out
    lib = _ff_lib()
    with torch.cuda.device(sig_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_heads_launch(
            sig_proj.data_ptr(), *(p[k].data_ptr() for k in keys),
            out.data_ptr(), s, nt, h1, mode, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_heads")
    count_launch(factored_heads, mode & _MODE_F32)
    return out


factored_heads.launches = factored_heads.launches_f32 = 0


def factored_dense(prepared, k: int, h: torch.Tensor, C: int | None = None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Layer k of both planes on rows h (2, M, H{k-1}): a hidden layer
    (k <= depth) → relu(h @ wk + bk)·ak + ck rows (2, M, Hk) in the
    weights' dtype; the output layer (k = depth + 1) → (h @ wk + bk)[...,
    :C] (2, M, C) in out_dtype (float32, or bfloat16: the float32 result
    rounded). CUDA: a Hopper GEMM kernel with that epilogue, reading wk
    K-major from ``prepared["wkt"]`` (float32: ``prepared["wkt_tf32"]``,
    its TF32 parts): bf16 rows and weights on the tails' GEMM
    (``csrc/mm_sm90.cuh``'s ``rows_gemm_kernel``: hidden rows staged and
    stored by TMA, the output layer in row pieces), float32 rows and
    weights on the 3xTF32 GEMM (``gemm_tf32x3``). CPU: the plain
    version."""
    out_layer = k == factored_depth(prepared) + 1
    if out_layer and C is None:
        raise ValueError("factored_dense needs C for the output layer")
    _check_out_dtype(out_dtype)
    keys = (f"w{k}", f"b{k}") + (() if out_layer else (f"a{k}", f"c{k}"))
    if not on_cuda(h, *(prepared[key] for key in keys)):
        if out_layer:
            return _out_plain(prepared, h, C, out_dtype)
        return _hidden_plain(prepared, k, h).to(prepared[f"w{k}"].dtype)
    w = prepared[f"w{k}"]
    mode = _mode_of(w.dtype, "factored_dense")
    _, m, kin = h.shape
    # the output's K-major weight has at least the tails' 256 rows
    n = max(w.shape[2], _TAIL_OP) if out_layer else w.shape[2]
    if h.dtype != w.dtype:
        raise TypeError(f"factored_dense takes rows of the weights' dtype "
                        f"({w.dtype}), got {h.dtype}")
    pitch = 4 if mode else 8
    if kin % pitch or w.shape[1] != kin:
        raise ValueError(f"factored_dense layer {k} needs rows of "
                         f"{w.shape[1]} (% {pitch} == 0), got "
                         f"{tuple(h.shape)}")
    wt = kmajor_weight(prepared, f"w{k}t_tf32", (2, 2, n, kin),
                       "factored_dense", _F32) if mode else \
        kmajor_weight(prepared, f"w{k}t", (2, n, kin), "factored_dense")
    b = prepared[f"b{k}"].contiguous()
    a, c = (b, b) if out_layer else \
        (prepared[f"a{k}"].contiguous(), prepared[f"c{k}"].contiguous())
    shape = (2, m, C) if out_layer else (2, m, n)
    out = torch.empty(shape, device=h.device,
                      dtype=out_dtype if out_layer else w.dtype)
    if m == 0:
        return out
    if out_layer and out_dtype == _BF16:
        mode |= _MODE_BF16_OUT
    h = tma_operand(h)
    lib = _ff_lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.factored_dense_launch(
            h.data_ptr(), wt.data_ptr(), b.data_ptr(), a.data_ptr(),
            c.data_ptr(), out.data_ptr(), m, n, kin, C or 0, b.shape[-1],
            int(out_layer), mode, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_dense")
    count_launch(factored_dense, mode & _MODE_F32)
    return out


factored_dense.launches = factored_dense.launches_f32 = 0


def factored_rows_tail(prepared, h: torch.Tensor, C: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The last hidden layer D and the output layer of both planes of a
    model of D >= 2 hidden layers, from rows h (2, M, H{D-1}): y (2, M,
    C) in out_dtype (float32, or bfloat16: the float32 result rounded).
    CUDA (``rows_tail_route``): bf16 rows run two GEMMs, the last hidden
    layer's rows through device memory (2, M, HD) bf16, then the output
    layer; float32 rows, the float32 mode, the fused float32 tail (the
    hidden activation on chip, rows streamed slab by slab); both read W
    K-major from ``prepared["wDt"]`` and the output's (float32: their
    TF32 parts, ``prepared["wDt_tf32"]`` and the output's). CPU: the
    plain version, whose chain (the hidden rows rounded to the weights'
    dtype for the output layer's product) both follow."""
    d = factored_depth(prepared)
    if d < 2:
        raise ValueError(f"factored_rows_tail serves 2 or more hidden "
                         f"layers, got {d}")
    _check_out_dtype(out_dtype)
    wk, ok = f"w{d}", f"w{d + 1}"
    keys = (wk, f"b{d}", f"a{d}", f"c{d}", ok, f"b{d + 1}")
    if not on_cuda(h, *(prepared[k] for k in keys)):
        return _out_plain(prepared, _hidden_plain(prepared, d, h), C,
                          out_dtype)
    dt = prepared[wk].dtype
    mode = _mode_of(dt, "factored_rows_tail")
    _, m, h1 = h.shape
    h2 = prepared[wk].shape[2]
    if h.dtype != dt or prepared[ok].dtype != dt:
        raise TypeError(f"factored_rows_tail takes rows and weights of one "
                        f"dtype, got rows {h.dtype}, weights {dt} and "
                        f"{prepared[ok].dtype}")
    if h1 % 128 or h2 % 128 or C > _TAIL_OP \
            or prepared[wk].shape[1] != h1:
        raise ValueError(f"factored_rows_tail needs rows of "
                         f"{prepared[wk].shape[1]}, widths % 128 == 0 and "
                         f"C <= {_TAIL_OP}; got {tuple(h.shape)}, C={C}")
    sfx, parts = ("t_tf32", (2,)) if mode else ("t", ())
    w2t = kmajor_weight(prepared, f"{wk}{sfx}", (2, *parts, h2, h1),
                        "factored_rows_tail", dt)
    w3t = kmajor_weight(prepared, f"{ok}{sfx}", (2, *parts, _TAIL_OP, h2),
                        "factored_rows_tail", dt)
    vec = [prepared[k].contiguous()
           for k in (f"b{d}", f"a{d}", f"c{d}", f"b{d + 1}")]
    out = torch.empty((2, m, C), dtype=out_dtype, device=h.device)
    if m == 0:
        return out
    mode |= _MODE_BF16_OUT * (out_dtype == _BF16)
    h = tma_operand(h)
    lib = _ff_lib()
    ptrs = [h.data_ptr(), w2t.data_ptr(), *(v.data_ptr() for v in vec[:3]),
            w3t.data_ptr(), vec[3].data_ptr(), out.data_ptr()]
    gemms = rows_tail_route(dt) == "gemms"
    hw = torch.empty((2, m, h2), dtype=dt, device=h.device) if gemms \
        else None
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        if gemms:
            rc = lib.factored_rows_gemms_launch(
                *ptrs, hw.data_ptr(), m, h1, h2, C, vec[3].shape[-1], mode,
                stream)
        else:
            rc = lib.factored_rows_tail_launch(
                *ptrs, m, h1, h2, C, vec[3].shape[-1], mode, stream)
    _build.check(rc, lib, "fused_factored_error_string", "factored_rows_tail")
    count_launch(factored_rows_tail, mode & _MODE_F32)
    factored_rows_tail.launches_gemms += gemms
    return out


# launches of the tail, and of those the float32 mode's and the two-GEMM
# route's
factored_rows_tail.launches = factored_rows_tail.launches_f32 = 0
factored_rows_tail.launches_gemms = 0


def rows_tail_route(dtype) -> str:
    """Which kernels run ``factored_rows_tail`` on the card for rows in
    ``dtype``: "gemms" for bf16 (the last hidden layer and the output
    layer as two GEMMs, ``csrc/mm_sm90.cuh``, the hidden rows through
    device memory; a fused bf16 tail with the hidden activation on chip
    took 1.5-2.0x as long on an H100 at every width served, PERF.md),
    "fused" for float32 (``layers23_f32``, 3xTF32)."""
    return "gemms" if dtype == _BF16 else "fused"


def fused_factored_planes(cfg: SimConfig, tcfg: TrainConfig, prepared,
                          planes: torch.Tensor, *, block_s: int = 128,
                          block_k: int = 1024, dot_dtype=None,
                          out_dtype=torch.float32,
                          interpret=None) -> torch.Tensor:
    """The fused factored all-pairs inference on both planes, at any depth.

    Args:
      prepared: from prepare_factored_weights; its dtype is the products'
        (bf16, or float32: the float32 mode).
      planes: (2, S, len_ltf), S = batch·num_rx rx-major; on CUDA in the
        weights' dtype.
      dot_dtype: JAX's keyword; it must equal the prepared weights'
        dtype (None: the prepared weights' dtype), else ValueError.
      out_dtype: float32 (the default: the port's callers take float32)
        or bfloat16 (JAX's default: the float32 result rounded to
        nearest even).
      block_s, block_k, interpret: accepted for the JAX signature and
        ignored (the CUDA kernels pick their own tiling).

    Returns:
      (2, S, num_tx, num_carriers) out_dtype — rx-major, the layout of
      ``_factored_all_pairs``. The TPU kernel returns head-major (2,
      num_tx, S, C); this layout needs no transpose before the serving
      call's output.

    bf16 weights of two hidden layers of at most 1024 units in the first:
    ``factored_sig_proj`` and the fused ``factored_tail``. Any other
    model, and every float32 model, depth D: ``factored_sig_proj``,
    ``factored_heads``, ``factored_dense`` for layers 2 .. D-1, then
    ``factored_rows_tail`` (or at D = 1 ``factored_dense`` of the
    output).
    """
    del block_s, block_k, interpret
    require_full_input(tcfg)
    w_dtype = prepared["w1"].dtype
    if dot_dtype is not None and dot_dtype != w_dtype:
        raise ValueError(f"dot_dtype {dot_dtype} differs from the prepared "
                         f"weights' {w_dtype} (prepare_factored_weights' "
                         f"dot_dtype)")
    _check_out_dtype(out_dtype)
    C, d = cfg.num_carriers, factored_depth(prepared)
    sig_proj = factored_sig_proj(
        planes, prepared["w1"],
        prepared.get("w1t_tf32" if w_dtype == _F32 else "w1t"))
    if d == 2 and sig_proj.shape[2] <= _MAX_RESIDENT and w_dtype == _BF16:
        return factored_tail(prepared, sig_proj, C, out_dtype)
    s = sig_proj.shape[1]
    h = factored_heads(prepared, sig_proj)
    for k in range(2, d):
        h = factored_dense(prepared, k, h)
    y = factored_dense(prepared, 2, h, C, out_dtype) if d == 1 \
        else factored_rows_tail(prepared, h, C, out_dtype)
    return y.reshape(2, s, cfg.num_tx, C)


def predict_all_pairs_planes_kernel(cfg: SimConfig, tcfg: TrainConfig,
                                    prepared, rx_planes: torch.Tensor, **kw):
    """All-pairs DNN CSI from rx-major planes (2, B, num_rx, len_ltf)
    through the fused kernels (``kw``: fused_factored_planes' keywords).
    Returns (B, num_rx, num_tx, num_carriers) complex64. On CUDA the
    planes are taken in the weights' dtype (float32 planes stay as they
    are for float32 weights)."""
    _, b, nrx, L = rx_planes.shape
    x = rx_planes.reshape(2, b * nrx, L)
    if x.is_cuda:
        x = x.to(prepared["w1"].dtype)
    y = fused_factored_planes(cfg, tcfg, prepared, x, **kw).float()
    return torch.complex(y[0], y[1]).reshape(b, nrx, cfg.num_tx,
                                             cfg.num_carriers)


def _ff_lib(defines=()) -> ctypes.CDLL:
    lib = _build.library("fused_factored", defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("factored_sig_proj_launch", [ptr] * 3 + [i32] * 4 + [ptr, i32]),
            ("factored_tail_launch", [ptr] * 11 + [i32] * 7),
            ("factored_heads_launch", [ptr] * 5 + [i32] * 4),
            ("factored_dense_launch", [ptr] * 6 + [i32] * 7),
            ("factored_rows_tail_launch", [ptr] * 8 + [i32] * 6),
            ("factored_rows_gemms_launch", [ptr] * 9 + [i32] * 6)):
        f = getattr(lib, name)
        f.restype = ctypes.c_int
        f.argtypes = args + [ptr]
    return lib
