"""LS estimate: wrappers of the hand-written CUDA kernels
``csrc/ls_v2.cu``, ``csrc/ls_v1.cu`` (the v2 and v1 flat-planes kernels of
``mamimo_tpu/ops/pallas/fused_ls.py``) and ``csrc/ls_pair.cu`` (its
per-pair ``ls_estimate_pallas``). The three compute one GEMM and
Walsh–Hadamard despread on the Hopper body ``csrc/ls_sm90.cuh`` and
differ in the output form; all take the K-major constants of
``ls_sm90_constants`` (``LsSm90Constants``) and refuse any other kind.
The input's dtype picks the kernels' mode, as it picks the TPU kernels'
product type: bfloat16 planes run the bf16 product (bf16 constants),
float32 planes (complex64 rx for the per-pair kernel) the float32 mode,
the same product at float32 accuracy from three TF32 products
(``ls_sm90_constants(cfg, device, torch.float32)``: the constants split
into TF32 high and low parts). No wrapper casts float32 input to bf16.

Above 256 symbols a sample (``PARTS_MIN_LOC``) each first launches the
part transform ``ls_parts`` (``csrc/ls_parts.cu``: the Walsh–Hadamard
transform over the sample's 128-symbol parts, the cyclic prefix dropped)
and the LS kernel reads its output, one part a tile.

On a CUDA tensor ``ls_planes_v2``, ``ls_planes_v1`` and
``ls_estimate_pallas`` launch their kernel; on a CPU tensor they run the
kernel's plain version (``_ls_v2_plain`` on
``ops/estimate.py::ls_estimate_planes``, ``_ls_v1_plain``,
``ops/estimate.py::ls_estimate_matmul``). ``ls_planes_v2(seq_shard=(i,
n))`` is the v2 kernel's sequence-sharded mode: rank i's partial
despread of its own symbols; its ``out_dtype=torch.bfloat16`` and
``with_ssq`` are the TPU kernel's bf16 store and per-tile sums of h²
(the headline bench path's), compile-time variants of the same kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig
from mamimo_tpu_torch.ops.estimate import (
    dft_selected_padded_np,
    ls_estimate_matmul,
    ls_estimate_planes,
    ls_planes_constants,
)
from mamimo_tpu_torch.ops.kernels import _build
from mamimo_tpu_torch.ops.kernels.util import (  # noqa: F401
    _round_up,
    on_cuda,
    tf32_split,
    tma_operand,
)
from mamimo_tpu_torch.ops.ltf import _hadamard_np

def ls_planes_pallas_constants(cfg: SimConfig, block_samples: int = 8,
                               dtype=torch.float32, device=None):
    """The TPU v1 kernel's constants (At_r, At_i, K): At =
    dft_selected_padded_np(cfg).T as real planes (sym_len, Cp), the CP
    drop as zero rows and the carriers padded to Cp = round_up(
    num_carriers, 128); K = I_block ⊗ P. The CUDA kernels' DFT matrix is
    derived from them (``ls_kernel_constants``)."""
    at = dft_selected_padded_np(cfg).T                 # (sym_len, C)
    cp_ = _round_up(cfg.num_carriers, 128)
    atp = np.zeros((cfg.sym_len, cp_), np.complex64)
    atp[:, :cfg.num_carriers] = at
    k = np.kron(np.eye(block_samples, dtype=np.float32),
                _hadamard_np(cfg.num_tx).astype(np.float32))
    return tuple(torch.as_tensor(a, device=device).to(dtype)
                 for a in (np.real(atp).copy(), np.imag(atp).copy(), k))


def ls_planes_pallas_v2_constants(cfg: SimConfig, block_samples: int = 8,
                                  dtype=torch.float32, device=None):
    """The TPU v2 kernel's constants (B, K): B = [At_r | At_i] of shape
    (sym_len, 2·Cp), K = I_block ⊗ P, from ls_planes_pallas_constants."""
    at_r, at_i, k = ls_planes_pallas_constants(cfg, block_samples,
                                               device=device)
    return torch.cat([at_r, at_i], 1).to(dtype), k.to(dtype)


def ls_raw_to_complex(cfg: SimConfig, hr: torch.Tensor, hi: torch.Tensor,
                      s: int) -> torch.Tensor:
    """Densify the raw padded (hr, hi) planes, each (rows, Cp), to
    (S, num_tx, num_carriers) complex64 rx-major."""
    nsym, c = cfg.num_tx, cfg.num_carriers
    hr = hr[: s * nsym, :c].reshape(s, nsym, c).float()
    hi = hi[: s * nsym, :c].reshape(s, nsym, c).float()
    return torch.complex(hr, hi)


def ls_v2_to_complex(cfg: SimConfig, h: torch.Tensor, s: int) -> torch.Tensor:
    """Densify the TPU v2 kernel's (rows, 2·Cp) output to (S, num_tx,
    num_carriers) complex64 rx-major."""
    cp_ = h.shape[1] // 2
    return ls_raw_to_complex(cfg, h[:, :cp_], h[:, cp_:], s)


def ls_kernel_constants(cfg: SimConfig, device=None,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """The DFT-select matrix in real form, (2·fft, 2·Cp) in ``dtype``
    (bfloat16 or float32): [[Ar, Ai], [-Ai, Ar]], rows over the fft
    samples only (the kernels skip the CP by coordinate), so that
    [xr | xi] @ it = [zr | zi]. No kernel takes it: it is the source of
    ``ls_sm90_constants``, the kernels' layout."""
    b, _ = ls_planes_pallas_v2_constants(cfg, 1)
    cp_ = b.shape[1] // 2
    top = b[cfg.cp_length:]                            # xr rows: [Ar | Ai]
    bot = torch.cat([-top[:, cp_:], top[:, :cp_]], 1)  # xi rows: [-Ai | Ar]
    return torch.cat([top, bot]).to(device=device, dtype=dtype)


def ls_sm90_row_order(cpad: int) -> np.ndarray:
    """The row order of the Hopper LS kernels' constants: row p of
    ``ls_sm90_constants`` is row ``order[p]`` of Bᵀ =
    ``ls_kernel_constants(cfg).T`` (rows g < cpad: the real part of
    carrier g; cpad + g: its imaginary part). Slab q = rows 128q ..
    128q + 127 holds the real parts of carriers 64q .. 64q + 63, then
    their imaginary parts, so the block that owns a slab writes whole
    complex values."""
    if cpad % 64:
        raise ValueError(f"cpad must be a multiple of 64, got {cpad}")
    p = np.arange(2 * cpad)
    return (p // 128) * 64 + p % 64 + cpad * ((p % 128) // 64)


@dataclass(frozen=True)
class LsSm90Constants:
    """The constants of the Hopper LS kernels (``csrc/ls_sm90.cuh``):
    ``bt`` Bᵀ K-major with its rows in ``ls_sm90_row_order``, (2·Cp,
    2·fft) bfloat16 for bf16 input, or for float32 input (2, 2·Cp,
    2·fft) float32, its TF32 high and low parts (``tf32_split``). A type
    of its own, so that the (2·fft, 2·Cp) matrix of
    ``ls_kernel_constants`` (the same shape at BS32) never reaches a
    kernel."""

    bt: torch.Tensor

    def to(self, device) -> "LsSm90Constants":
        return LsSm90Constants(self.bt.to(device))


def ls_sm90_constants(cfg: SimConfig, device=None,
                      dtype=torch.bfloat16) -> LsSm90Constants:
    """The constants of the LS kernels (``ls_planes_v2``,
    ``ls_planes_v1``, ``ls_pair_kernel``) on CUDA for input of ``dtype``:
    ``ls_kernel_constants(cfg)`` transposed to K-major and its rows
    permuted by ``ls_sm90_row_order``, in bfloat16, or for float32 input
    the float32 matrix split into its TF32 high and low parts (2, 2·Cp,
    2·fft); made once per caller."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the LS kernels take bfloat16 or float32 input, "
                        f"got {dtype}")
    b = ls_kernel_constants(cfg, dtype=dtype)
    order = torch.from_numpy(ls_sm90_row_order(b.shape[1] // 2))
    bt = b.T[order].contiguous()
    if dtype == torch.float32:
        bt = tf32_split(bt)
    return LsSm90Constants(bt.to(device))


def _sm90_consts(cfg: SimConfig, consts, device, dtype, who: str
                 ) -> LsSm90Constants:
    """consts, or ``ls_sm90_constants`` for input of ``dtype`` built now
    when it is None; raises TypeError for any other kind of constants."""
    if consts is None:
        return ls_sm90_constants(cfg, device, dtype)
    if not isinstance(consts, LsSm90Constants):
        raise TypeError(f"{who} takes ls_sm90_constants(cfg, device, dtype) "
                        f"(Bᵀ, K-major, rows permuted), got "
                        f"{type(consts).__name__}; no kernel reads the "
                        f"(2·fft, 2·Cp) matrix of ls_kernel_constants")
    return consts


# the most Tx antennas the LS kernels take: 16 parts of 128 symbols a
# sample (csrc/ls_parts.cu, the part transform)
MAX_KERNEL_TX = 2048
# from this many symbols a sample the LS kernels read the part transform's
# output (ls_parts), one 128-symbol part a tile
PARTS_MIN_LOC = 512


def symbol_group(sym_len: int, esize: int) -> int:
    """The symbols one row of the LS kernels' input map spans
    (``ls90::group_log``): the least power of 2, g, with g·sym_len·esize a
    multiple of 16 bytes, TMA's rule for a stride. 1 where a symbol is
    aligned by itself (bf16 at a cyclic prefix that is a multiple of 8);
    at most 8 for bf16 and 4 for float32 (NR's 18-sample prefix at a
    256-point FFT: 4 and 2)."""
    g = 1
    while (g * sym_len * esize) % 16:
        g *= 2
    return g


def _check_kernel_shapes(cfg: SimConfig, planes: torch.Tensor,
                         consts: LsSm90Constants,
                         nsym_in: int | None = None) -> None:
    """Raise unless the LS kernels take these operands: bfloat16 or
    float32 planes of ``nsym_in`` symbols per sample (default num_tx, the
    whole preamble) and the constants of ``ls_sm90_constants`` for that
    dtype. num_tx a power of 2 up to MAX_KERNEL_TX; any cp_length where
    the planes hold at least ``symbol_group`` symbols a sample (always at
    8 or more: a row of 8 symbols is 16-byte aligned)."""
    nt = cfg.num_tx
    length = (nsym_in or nt) * cfg.sym_len
    mat = consts.bt
    if planes.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the LS kernels take bfloat16 or float32 planes, "
                        f"got {planes.dtype}")
    if mat.dtype != planes.dtype:
        raise TypeError(f"{str(planes.dtype)[6:]} planes take "
                        f"ls_sm90_constants(cfg, device, {planes.dtype}), "
                        f"got {str(mat.dtype)[6:]} constants")
    if planes.dim() != 3 or planes.shape[0] != 2 \
            or planes.shape[2] != length:
        raise ValueError(f"planes must be (2, S, {length}), "
                         f"got {tuple(planes.shape)}")
    if mat.device != planes.device:
        raise ValueError(f"constants on {mat.device}, planes on "
                         f"{planes.device}")
    cp_, fft = _round_up(cfg.num_carriers, 128), cfg.fft_length
    want = (2 * cp_, 2 * fft)
    if mat.dtype == torch.float32:
        want = (2,) + want                             # TF32 hi and lo
    if tuple(mat.shape) != want:
        raise ValueError(f"kernel constants must be {want}, got "
                         f"{tuple(mat.shape)}")
    if nt > MAX_KERNEL_TX or nt & (nt - 1):
        raise ValueError(f"the LS kernels need num_tx a power of 2 <= "
                         f"{MAX_KERNEL_TX}, got num_tx={nt}")
    loc = nsym_in or nt
    g = symbol_group(cfg.sym_len, planes.element_size())
    if loc < g:
        raise ValueError(
            f"the LS kernels read {g} symbols of {cfg.sym_len} "
            f"{str(planes.dtype)[6:]} samples as one 16-byte aligned row "
            f"(cp_length={cfg.cp_length}), so they need at least {g} "
            f"symbols a sample, got {loc}")
    if fft % 64 or fft > 256 or cp_ not in (128, 256, 512):
        raise ValueError("the Hopper LS kernels need fft_length a multiple "
                         "of 64 up to 256 and at most 512 padded carriers")


def _ls_parts_plain(cfg: SimConfig, planes: torch.Tensor,
                    loc: int) -> torch.Tensor:
    """Plain version of the part transform: Z_p = Σ_v H_nl[p, v]·Y_v in
    float32, each term added or subtracted in the order v = 0 … nl − 1
    from a zero start (the kernel's operations), rounded once to the
    planes' dtype."""
    s, nl, fft = planes.shape[1], loc // 128, cfg.fft_length
    y = planes.view(2, s, nl, 128, cfg.sym_len)[
        ..., cfg.cp_length:cfg.cp_length + fft].float()
    sign = torch.from_numpy(_hadamard_np(nl).astype(np.float32)).to(
        planes.device)
    z = torch.zeros((2, s, nl, 128, fft), device=planes.device)
    for v in range(nl):
        z = z + sign[:, v].view(1, 1, nl, 1, 1) * y[:, :, v:v + 1]
    return z.to(planes.dtype).view(2, s, loc * fft)


def ls_parts(cfg: SimConfig, planes: torch.Tensor,
             loc: int | None = None) -> torch.Tensor:
    """The LS kernels' part transform (``csrc/ls_parts.cu``): planes (2,
    S, loc·sym_len) of loc = 128·nl symbols a sample (default num_tx; a
    seq rank's loc), bfloat16 or float32, → Z (2, S, loc·fft) of the same
    dtype: for each sample and symbol row m, Z_p[m] = Σ_v H_nl[p, v]·
    Y_v[m], Y_v[m] the fft samples of symbol v·128 + m (the cyclic prefix
    dropped), summed in float32 and rounded once. The LS kernels read Z at
    loc >= PARTS_MIN_LOC, one part a tile (P_loc = H_nl ⊗ H_128). CUDA:
    the kernel (loc 512 … 2048), counted in ``ls_parts.launches``; CPU:
    the plain version, bit for bit the kernel's."""
    loc = loc or cfg.num_tx
    if loc % 128 or loc & (loc - 1) or planes.dim() != 3 \
            or planes.shape[0] != 2 or planes.shape[2] != loc * cfg.sym_len:
        raise ValueError(f"ls_parts needs planes (2, S, loc·sym_len) with "
                         f"loc a power of 2 >= 128, got loc={loc}, "
                         f"{tuple(planes.shape)}")
    if planes.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ls_parts takes bfloat16 or float32 planes, got "
                        f"{planes.dtype}")
    if not on_cuda(planes):
        return _ls_parts_plain(cfg, planes, loc)
    if not PARTS_MIN_LOC <= loc <= MAX_KERNEL_TX \
            or cfg.fft_length % 64:
        raise ValueError(f"the part transform kernel takes {PARTS_MIN_LOC} "
                         f"to {MAX_KERNEL_TX} symbols a sample and "
                         f"fft_length % 64 == 0, got loc={loc}, "
                         f"fft_length={cfg.fft_length}")
    planes = tma_operand(planes)
    s = planes.shape[1]
    z = torch.empty((2, s, loc * cfg.fft_length), dtype=planes.dtype,
                    device=planes.device)
    if s == 0:
        return z
    lib = _ls_parts_lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ls_parts_launch(planes.data_ptr(), z.data_ptr(), s, loc,
                                 cfg.sym_len, cfg.cp_length, cfg.fft_length,
                                 int(planes.dtype == torch.float32), stream)
    _build.check(rc, lib, "ls_parts_error_string", "ls_parts")
    ls_parts.launches += 1
    return z


ls_parts.launches = 0


def _ls_parts_lib() -> ctypes.CDLL:
    lib = _build.library("ls_parts")
    fn = lib.ls_parts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    return lib


def _kernel_input(cfg: SimConfig, planes: torch.Tensor, loc: int):
    """What an LS kernel reads for planes of loc symbols a sample: at loc
    >= PARTS_MIN_LOC the part transform's Z (symbols of fft samples, no
    cyclic prefix) and the mode bit ``parts``; below, the planes as they
    are. Returns (input, sym_len, cp_length, parts)."""
    if loc >= PARTS_MIN_LOC:
        return ls_parts(cfg, planes, loc), cfg.fft_length, 0, 1
    return planes, cfg.sym_len, cfg.cp_length, 0


def seq_shard_symbols(cfg: SimConfig, seq_shard) -> int:
    """loc = num_tx / n, the symbols per sample of rank i of n in a
    sequence-sharded preamble; raises unless 0 <= i < n, n a power of 2
    dividing num_tx. On the card the LS kernels also need loc >=
    ``symbol_group`` of the planes (``_check_kernel_shapes``); above 128
    symbols a rank's tiles are loc/128 parts of a sample."""
    i, n = seq_shard
    if n < 1 or n & (n - 1) or cfg.num_tx % n or not 0 <= i < n:
        raise ValueError(f"seq_shard {seq_shard}: need rank 0 <= i < n, n "
                         f"a power of 2 dividing num_tx={cfg.num_tx}")
    return cfg.num_tx // n


def ls_v2_tiles(s: int, loc: int) -> int:
    """The v2 kernel's tiles of S samples of loc symbols, 128 GEMM rows
    each (``ls90::tiles``), the rows of its ``with_ssq`` sums: 128/loc
    samples a tile up to loc = 128, and above it loc/128 tiles a sample,
    tile p its symbols p·128 .. p·128 + 127."""
    return -(-s * loc // 128)


def _ssq_plain(h: torch.Tensor, loc: int) -> torch.Tensor:
    """Per-tile sums of h² of the dense (2, S, nt, C) float32 planes:
    (tiles, 2, C), row t the column sums over tile t's stored rows. Up to
    loc = 128 the (sample, row) pairs in order, taken 128·nt/loc at a time
    (128/loc samples a tile); above it, tile s·nh + p (nh = loc/128) sums
    rows a·loc + p·128 .. + 127 of sample s over the nt/loc copies a of a
    seq rank's partial."""
    _, s, nt, c = h.shape
    if loc > 128:
        nh = loc // 128
        q = (h * h).view(2, s, nt // loc, nh, 128, c).sum((2, 4))
        return q.reshape(2, s * nh, c).transpose(0, 1).contiguous()
    n, rows = ls_v2_tiles(s, loc), 128 * nt // loc
    hp = torch.zeros((2, n * rows, c), dtype=h.dtype, device=h.device)
    hp[:, :s * nt] = h.reshape(2, s * nt, c)
    return (hp * hp).view(2, n, rows, c).sum(2).transpose(0, 1) \
        .contiguous()


def _ls_v2_plain(cfg: SimConfig, planes: torch.Tensor, seq_shard=None,
                 out_dtype=torch.float32, with_ssq: bool = False):
    """Plain version of the v2 kernel: the float32 LS, or with
    ``seq_shard`` = (i, n) the float32 DFT-select of rank i's symbols
    despread with P[:, i·loc:(i+1)·loc]; stored in ``out_dtype``, and
    with ``with_ssq`` also the per-tile sums of h² of the float32 values
    (``_ssq_plain``)."""
    at_r, at_i, p = ls_planes_constants(cfg, device=planes.device)
    loc = cfg.num_tx
    if seq_shard is not None:
        loc = seq_shard_symbols(cfg, seq_shard)
        p = p[:, seq_shard[0] * loc:(seq_shard[0] + 1) * loc]
    h = ls_estimate_planes(cfg, planes.float(), (at_r, at_i, p))
    h = torch.stack([h.real, h.imag])
    if not with_ssq:
        return h.to(out_dtype)
    return h.to(out_dtype), _ssq_plain(h, loc)


def ls_planes_v2(cfg: SimConfig, planes: torch.Tensor,
                 consts: LsSm90Constants | None = None, *,
                 seq_shard: tuple[int, int] | None = None,
                 out_dtype=torch.float32, with_ssq: bool = False):
    """LS estimate of every (sample, tx, carrier) from flat planes.

    Args:
      planes: (2, S, len_ltf), float32 or bfloat16; the dtype picks the
        kernel's mode: bfloat16 the bf16 product, float32 the float32
        mode (float32 accuracy, no cast to bf16). With ``seq_shard``,
        rank i's contiguous symbols (2, S, loc·sym_len), loc = num_tx /
        n.
      consts: CUDA only, ``ls_sm90_constants(cfg, device, planes.dtype)``
        (any other kind, or another dtype's, raises TypeError); built
        per call when omitted.
      seq_shard: (i, n) — return rank i of n's PARTIAL despread of its
        symbols (the rectangular K of the TPU kernel's sequence mode);
        the sum of the n partials is the estimate.
      out_dtype: float32 (default) or bfloat16, the estimate's storage.
      with_ssq: also return the sums of h² per tile (the TPU kernel's
        benchmark checksum), taken from the float32 values before any
        bf16 rounding.

    Returns:
      h, (2, S, num_tx, num_carriers) planes in ``out_dtype`` ([0]=real,
      [1]=imag), dense (no padding), rx-major; with ``with_ssq`` the
      pair (h, ssq), ssq (ls_v2_tiles(S, loc), 2, num_carriers) float32:
      row t holds, per plane, the column sums of h² over the rows of
      tile t's 128/loc samples, or at loc = 128·nh (nh = 2 … 8) over
      rows p·128 .. + 127, p = t % nh, of sample t // nh (a seq rank's
      partial counts each of its n stored copies, ``_ssq_plain``). The
      TPU kernel's (n_blocks, 8, 2·Cp) layout, which sums to 8·Σh², is
      not copied.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    loc, rank = cfg.num_tx, 0
    if seq_shard is not None:
        loc, rank = seq_shard_symbols(cfg, seq_shard), seq_shard[0]
    if planes.dim() != 3 or planes.shape[2] != loc * cfg.sym_len:
        raise ValueError(f"planes must be (2, S, {loc * cfg.sym_len}), "
                         f"got {tuple(planes.shape)}")
    if not on_cuda(planes):
        return _ls_v2_plain(cfg, planes, seq_shard, out_dtype, with_ssq)
    consts = _sm90_consts(cfg, consts, planes.device, planes.dtype,
                          "ls_planes_v2")
    planes = tma_operand(planes)
    _check_kernel_shapes(cfg, planes, consts, loc)
    s = planes.shape[1]
    out = torch.empty((2, s, cfg.num_tx, cfg.num_carriers),
                      dtype=out_dtype, device=planes.device)
    ssq = torch.empty((ls_v2_tiles(s, loc), 2, cfg.num_carriers),
                      dtype=torch.float32, device=planes.device) \
        if with_ssq else None
    result = (out, ssq) if with_ssq else out
    if s == 0:
        return result
    x, sym_len, cp, parts = _kernel_input(cfg, planes, loc)
    lib = _ls_lib()
    mode = int(out_dtype == torch.bfloat16) | 2 * int(with_ssq) \
        | 4 * int(planes.dtype == torch.float32) | 8 * parts
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ls_planes_v2_launch(
            x.data_ptr(), consts.bt.data_ptr(), out.data_ptr(),
            ssq.data_ptr() if with_ssq else None, s, cfg.num_tx, loc, rank,
            cfg.num_carriers, sym_len, cp, cfg.fft_length,
            consts.bt.shape[-2] // 2, mode, stream)
    _build.check(rc, lib, "ls_planes_v2_error_string", "ls_planes_v2")
    ls_planes_v2.launches += 1
    ls_planes_v2.launches_f32 += planes.dtype == torch.float32
    return result


# launches of the kernel, and of those the float32 mode's
ls_planes_v2.launches = ls_planes_v2.launches_f32 = 0


def _ls_lib() -> ctypes.CDLL:
    lib = _build.library("ls_v2")
    fn = lib.ls_planes_v2_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    return lib


# ----------------------------------------------------------------------
# v1: the raw padded (hr, hi) serving form
# ----------------------------------------------------------------------

def _ls_v1_plain(cfg: SimConfig, planes: torch.Tensor, block_samples: int,
                 out_dtype: torch.dtype):
    """Plain version of the v1 kernel: the float32 plain LS laid out as
    the kernel's raw planes, zero pad rows and lanes included."""
    h = ls_estimate_planes(cfg, planes.float())        # (S, nt, C)
    s, nt, c = h.shape
    raw = torch.zeros((2, _round_up(s, block_samples) * nt,
                       _round_up(c, 128)), device=planes.device)
    raw[0, :s * nt, :c] = h.real.reshape(s * nt, c)
    raw[1, :s * nt, :c] = h.imag.reshape(s * nt, c)
    return raw[0].to(out_dtype), raw[1].to(out_dtype)


def ls_planes_v1(cfg: SimConfig, planes: torch.Tensor,
                 consts: LsSm90Constants | None = None, *,
                 block_samples: int = 8, out_dtype=torch.float32):
    """The v1 kernel's raw output: (hr, hi), each (round_up(S,
    block_samples)·num_tx, Cp) in ``out_dtype`` (float32 or bfloat16),
    row s·num_tx + j, lane c; pad rows and pad lanes are zero.

    Args:
      planes: (2, S, len_ltf), bfloat16 (the bf16 product) or float32
        (the float32 mode).
      consts: CUDA only, ``ls_sm90_constants(cfg, device, planes.dtype)``
        (any other kind raises TypeError); built per call when omitted.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if not on_cuda(planes):
        return _ls_v1_plain(cfg, planes, block_samples, out_dtype)
    consts = _sm90_consts(cfg, consts, planes.device, planes.dtype,
                          "ls_planes_v1")
    planes = tma_operand(planes)
    _check_kernel_shapes(cfg, planes, consts)
    s = planes.shape[1]
    s_out = _round_up(s, block_samples)
    cp_ = consts.bt.shape[-2] // 2
    hr, hi = (torch.empty((s_out * cfg.num_tx, cp_), dtype=out_dtype,
                          device=planes.device) for _ in range(2))
    if s == 0:
        return hr, hi
    x, sym_len, cp, parts = _kernel_input(cfg, planes, cfg.num_tx)
    lib = _ls_v1_lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ls_planes_v1_launch(
            x.data_ptr(), consts.bt.data_ptr(), hr.data_ptr(),
            hi.data_ptr(), s, s_out, cfg.num_tx, sym_len, cp,
            cfg.fft_length, cp_, int(out_dtype == torch.bfloat16)
            | 2 * int(planes.dtype == torch.float32) | 4 * parts, stream)
    _build.check(rc, lib, "ls_planes_v1_error_string", "ls_planes_v1")
    ls_planes_v1.launches += 1
    ls_planes_v1.launches_f32 += planes.dtype == torch.float32
    return hr, hi


ls_planes_v1.launches = ls_planes_v1.launches_f32 = 0


def ls_planes_pallas(cfg: SimConfig, planes: torch.Tensor,
                     consts: LsSm90Constants | None = None, *,
                     block_samples: int = 8, raw: bool = False,
                     as_planes: bool = False, out_dtype=None):
    """LS estimation from flat canonical planes through the v1 kernel
    (the port of the JAX ``ls_planes_pallas``).

    Args:
      planes: (2, S, len_ltf), bfloat16 (the bf16 product) or float32
        (the float32 mode).
      consts: CUDA only, ``ls_sm90_constants(cfg, device, planes.dtype)``.
      raw: return the kernel's padded (hr, hi) untouched — the serving
        form (see ``ls_planes_v1``).
      as_planes: return the dense (2, S, num_tx, num_carriers) float32
        planes ([0] real, [1] imaginary) instead of complex (JAX's
        ``as_planes``).
      out_dtype: float32 (default) or bfloat16 storage of (hr, hi).

    Returns:
      (S, num_tx, num_carriers) complex64 rx-major, the planes, or the
      raw (hr, hi).
    """
    hr, hi = ls_planes_v1(cfg, planes, consts, block_samples=block_samples,
                          out_dtype=out_dtype or torch.float32)
    if raw:
        return hr, hi
    if as_planes:
        nt, c, s = cfg.num_tx, cfg.num_carriers, planes.shape[1]
        return torch.stack([h[:s * nt, :c].reshape(s, nt, c).float()
                            for h in (hr, hi)])
    return ls_raw_to_complex(cfg, hr, hi, planes.shape[1])


def _ls_v1_lib() -> ctypes.CDLL:
    lib = _build.library("ls_v1")
    fn = lib.ls_planes_v1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return lib


# ----------------------------------------------------------------------
# per-pair LS on time-major complex preambles
# ----------------------------------------------------------------------

def pair_planes(rx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Time-major complex rx (B, len_ltf, num_rx) as the per-pair
    kernel's planes (2, B·num_rx, len_ltf) in ``dtype`` (bfloat16 for
    the bf16 product, float32 for the float32 mode), sample b·num_rx +
    r: one strided read of rx, one write."""
    b, L, nrx = rx.shape
    out = torch.empty((2, b, nrx, L), dtype=dtype, device=rx.device)
    out.copy_(torch.view_as_real(rx).permute(3, 0, 2, 1))
    return out.view(2, b * nrx, L)


def ls_pair_kernel(cfg: SimConfig, planes: torch.Tensor, num_rx: int,
                   consts: LsSm90Constants | None = None) -> torch.Tensor:
    """Launch the per-pair LS kernel (CUDA only) on pair planes (2,
    B·num_rx, len_ltf) from ``pair_planes``, bfloat16 (the bf16 product)
    or float32 (the float32 mode), with the constants of
    ``ls_sm90_constants`` for that dtype (built per call when omitted;
    any other kind raises TypeError). Returns (B, C, num_tx, num_rx)
    complex64."""
    consts = _sm90_consts(cfg, consts, planes.device, planes.dtype,
                          "ls_pair_kernel")
    planes = tma_operand(planes)
    _check_kernel_shapes(cfg, planes, consts)
    s = planes.shape[1]
    if s % num_rx:
        raise ValueError(f"{s} rows are not whole packets of {num_rx}")
    out = torch.empty((s // num_rx, cfg.num_carriers, cfg.num_tx, num_rx),
                      dtype=torch.complex64, device=planes.device)
    if s == 0:
        return out
    x, sym_len, cp, parts = _kernel_input(cfg, planes, cfg.num_tx)
    lib = _ls_pair_lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ls_pair_launch(
            x.data_ptr(), consts.bt.data_ptr(), out.data_ptr(), s,
            num_rx, cfg.num_tx, cfg.num_carriers, sym_len, cp,
            cfg.fft_length, consts.bt.shape[-2] // 2,
            int(planes.dtype == torch.float32) | 2 * parts, stream)
    _build.check(rc, lib, "ls_pair_error_string", "ls_pair")
    ls_pair_kernel.launches += 1
    ls_pair_kernel.launches_f32 += planes.dtype == torch.float32
    return out


ls_pair_kernel.launches = ls_pair_kernel.launches_f32 = 0


def ls_estimate_pallas(cfg: SimConfig, rx: torch.Tensor, *,
                       pairs_per_block: int = 8, interpret=None,
                       consts: LsSm90Constants | None = None
                       ) -> torch.Tensor:
    """LS channel estimation from raw time-major preambles, per (packet,
    rx) pair (the port of the JAX ``ls_estimate_pallas``).

    Args:
      rx: (B, len_ltf, num_rx) complex64.
      pairs_per_block, interpret: accepted for the JAX signature and
        ignored (the CUDA kernel picks its own tiling).
      consts: CUDA only, ``ls_sm90_constants(cfg, device,
        torch.float32)``; built per call when omitted.

    Returns:
      (B, num_carriers, num_tx, num_rx) complex64.

    CUDA: one layout pass to float32 pair planes (``pair_planes``), then
    the kernel ``csrc/ls_pair.cu`` in its float32 mode, as JAX's kernel
    computes in float32. CPU: the float32 plain version,
    ``ls_estimate_matmul``.
    """
    del pairs_per_block, interpret
    if not on_cuda(rx):
        return ls_estimate_matmul(cfg, rx)
    if rx.dtype != torch.complex64:
        raise TypeError(f"ls_estimate_pallas takes complex64 rx, got "
                        f"{rx.dtype}")
    return ls_pair_kernel(cfg, pair_planes(rx, torch.float32), rx.shape[2],
                          consts)


def _ls_pair_lib() -> ctypes.CDLL:
    lib = _build.library("ls_pair")
    fn = lib.ls_pair_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    return lib
