"""Sharded compute over a mesh (the port of
``mamimo_tpu/parallel/sharded.py``): the inference forms and the DP+TP
training step.

* ``sharded_ls_estimate`` — the preamble's LTF symbols split over the
  ``seq`` ranks at symbol boundaries; each rank FFT-demodulates its
  symbols and despreads them with its columns of P (a partial), and one
  sum over the ranks completes the estimate;
* ``sharded_ls_pallas_v2`` — the LS kernel (kernel 1) per rank: samples
  split over ``data`` (no collective), or symbols over ``seq`` with the
  kernel's partial-despread mode and a sum over the ranks;
* ``sharded_predict_all_pairs`` — the DNN's pilot heads split over
  ``antenna``; no collective;
* ``sharded_estimate_combined`` — LS and DNN over one data × seq ×
  antenna mesh;
* ``param_shardings`` and ``make_sharded_train_step`` — one optimizer
  step of ``train/loop.py::make_batch_update`` over a data × model
  mesh: the batch split over ``data``, the hidden units over ``model``
  (layer 0 column-parallel, layer 1 row-parallel, alternating), the
  stacked real/imag axis and the output layer replicated.

Each rank's work runs on its device. Where the JAX package all-reduces
(``psum``) the port sums the ranks' partials in rank order
(``parallel/collectives.py``; across processes through the
``torch.distributed`` group); FFTs and products are PyTorch in full
float32 (TF32 off), as they are XLA in JAX. Outputs the JAX package
leaves sharded come back gathered on the mesh's first device; outputs it
replicates come back once, on that device. A sharded parameter is a
``ShardedTensor``: each rank's piece on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import (
    Bf16Dense,
    _bf16_product,
    factored_heads_apply,
    factored_plane_apply,
    plane,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (
    ls_planes_v2,
    ls_sm90_constants,
    seq_shard_symbols,
)
from mamimo_tpu_torch.ops.ltf import _hadamard_np, _ltf_np
from mamimo_tpu_torch.parallel.collectives import all_sum, exchange, \
    group_sum
from mamimo_tpu_torch.parallel.mesh import Mesh
from mamimo_tpu_torch.utils.numerics import full_f32_matmul


def _divide(total: int, n: int, what: str) -> int:
    if total % n:
        raise ValueError(f"{total} {what} do not divide over {n} ranks")
    return total // n


def _one_process(mesh: Mesh, what: str) -> None:
    """Refuse a mesh that spans processes where the form gathers its
    output from every rank onto one device."""
    if mesh.num_processes > 1:
        raise NotImplementedError(
            f"{what} gathers every rank's output on one device; on a mesh "
            f"that spans {mesh.num_processes} processes only the sums "
            f"(sharded_ls_estimate, sharded_ls_pallas_v2 'seq') and the "
            f"training step are supported")


def sum_onto(parts, device: torch.device, mesh: Mesh | None = None,
             ranks=None) -> torch.Tensor:
    """The all-reduce of the port: the sum of the ranks' partials on
    ``device``, in rank order, in a new tensor (the partials are left as
    they were).

    On a mesh that spans processes, pass it and the partials' flat
    ``ranks``: a process holds only its own ranks' partials (None for the
    others), which every process receives through the group
    (``collectives.exchange``) before adding the same partials in the same
    order, so every process gets the same bits."""
    if mesh is not None and mesh.num_processes > 1:
        everyone = exchange(mesh, {r: p for r, p in zip(ranks, parts)
                                   if p is not None})
        parts = [everyone[r] for r in ranks]
    if len(parts) == 1:
        return parts[0].to(device, copy=True)
    total = parts[0].to(device) + parts[1].to(device)
    for p in parts[2:]:
        total += p.to(device)
    return total


def _ls_partial_fft(cfg: SimConfig, rx_blk: torch.Tensor,
                    p_cols: torch.Tensor) -> torch.Tensor:
    """A rank's partial LS despread: rx_blk (B, loc·sym_len, R) holds loc
    whole symbols; FFT-demodulate them and contract with their columns
    p_cols (num_tx, loc) of P → (B, C, num_tx, R), not yet divided by
    nsym·ltf."""
    b, _, r = rx_blk.shape
    loc = p_cols.shape[1]
    x = rx_blk.reshape(b, loc, cfg.sym_len, r)[:, :, cfg.cp_length:, :]
    X = torch.fft.fftshift(torch.fft.fft(x, dim=2), dim=2)
    X = X[:, :, list(cfg.carrier_locations), :]              # (B, loc, C, R)
    return torch.einsum("bncr,jn->bcjr", X, p_cols.to(X.dtype))


def _ls_denominator(cfg: SimConfig, device) -> torch.Tensor:
    ltf = _ltf_np(cfg.fft_length)[np.asarray(cfg.carrier_locations)]
    return torch.as_tensor((cfg.num_tx * ltf).astype(np.float32),
                           device=device)


def sharded_ls_estimate(cfg: SimConfig, mesh: Mesh, rx,
                        axis: str = "seq") -> torch.Tensor:
    """LS channel estimation with the preamble split over OFDM symbols.

    Args:
      mesh: a mesh with ``axis`` (num_tx must divide over its size).
      rx: (B, len_ltf, num_rx) complex received preambles.

    Returns:
      (B, C, num_tx, num_rx) complex64 LS estimate (replicated in JAX),
      once, on the mesh's first device. On a mesh that spans processes
      (``axis`` its only axis) each process computes its ranks' partials
      and gets the sum on its first device.
    """
    ranks = mesh.axis_ranks(axis)
    loc = _divide(cfg.num_tx, len(ranks), "symbols")
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    rx = torch.as_tensor(rx).to(torch.complex64)
    l_loc = loc * cfg.sym_len
    parts = []
    with full_f32_matmul():
        for i, r in enumerate(ranks):
            dev = mesh.rank_device(r)
            parts.append(_ls_partial_fft(
                cfg, rx[:, i * l_loc:(i + 1) * l_loc].to(dev),
                p_full[:, i * loc:(i + 1) * loc].to(dev))
                if mesh.is_local(r) else None)
    total = sum_onto(parts, mesh.first, mesh, ranks)
    return total / _ls_denominator(cfg, mesh.first)[None, :, None, None]


def sharded_ls_pallas_v2(cfg: SimConfig, mesh: Mesh, planes,
                         mode: str = "data", data_axis: str = "data",
                         seq_axis: str = "seq",
                         consts: torch.Tensor | None = None) -> torch.Tensor:
    """The LS kernel (``ops/kernels/fused_ls.py::ls_planes_v2``, kernel 1)
    run per rank of a mesh.

    Args:
      planes: (2, S, len_ltf) canonical planes (S = B·num_rx), float32
        or bfloat16; each CUDA rank passes its share in that dtype, which
        picks the kernel's mode (``ls_planes_v2``: float32 planes run at
        float32 accuracy, as JAX's kernel on float32 planes).
      mode:
        'data' — S splits over ``data_axis``; each rank runs the kernel
          on its samples; no collective;
        'seq'  — the preamble's symbols split over ``seq_axis``; each
          rank runs the kernel's partial-despread mode on its symbols
          (``seq_shard=(i, n)``), and the partials are summed onto the
          first rank's device (the JAX package's psum).
      consts: CUDA ranks only, ``ls_sm90_constants(cfg, device,
        planes.dtype)`` on any device, copied to each rank's card; built
        per call when omitted (a host build that costs more than the
        kernels).

    Returns:
      (S, num_tx, num_carriers) complex64 rx-major, on the mesh's first
      device: 'data' gathered over the ranks (sharded on S in JAX),
      'seq' once (replicated in JAX).
    """
    _, s, _ = planes.shape
    if mode not in ("data", "seq"):
        raise ValueError(f"mode must be 'data' or 'seq', got {mode!r}")
    ranks = mesh.axis_ranks(data_axis if mode == "data" else seq_axis)
    devs = [mesh.rank_device(r) for r in ranks]
    cards = {dev for r, dev in zip(ranks, devs)
             if dev.type == "cuda" and mesh.is_local(r)}
    if cards and consts is None:
        consts = ls_sm90_constants(cfg, dtype=planes.dtype)
    per_card = {dev: consts.to(dev) for dev in cards}
    if mode == "data":
        _one_process(mesh, "sharded_ls_pallas_v2 'data'")
        s_loc = _divide(s, len(devs), "samples")
        hs = [ls_planes_v2(cfg, planes[:, i * s_loc:(i + 1) * s_loc].to(dev),
                           per_card.get(dev)).to(mesh.first)
              for i, dev in enumerate(devs)]
        h = torch.cat(hs, dim=1)
    else:
        n = len(devs)
        l_loc = seq_shard_symbols(cfg, (0, n)) * cfg.sym_len
        parts = [ls_planes_v2(cfg, planes[:, :, i * l_loc:(i + 1) * l_loc]
                              .to(dev), per_card.get(dev), seq_shard=(i, n))
                 if mesh.is_local(r) else None
                 for i, (r, dev) in enumerate(zip(ranks, devs))]
        h = sum_onto(parts, mesh.first, mesh, ranks)
    return torch.complex(h[0], h[1])


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b in float32, or of operands rounded to ``dtype`` with a
    float32 result (JAX's ``preferred_element_type=float32``)."""
    if dtype is None:
        return a @ b
    if dtype == torch.bfloat16:
        return _bf16_product(a.to(dtype), b.to(dtype))
    return (a.to(dtype) @ b.to(dtype)).float()


def sharded_predict_all_pairs(cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                              params, bn_state, rx, axis: str = "antenna",
                              dtype=None) -> torch.Tensor:
    """All-pairs DNN inference with the Tx-pilot heads split over
    ``axis``: rank i computes the pairs of its num_tx / n pilot heads
    (the shared layer-1 signal product is repeated on every rank); no
    collective.

    Args:
      params, bn_state: the stacked model (``models/mlp.py``).
      rx: (B, len_ltf, num_rx) complex64.
      dtype: the MLP's compute dtype (``models.mlp.factored_plane_apply``;
        e.g. bfloat16); None: float32.

    Returns:
      (B, C, num_tx, num_rx) complex64, gathered over the ranks on the
      mesh's first device (sharded on num_tx in JAX).
    """
    _one_process(mesh, "sharded_predict_all_pairs")
    devs = mesh.axis_devices(axis)
    loc = _divide(cfg.num_tx, len(devs), "pilot heads")
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    rx = torch.as_tensor(rx).to(torch.complex64)
    b, L, nrx = rx.shape
    ys = []
    with full_f32_matmul():
        for i, dev in enumerate(devs):
            p_loc = p_full[i * loc:(i + 1) * loc].to(dev)
            pp, bb = _to(params, dev), _to(bn_state, dev)
            sig2 = rx.to(dev).transpose(1, 2).reshape(b * nrx, L)
            y2 = [factored_plane_apply(tcfg, plane(pp, d), plane(bb, d), x,
                                       p_loc, dtype=dtype)
                  for d, x in enumerate((sig2.real, sig2.imag))]
            y = torch.complex(y2[0], y2[1]).reshape(b, nrx, loc,
                                                    cfg.num_carriers)
            ys.append(y.permute(0, 3, 2, 1).to(mesh.first))
    return torch.cat(ys, dim=2)


def sharded_estimate_combined(cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                              params, bn_state, rx, data_axis: str = "data",
                              seq_axis: str = "seq",
                              ant_axis: str = "antenna", dtype=None):
    """The fused estimation step (LS + factored all-pairs DNN) over one
    data × seq × antenna mesh:

    * ``data``: packets, no collective;
    * ``seq``: the preamble split at symbol boundaries; each rank makes
      (a) a partial despread for LS and (b) a partial layer-1 signal
      product ``x_loc @ W1[rows_loc]`` for the DNN, each completed by a
      sum over the seq ranks;
    * ``antenna``: the pilot heads; each rank finishes the MLP for its
      heads.

    Work the JAX package repeats on every rank of an axis (the LS and
    layer-1 partials on every antenna rank) runs once here, on the
    antenna-0 rank. Float32 throughout, or with ``dtype`` (e.g.
    bfloat16) the DNN's products in that dtype: the layer-1 partials
    with float32 sums, the heads as ``models.mlp.factored_heads_apply``.

    Args:
      rx: (B, len_ltf, num_rx) complex64; B divisible by the data size.

    Returns:
      (h_ls, h_dnn), each (B, C, num_tx, num_rx) complex64, gathered on
      the mesh's first device (in JAX h_ls is replicated over seq and
      antenna, h_dnn split over antenna, both split over data).
    """
    _one_process(mesh, "sharded_estimate_combined")
    n_data, n_seq, n_ant = (mesh.shape[a] for a in (data_axis, seq_axis,
                                                    ant_axis))
    loc_sym = _divide(cfg.num_tx, n_seq, "symbols")
    loc_heads = _divide(cfg.num_tx, n_ant, "pilot heads")
    rx = torch.as_tensor(rx).to(torch.complex64)
    b_loc = _divide(rx.shape[0], n_data, "packets")
    r = rx.shape[2]
    l_loc = loc_sym * cfg.sym_len
    p_full = torch.as_tensor(_hadamard_np(cfg.num_tx))
    first = mesh.first
    h_ls, h_dnn = [], []
    with full_f32_matmul():
        for i_d in range(n_data):
            rx_d = rx[i_d * b_loc:(i_d + 1) * b_loc]
            home = mesh.device(**{data_axis: i_d})
            ls_parts, sp_parts = [], []
            for i_s in range(n_seq):
                dev = mesh.device(**{data_axis: i_d, seq_axis: i_s})
                blk = rx_d[:, i_s * l_loc:(i_s + 1) * l_loc].to(dev)
                ls_parts.append(_ls_partial_fft(
                    cfg, blk, p_full[:, i_s * loc_sym:(i_s + 1) * loc_sym]
                    .to(dev)))
                w1 = params["dense"][0]["w"][:, i_s * l_loc:
                                             (i_s + 1) * l_loc].to(dev)
                sig2 = blk.transpose(1, 2).reshape(b_loc * r, l_loc)
                sp_parts.append(torch.stack([
                    _product(sig2.real, w1[0], dtype),
                    _product(sig2.imag, w1[1], dtype)]))
            ls = sum_onto(ls_parts, home) \
                / _ls_denominator(cfg, home)[None, :, None, None]
            h_ls.append(ls.to(first))
            sig_proj = sum_onto(sp_parts, home)              # (2, S, H)
            ys = []
            for i_a in range(n_ant):
                dev = mesh.device(**{data_axis: i_d, ant_axis: i_a})
                pp, bb = _to(params, dev), _to(bn_state, dev)
                pil = p_full[i_a * loc_heads:(i_a + 1) * loc_heads].to(dev)
                sp = sig_proj.to(dev)
                y2 = [factored_heads_apply(tcfg, plane(pp, d), plane(bb, d),
                                           sp[d], pil, cfg.len_ltf,
                                           dtype=dtype)
                      for d in range(2)]
                y = torch.complex(y2[0], y2[1]).reshape(
                    b_loc, r, loc_heads, cfg.num_carriers)
                ys.append(y.permute(0, 3, 2, 1).to(first))
            h_dnn.append(torch.cat(ys, dim=2))
    return torch.cat(h_ls), torch.cat(h_dnn)


# ----------------------------------------------------------------------
# DP + TP training step
# ----------------------------------------------------------------------

class P:
    """JAX's PartitionSpec: per leading dimension of a tensor, the mesh
    axis that splits it evenly (None: whole); dimensions past the spec are
    whole. ``P()`` is replicated on every rank."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __repr__(self):
        return f"P{self.axes}"


class NamedSharding:
    """A layout on a mesh: ``spec`` over ``mesh``'s axes (JAX's
    NamedSharding; a leaf of the port's trees)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec} on {self.mesh.shape})"


class ShardedTensor:
    """A tensor laid out on a mesh, the port's jax.Array with a
    NamedSharding: ``shards[r]`` is flat rank r's piece (``block(r)`` of
    the whole) on its device, or None where another process owns the
    rank. Ranks that hold the same piece keep a copy each (the training
    step updates the pieces in place, rank by rank)."""

    def __init__(self, sharding: NamedSharding, shape, dtype, shards):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def block(self, r: int) -> tuple:
        """Rank r's piece as slices of the whole."""
        mesh, axes = self.mesh, self.sharding.spec.axes
        out = []
        for k, n in enumerate(self.shape):
            a = axes[k] if k < len(axes) else None
            if a is None or a not in mesh.axis_names:
                out.append(slice(None))
                continue
            size = n // mesh.shape[a]
            i = mesh.position(r, a)
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def local(self) -> list:
        """[(flat rank, piece)] of this process's ranks."""
        return [(r, self.shards[r]) for r in self.mesh.local_ranks]

    def _key(self, r: int) -> tuple:
        return tuple((b.start, b.stop) for b in self.block(r))

    def gather(self) -> torch.Tensor:
        """The whole tensor on the host (CPU). Where a process lacks some
        piece, the pieces arrive through the group: then every process
        must call it (the layout decides, the same on every process)."""
        mesh = self.mesh
        procs = mesh.procs.ravel()
        every = {self._key(r) for r in range(mesh.size)}
        pieces = dict(self.local())
        if any({self._key(r) for r in range(mesh.size) if procs[r] == p}
               != every for p in range(mesh.num_processes)):
            pieces = exchange(mesh, pieces)
        out = torch.empty(self.shape, dtype=self.dtype)
        done = set()
        for r in sorted(pieces):
            if self._key(r) not in done:
                out[self.block(r)] = pieces[r].detach().cpu()
                done.add(self._key(r))
        return out

    def __repr__(self):
        return (f"ShardedTensor({self.shape}, {self.dtype}, "
                f"{self.sharding.spec} on {self.mesh.shape})")


def device_put(t: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """t (on any device) laid out by ``sharding``: each local rank's piece
    copied to its device (JAX's ``jax.device_put``)."""
    mesh = sharding.mesh
    t = torch.as_tensor(t)
    for k, a in enumerate(sharding.spec.axes):
        if a is not None and a in mesh.axis_names:
            _divide(t.shape[k], mesh.shape[a], f"entries of dimension {k}")
    st = ShardedTensor(sharding, t.shape, t.dtype, [None] * mesh.size)
    for r in mesh.local_ranks:
        piece = t[st.block(r)]
        st.shards[r] = torch.empty(piece.shape, dtype=t.dtype,
                                   device=mesh.rank_device(r)).copy_(piece)
    return st


def gather_tree(tree):
    """Every ShardedTensor of a tree as its whole host tensor
    (``ShardedTensor.gather``); other leaves as they are."""
    return tree_map(lambda t: t.gather() if isinstance(t, ShardedTensor)
                    else t, tree)


def param_shardings(mesh: Mesh, params, bn_state, model_axis: str = "model"):
    """NamedShardings for the stacked MLP: layer i's weight column-parallel
    for even i (its output units split over ``model_axis``) and
    row-parallel for odd i (its input units split); biases and BN vectors
    follow their layer's output (split for even i); the output layer and
    the stacked real/imag axis replicated; everything replicated without
    a ``model_axis``. Returns (params shardings, bn_state shardings), trees
    of the structure of ``params`` and ``bn_state``."""
    has_model = model_axis in mesh.axis_names

    def w_spec(i):
        if not has_model:
            return P()
        return (P(None, None, model_axis) if i % 2 == 0
                else P(None, model_axis, None))

    def b_spec(i):
        if not has_model:
            return P()
        return P(None, model_axis) if i % 2 == 0 else P(None)

    ns = lambda spec: NamedSharding(mesh, spec)  # noqa: E731
    p_sh = {
        "dense": [{"w": ns(w_spec(i)), "b": ns(b_spec(i))}
                  for i in range(len(params["dense"]))],
        "out": {"w": ns(P(None, None, None)), "b": ns(P(None))},
        "bn": [{"scale": ns(b_spec(i)), "bias": ns(b_spec(i))}
               for i in range(len(params["bn"]))],
    }
    bn_sh = {
        "mean": [ns(b_spec(i)) for i in range(len(bn_state["mean"]))],
        "var": [ns(b_spec(i)) for i in range(len(bn_state["var"]))],
    }
    return p_sh, bn_sh


def place_state(mesh: Mesh, params, bn_state, opt_state=None,
                model_axis: str = "model"):
    """Host (or any device's) parameters, BN statistics and optionally the
    Adam state (``train.loop.AdamState``: its moments laid out as the
    parameters, its count replicated) placed on the mesh with
    ``param_shardings``. Returns (params, bn_state, opt_state or None)."""
    from mamimo_tpu_torch.train.loop import AdamState

    p_sh, bn_sh = param_shardings(mesh, params, bn_state, model_axis)
    params = tree_map(device_put, params, p_sh)
    bn_state = tree_map(device_put, bn_state, bn_sh)
    if opt_state is not None:
        opt_state = AdamState(
            device_put(opt_state.count, NamedSharding(mesh, P())),
            tree_map(device_put, opt_state.mu, p_sh),
            tree_map(device_put, opt_state.nu, p_sh))
    return params, bn_state, opt_state


def replicate(mesh: Mesh, tree) -> dict:
    """{device: tree copied there} for each distinct device of this
    process's ranks (ranks on one card share one copy; read only)."""
    out = {}
    for r in mesh.local_ranks:
        dev = mesh.rank_device(r)
        if dev not in out:
            out[dev] = tree_map(lambda t: t.to(dev), tree)
    return out


class _MeshLayout:
    """The ``constrain`` hook of ``train/loop.py::make_batch_update`` on a
    data × model mesh, JAX's sharding constraints made explicit: the batch
    split over ``data``, each rank's forward and backward on its rows and
    its parameter pieces, the sums of JAX's collectives as
    ``collectives.all_sum``:

    * BatchNorm statistics over the global batch, the two-pass way (the
      mean, then the mean of squared deviations), each a sum over the
      data ranks that autograd runs through;
    * a row-parallel layer's partial products summed over the model
      ranks before its bias and ReLU;
    * the loss counted once per data rank, on its model-0 rank (the other
      model ranks compute the same replicated tail, its cotangent 0);
    * each leaf's gradient summed over the axes it is replicated on, in
      rank order, so every copy gets the same bits before Adam runs on it
      rank by rank.
    """

    def __init__(self, cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                 data_axis: str, model_axis: str):
        extra = set(mesh.axis_names) - {data_axis, model_axis}
        if extra:
            raise ValueError(f"the training step runs on a {data_axis} x "
                             f"{model_axis} mesh, got axes "
                             f"{mesh.axis_names}")
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.data_axis, self.model_axis = data_axis, model_axis
        self.n_data = mesh.shape.get(data_axis, 1)
        self.n_model = mesh.shape.get(model_axis, 1)
        for i in range(0, len(tcfg.hidden), 2):    # the split layers
            _divide(tcfg.hidden[i], self.n_model,
                    f"units of hidden layer {i}")

    # -- the batch -------------------------------------------------------
    def rows(self, r: int, batch: int) -> slice:
        """Rank r's rows of a global batch of ``batch``."""
        per = _divide(batch, self.n_data, "samples")
        i = self.mesh.position(r, self.data_axis)
        return slice(i * per, (i + 1) * per)

    def split(self, x2, pilot, y2):
        parts = {}
        for r in self.mesh.local_ranks:
            rows = self.rows(r, x2.shape[1])
            dev = self.mesh.rank_device(r)
            parts[r] = (x2[:, rows].to(dev), pilot[rows].to(dev),
                        y2[:, rows].to(dev), rows)
        return parts

    def gather_parts(self, data: dict, idx):
        """The batch of global sample indices ``idx`` gathered rank by rank
        from the replicated dataset (``replicate``: {device: container})."""
        from mamimo_tpu_torch.train.loop import _gather_batch

        parts, seen = {}, {}
        for r in self.mesh.local_ranks:
            rows = self.rows(r, len(idx))
            dev = self.mesh.rank_device(r)
            key = (dev, rows.start)
            if key not in seen:
                i_r = (idx[rows].to(dev) if isinstance(idx, torch.Tensor)
                       else torch.as_tensor(np.asarray(idx[rows]),
                                            device=dev))
                seen[key] = _gather_batch(self.cfg, data[dev], i_r)
            parts[r] = (*seen[key], rows)
        return parts

    def batch(self, parts) -> int:
        return next(iter(parts.values()))[0].shape[1] * self.n_data

    # -- the state, rank by rank ------------------------------------------
    def view(self, tree, r: int):
        return tree_map(lambda t: t.shards[r], tree)

    def with_state(self, opt_state, r: int, state):
        opt_state.count.shards[r] = state.count
        return opt_state

    # -- the model ----------------------------------------------------------
    def _cols(self, r: int, i: int) -> slice:
        """Rank r's units of hidden layer i's output (all of them unless the
        layer is column-parallel)."""
        if self.n_model == 1 or i % 2:
            return slice(None)
        per = self.tcfg.hidden[i] // self.n_model
        j = self.mesh.position(r, self.model_axis)
        return slice(j * per, (j + 1) * per)

    def forward(self, params, bn, xs, batch: int, train: bool, gen):
        """Each rank's output y (2, rows, C) and new BN statistics, from its
        parameter pieces ``params[r]``, statistics ``bn[r]`` and model
        input ``xs[r]``; ``batch`` the global batch size."""
        tcfg, mesh = self.tcfg, self.mesh
        dense = Bf16Dense.apply if tcfg.matmul_dtype == "bf16" \
            else torch.matmul
        row = lambda t: t.unsqueeze(-2)        # noqa: E731  (..., 1, H)
        ranks = list(xs)
        n_hidden = len(tcfg.hidden)
        use_bn = bool(params[ranks[0]]["bn"])
        new_bn = {r: {"mean": [], "var": []} for r in ranks}
        h = dict(xs)
        for i in range(n_hidden):
            z = {r: dense(h[r], params[r]["dense"][i]["w"]) for r in ranks}
            if self.n_model > 1 and i % 2 == 1:
                # row-parallel: the partial products summed over model
                z = all_sum(mesh, (self.model_axis,), z)
            z = {r: torch.relu(z[r] + row(params[r]["dense"][i]["b"]))
                 for r in ranks}
            if use_bn:
                if train:
                    s = all_sum(mesh, (self.data_axis,),
                                {r: z[r].sum(-2) for r in ranks})
                    dev_ = {r: z[r] - row(s[r] / batch) for r in ranks}
                    q = all_sum(mesh, (self.data_axis,),
                                {r: (dev_[r] * dev_[r]).sum(-2)
                                 for r in ranks})
                    m = tcfg.bn_momentum
                    for r in ranks:
                        new_bn[r]["mean"].append(
                            m * bn[r]["mean"][i]
                            + (1 - m) * (s[r] / batch).detach())
                        new_bn[r]["var"].append(
                            m * bn[r]["var"][i]
                            + (1 - m) * (q[r] / batch).detach())
                    z = {r: dev_[r] * torch.rsqrt(row(q[r] / batch)
                                                  + tcfg.bn_eps)
                         for r in ranks}
                else:
                    z = {r: (z[r] - row(bn[r]["mean"][i]))
                         * torch.rsqrt(row(bn[r]["var"][i]) + tcfg.bn_eps)
                         for r in ranks}
                z = {r: z[r] * row(params[r]["bn"][i]["scale"])
                     + row(params[r]["bn"][i]["bias"]) for r in ranks}
            if train and tcfg.dropout > 0.0 and i < n_hidden - 1:
                keep = 1.0 - tcfg.dropout
                mask = torch.rand((2, batch, tcfg.hidden[i]), generator=gen,
                                  device=gen.device) < keep
                z = {r: torch.where(
                    mask[:, self.rows(r, batch), self._cols(r, i)]
                    .to(z[r].device), z[r] / keep, 0.0) for r in ranks}
            h = z
        if self.n_model > 1 and n_hidden % 2 == 1:
            # the last hidden layer is column-parallel: its pieces side by
            # side before the replicated output layer
            width = tcfg.hidden[-1]
            h = all_sum(mesh, (self.model_axis,), {
                r: torch.nn.functional.pad(h[r], (
                    self._cols(r, n_hidden - 1).start,
                    width - self._cols(r, n_hidden - 1).stop))
                for r in ranks})
        y = {r: dense(h[r], params[r]["out"]["w"])
             + row(params[r]["out"]["b"]) for r in ranks}
        return y, (new_bn if train and use_bn else bn)

    def _loss(self, y, inputs, batch: int):
        """{rank: per-plane sum of squares / (batch·C)} and the global
        per-plane loss (the sum over the data ranks)."""
        n = batch * self.cfg.num_carriers
        per = {r: ((y[r] - inputs[r][1]) ** 2).sum(dim=(1, 2)) / n
               for r in y}
        total = {r: v.detach() for r, v in per.items()}
        axes = self._axes((self.data_axis,))
        if axes:
            total = group_sum(self.mesh, axes, total)
        return per, total[self.mesh.local_ranks[0]]

    def _axes(self, axes) -> tuple:
        """``axes`` without those of size 1 (or absent)."""
        return tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)

    def loss_and_grads(self, params, bn_state, inputs, gen):
        mesh = self.mesh
        ranks = list(inputs)
        batch = self.batch(inputs)
        live = {r: tree_map(lambda p: p.detach().requires_grad_(),
                            self.view(params, r)) for r in ranks}
        bn = {r: self.view(bn_state, r) for r in ranks}
        with torch.enable_grad():
            y, new_bn = self.forward(live, bn,
                                     {r: inputs[r][0] for r in ranks},
                                     batch, True, gen)
            per, per_dim = self._loss(y, inputs, batch)
            outs = [per[r].sum() for r in ranks]
            # the loss is counted once per data rank: on model rank 0
            ones = [torch.tensor(
                1.0 if mesh.position(r, self.model_axis) == 0 else 0.0,
                device=o.device) for r, o in zip(ranks, outs)]
            leaves = {r: tree_leaves(live[r]) for r in ranks}
            flat = [l for r in ranks for l in leaves[r]]
            grads = torch.autograd.grad(outs, flat, ones, allow_unused=True)
        n_leaf = len(leaves[ranks[0]])
        g = {r: [gg if gg is not None else torch.zeros_like(l)
                 for gg, l in zip(grads[k * n_leaf:(k + 1) * n_leaf],
                                  leaves[r])]
             for k, r in enumerate(ranks)}
        # each leaf's gradient summed over the axes it is replicated on
        specs = [t.sharding.spec.axes for t in tree_leaves(params)]
        for k, spec in enumerate(specs):
            axes = self._axes(a for a in (self.data_axis, self.model_axis)
                              if a not in spec)
            if axes:
                summed = group_sum(mesh, axes, {r: g[r][k] for r in ranks})
                for r in ranks:
                    g[r][k] = summed[r]
        return (per_dim, new_bn,
                {r: tree_unflatten(params, g[r]) for r in ranks})

    def eval_loss(self, params, bn_state, inputs):
        ranks = list(inputs)
        batch = self.batch(inputs)
        y, _ = self.forward({r: self.view(params, r) for r in ranks},
                            {r: self.view(bn_state, r) for r in ranks},
                            {r: inputs[r][0] for r in ranks}, batch, False,
                            None)
        return self._loss(y, inputs, batch)[1]


def make_sharded_train_step(cfg: SimConfig, tcfg: TrainConfig, mesh: Mesh,
                            data_axis: str = "data",
                            model_axis: str = "model",
                            avg_sig_pow: float = 0.0):
    """The DP+TP training step over ``mesh`` (a ``data`` and optionally a
    ``model`` axis): ``train/loop.py::make_batch_update`` with the mesh's
    layout as its ``constrain`` hook, so the step is the single-card step
    up to the order of its sums.

    Returns (init_fn, step_fn):
      init_fn(gen=None) -> (params, bn_state, opt_state) on the mesh:
        ``init_stacked`` from ``gen`` (a CPU generator; default seeded
        with tcfg.seed) placed by ``param_shardings`` (``place_state``);
      step_fn(params, bn_state, opt_state, x2, pilot, y2, gen, lr)
        -> (params, bn_state, opt_state, loss_per_plane), x2 (2, B, L),
        pilot (B, num_tx), y2 (2, B, C) the global batch on any device
        (each rank takes its rows), ``gen`` a generator on the device of
        this process's first rank; the state is updated in place.
    step_fn.gather(params, bn_state, opt_state, data, idx, gen, lr): the
    batch of global sample indices idx gathered on each rank from
    ``data = replicate(mesh, container)``; step_fn.gather_eval(params,
    bn_state, data, idx) and step_fn.array_eval(params, bn_state, x2,
    pilot, y2): the per-plane MSE; step_fn.batch_sharding and
    .pilot_sharding: the batch layouts.
    """
    from mamimo_tpu_torch.models.mlp import init_stacked
    from mamimo_tpu_torch.train.loop import make_batch_update, make_optimizer

    opt = make_optimizer(tcfg)
    layout = _MeshLayout(cfg, tcfg, mesh, data_axis, model_axis)
    update, eval_core = make_batch_update(cfg, tcfg, avg_sig_pow, opt,
                                          constrain=layout)

    def init_fn(gen: torch.Generator | None = None):
        gen = gen or torch.Generator().manual_seed(tcfg.seed)
        params, bn_state = init_stacked(gen, cfg, tcfg)
        return place_state(mesh, params, bn_state, opt.init(params),
                           model_axis)

    def step_fn(params, bn_state, opt_state, x2, pilot, y2, gen, lr):
        return update(params, bn_state, opt_state, x2, pilot, y2, gen, lr)

    def gather_step(params, bn_state, opt_state, data, idx, gen, lr):
        return update.parts(params, bn_state, opt_state,
                            layout.gather_parts(data, idx), gen, lr)

    def gather_eval(params, bn_state, data, idx):
        return eval_core.parts(params, bn_state,
                               layout.gather_parts(data, idx))

    step_fn.gather = gather_step
    step_fn.gather_eval = gather_eval
    step_fn.array_eval = eval_core
    step_fn.batch_sharding = NamedSharding(mesh, P(None, data_axis))
    step_fn.pilot_sharding = NamedSharding(mesh, P(data_axis))
    return init_fn, step_fn
