"""Child process for tests/test_torch_multihost.py (not collected by
pytest): one of two processes joined by the port's
``parallel.multihost.init`` over gloo, each with 2 CPU ranks, so a
4-rank mesh spans both. It imports the port only.

  * ``local_batch_slice`` and a sum whose partials cross the process
    boundary (``sum_onto``);
  * ``sharded_ls_estimate`` on a seq mesh across the processes, against
    the unsharded LS;
  * 3 DP+TP steps of ``make_sharded_train_step`` (data 2 x model 2, the
    model pairs within a process; and data 4) from a global numpy batch;
  * a 4-epoch ``fit(mesh=...)`` (data 4) of the problem of
    tests/_multihost_fit_child.py, the workdir written by process 0.

Prints one line "MH_TORCH_OK steps=<hashes> fit=<hash> hist=<history>":
after the steps, per local rank the SHA-256 of its parameter pieces and
BN statistics, then of the gathered parameters (for each mesh); the
fit's best parameters and its loss history. The parent holds the two
processes' lines to each other bit for bit (rank (0, m) against (1, m),
rank 0 against rank 2), and the history to a single-process 4-rank
fit.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mamimo_tpu_torch.parallel import multihost  # noqa: E402

process_id = int(sys.argv[1])
port = sys.argv[2]
workdir = sys.argv[3]

multihost.init(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
               process_id=process_id, backend="gloo")

from mamimo_tpu_torch.config import SimConfig, TrainConfig  # noqa: E402
from mamimo_tpu_torch.models.mlp import tree_leaves  # noqa: E402
from mamimo_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mamimo_tpu_torch.parallel.sharded import (  # noqa: E402
    gather_tree,
    make_sharded_train_step,
    sharded_ls_estimate,
    sum_onto,
)
from mamimo_tpu_torch.pipeline.dataset import generate_dataset  # noqa: E402
from mamimo_tpu_torch.pipeline.sounding import estimate_from_rx  # noqa: E402
from mamimo_tpu_torch.train import fit  # noqa: E402

assert multihost.process_count() == 2
CPU2 = ["cpu", "cpu"]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# ---- the batch slice and a sum across the processes
mesh = make_mesh({"data": 4}, devices=CPU2)
assert mesh.num_processes == 2 and mesh.local_ranks == [2 * process_id,
                                                          2 * process_id + 1]
sl = multihost.local_batch_slice(16)
assert sl == slice(process_id * 8, (process_id + 1) * 8), sl
full = torch.arange(16.0).reshape(16, 1)
ranks = mesh.axis_ranks("data")
parts = [full[4 * r:4 * (r + 1)].sum(0) if mesh.is_local(r) else None
         for r in ranks]
total = sum_onto(parts, mesh.first, mesh, ranks)
assert float(total) == float(full.sum()), total

# ---- seq-parallel LS: the sum crosses the process boundary
cfg = SimConfig(num_tx=8, num_rx=2, n_scatterers=20, n_rays=50)
z = np.random.default_rng(3).standard_normal((2, cfg.len_ltf, cfg.num_rx, 2))
rx = torch.from_numpy((z[..., 0] + 1j * z[..., 1]).astype(np.complex64))
ref = estimate_from_rx(cfg, rx)[0]
out = sharded_ls_estimate(cfg, make_mesh({"seq": 4}, devices=CPU2), rx)
err = float((out - ref).abs().max() / ref.abs().max())
assert err < 2e-5, err

# ---- 3 DP+TP steps with the batch split across the processes
tcfg = TrainConfig(hidden=(32, 32), batch_size=16, dropout=0.0,
                   method="default", seed=0)
rng = np.random.default_rng(0)
x2 = torch.from_numpy(rng.standard_normal((2, 16, cfg.len_ltf))
                      .astype(np.float32))
pilot = torch.from_numpy(rng.standard_normal((16, cfg.num_tx))
                         .astype(np.float32))
y2 = torch.from_numpy(rng.standard_normal((2, 16, cfg.num_carriers))
                      .astype(np.float32))
step_hashes = []
for axes in ({"data": 2, "model": 2}, {"data": 4}):
    m = make_mesh(axes, devices=CPU2)
    init_fn, step_fn = make_sharded_train_step(cfg, tcfg, m)
    params, bn, opt_state = init_fn(torch.Generator().manual_seed(0))
    for _ in range(3):
        params, bn, opt_state, loss = step_fn(params, bn, opt_state, x2,
                                              pilot, y2, None, 1e-3)
    assert bool(torch.isfinite(loss).all()), loss
    leaves = tree_leaves(params) + tree_leaves(bn)
    # every rank's pieces, and the whole parameters as gathered
    step_hashes += [digest(l.shards[r] for l in leaves)
                    for r in m.local_ranks]
    step_hashes.append(digest(tree_leaves(gather_tree(params))))

# ---- a 4-epoch fit on a data mesh across the processes
fcfg = SimConfig(num_tx=8, num_rx=2, n_scatterers=8, n_rays=20)
ds = generate_dataset(fcfg, seed=5, num_packets=12, snr_db=120.0, chunk=12,
                      fft_size=4096, device="cpu")
ftcfg = TrainConfig(hidden=(32, 32), batch_size=32, epochs=4, seed=3,
                    dropout=0.0, early_stop_patience=50)
res = fit(fcfg, ftcfg, ds, mesh=make_mesh({"data": 4}, devices=CPU2),
          workdir=workdir, verbose=False)
hist = [float(v) for k in ("loss_real", "loss_imag", "val_loss_real",
                           "val_loss_imag") for v in res.history[k]]
print(f"MH_TORCH_OK steps={step_hashes} "
      f"fit={digest(tree_leaves(res.params))} hist={hist!r}", flush=True)
multihost.shutdown()
