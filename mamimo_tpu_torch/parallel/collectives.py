"""The sums across ranks (the port's counterpart of ``jax.lax.psum`` over
mesh axes).

Each rank's partial lives on its device; a sum over a group of ranks
adds the partials in increasing rank order, so every rank of the group
(and every process holding one) gets the same bits. In one process the
partials are copied between devices with ``.to``; in a mesh that spans
processes each process first receives the others' partials through the
``torch.distributed`` group (``exchange``), then adds them in the same
order. ``all_sum`` carries a gradient: its backward is the same sum of
the cotangents, so autograd runs through it as through JAX's psum.
"""

from __future__ import annotations

import contextlib

import torch

from mamimo_tpu_torch.parallel.mesh import Mesh


def exchange(mesh: Mesh, local: dict) -> dict:
    """Every rank's tensor, from this process's own ones.

    local: {flat rank: tensor} for every rank this process owns (same
    shape and dtype). In one process it is returned as it is; across
    processes the others' tensors arrive through the group (one
    ``all_gather``) on the device of this process's first rank.
    """
    if mesh.num_processes == 1:
        return dict(local)
    if sorted(local) != mesh.local_ranks:
        raise ValueError(f"across processes every rank of a process sends "
                         f"a part: got ranks {sorted(local)}, this process "
                         f"owns {mesh.local_ranks}")
    dist = torch.distributed
    home = mesh.first
    parts = [local[r] for r in mesh.local_ranks]
    cplx = parts[0].is_complex()
    stacked = torch.stack([torch.view_as_real(p) if cplx else p
                           for p in (q.to(home) for q in parts)])
    bufs = [torch.empty_like(stacked) for _ in range(mesh.num_processes)]
    with (torch.cuda.device(home) if home.type == "cuda"
          else contextlib.nullcontext()):
        dist.all_gather(bufs, stacked.contiguous())
    out = {}
    procs = mesh.procs.ravel()
    for p, buf in enumerate(bufs):
        owned = [int(r) for r in range(mesh.size) if procs[r] == p]
        for i, r in enumerate(owned):
            out[r] = local[r] if p == mesh.process_index else (
                torch.view_as_complex(buf[i]) if cplx else buf[i])
    return out


def group_sum(mesh: Mesh, axes, local: dict) -> dict:
    """{rank: the sum over rank's group} for each rank of ``local``.

    A rank's group is the ranks that share its indices on every axis but
    ``axes`` (``Mesh.group``); the sum adds their parts in increasing
    rank order on the device of the group's first rank of ``local``,
    and each other rank gets a copy on its own device (every result a
    new tensor).
    """
    parts = exchange(mesh, local)
    totals, out = {}, {}
    for r in local:
        g = tuple(mesh.group(r, axes))
        dev = mesh.rank_device(r)
        if g not in totals:
            if len(g) == 1:
                total = parts[g[0]].to(dev, copy=True)
            else:
                total = parts[g[0]].to(dev) + parts[g[1]].to(dev)
                for q in g[2:]:
                    total += parts[q].to(dev)
            totals[g] = out[r] = total
        else:
            out[r] = totals[g].to(dev, copy=True)
    return out


class _AllSum(torch.autograd.Function):
    """``group_sum`` with its gradient: y_r = Σ_{s in group(r)} x_s, so
    dL/dx_s = Σ_{r in group(s)} dL/dy_r, the same sum of the
    cotangents."""

    @staticmethod
    def forward(ctx, mesh, axes, ranks, *parts):
        ctx.mesh, ctx.axes, ctx.ranks = mesh, axes, ranks
        out = group_sum(mesh, axes, dict(zip(ranks, parts)))
        return tuple(out[r] for r in ranks)

    @staticmethod
    def backward(ctx, *grads):
        out = group_sum(ctx.mesh, ctx.axes, dict(zip(ctx.ranks, grads)))
        return (None, None, None) + tuple(out[r] for r in ctx.ranks)


def all_sum(mesh: Mesh, axes, local: dict) -> dict:
    """``group_sum`` through which autograd runs. Over axes the mesh lacks
    (or of size 1) every group is one rank and the parts come back as
    they are."""
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return dict(local)
    ranks = tuple(sorted(local))
    return dict(zip(ranks, _AllSum.apply(mesh, axes, ranks,
                                         *(local[r] for r in ranks))))
