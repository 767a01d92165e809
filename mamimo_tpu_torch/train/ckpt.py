"""Checkpoint save/load in the JAX package's npz format
(``mamimo_tpu/train/ckpt.py``, npz backend).

A checkpoint is ``<prefix>.npz`` (the flattened ``{"params", "bn_state"}``
tree: leaves ``leaf_0..leaf_{n-1}`` plus a ``__treedef__`` description)
and ``<prefix>.json`` (the two configs). The leaf order is jax
``tree_flatten`` order: dict keys sorted, lists in order. For the MLP
that is ``bn_state.mean[i]``, ``bn_state.var[i]``, ``params.bn[i].bias``,
``params.bn[i].scale``, ``params.dense[i].b``, ``params.dense[i].w``,
``params.out.b``, ``params.out.w``. Checkpoints written here load in the
JAX package and the reverse. The orbax backend is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import tree_leaves as _flatten


def _unflatten(like, leaves):
    """Rebuild the structure of ``like`` from an iterator of leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _treedef_str(tree) -> str:
    """The structure in jax's PyTreeDef notation (descriptive only:
    neither package parses it)."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ", ".join(rec(x) for x in t) + "]"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors/arrays (nested dicts and lists)."""
    leaves = _flatten(tree)
    np.savez(
        path,
        __treedef__=np.frombuffer(_treedef_str(tree).encode(), np.uint8),
        **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)},
    )


def load_pytree(path: str, like):
    """Load leaves saved by save_pytree (either package's) into the
    structure of ``like``; leaves come back as numpy arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        n = len(z.files) - 1
        if n != len(_flatten(like)):
            raise ValueError(f"{path}: {n} leaves, structure wants "
                             f"{len(_flatten(like))}")
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return _unflatten(like, iter(leaves))


def param_structure(cfg: SimConfig, tcfg: TrainConfig):
    """The {"params", "bn_state"} structure of a stacked MLP, with None
    leaves (what load_pytree needs; no weights are drawn)."""
    n = len(tcfg.hidden)
    bn = tcfg.use_bn
    params = {
        "dense": [{"w": None, "b": None} for _ in range(n)],
        "out": {"w": None, "b": None},
        "bn": [{"scale": None, "bias": None} for _ in range(n)] if bn else [],
    }
    bn_state = {"mean": [None] * n if bn else [],
                "var": [None] * n if bn else []}
    return {"params": params, "bn_state": bn_state}


def save_checkpoint(prefix: str, cfg: SimConfig, tcfg: TrainConfig, params,
                    bn_state, extra: Dict[str, Any] | None = None,
                    backend: str = "npz") -> None:
    """Write <prefix>.npz and <prefix>.json (npz backend only)."""
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r} is not ported; "
                         "use 'npz'")
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    save_pytree(prefix + ".npz", {"params": params, "bn_state": bn_state})
    meta = {
        "cfg": json.loads(cfg.to_json()),
        "tcfg": json.loads(tcfg.to_json()),
        "extra": extra or {},
        "backend": backend,
        "has_opt": False,
    }
    with open(prefix + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(prefix: str) -> Dict[str, Any]:
    """Load a checkpoint written by save_checkpoint of either package.

    Returns {"cfg", "tcfg", "extra", "params", "bn_state"}; parameters
    are numpy float32 arrays in the JAX package's structure (convert with
    ``models.mlp.params_from_jax``). Raises for an orbax checkpoint.
    """
    with open(prefix + ".json") as f:
        meta = json.load(f)
    if meta.get("backend") == "orbax" or (
            not os.path.exists(prefix + ".npz")
            and os.path.isdir(prefix + ".orbax")):
        raise NotImplementedError(
            f"{prefix}: orbax checkpoints are not ported; re-save it with "
            "the npz backend")
    cfg = SimConfig(**meta["cfg"])
    tcfg = TrainConfig.from_json(json.dumps(meta["tcfg"]))
    state = load_pytree(prefix + ".npz", param_structure(cfg, tcfg))
    return {"cfg": cfg, "tcfg": tcfg, "extra": meta.get("extra", {}),
            "params": state["params"], "bn_state": state["bn_state"]}
