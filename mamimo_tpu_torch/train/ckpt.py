"""Checkpoint save/load in the JAX package's npz format
(``mamimo_tpu/train/ckpt.py``, npz backend).

A checkpoint is ``<prefix>.npz`` (the flattened ``{"params", "bn_state"}``
tree: leaves ``leaf_0..leaf_{n-1}`` plus a ``__treedef__`` description)
and ``<prefix>.json`` (the two configs). The leaf order is jax
``tree_flatten`` order: dict keys sorted, lists in order. For the MLP
that is ``bn_state.mean[i]``, ``bn_state.var[i]``, ``params.bn[i].bias``,
``params.bn[i].scale``, ``params.dense[i].b``, ``params.dense[i].w``,
``params.out.b``, ``params.out.w``. With an optimizer state a third file,
``<prefix>_opt.npz``, holds it in optax's leaf order: ``count`` (an int32
scalar), the first-moment leaves, then the second-moment leaves
(``train.loop.AdamState``). A bfloat16 first moment is stored as JAX
stores it, two raw bytes a value (numpy's ``V2``); ``bf16_from_numpy``
reads it back. Checkpoints written here load in the JAX package and the
reverse. The orbax backend is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.models.mlp import tree_leaves as _flatten
from mamimo_tpu_torch.models.mlp import tree_unflatten


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
    """A leaf as numpy; a bfloat16 tensor as its raw 2-byte values (the
    ``V2`` array JAX's numpy form of bfloat16 saves as)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def is_bf16_numpy(a: np.ndarray) -> bool:
    """True for numpy bfloat16 as either package meets it: ml_dtypes'
    bfloat16, or the raw ``V2`` values an npz file gives back."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def bf16_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy bfloat16 array (``is_bf16_numpy``) as a bfloat16 tensor
    holding the same values, bit for bit."""
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16
    return torch.from_numpy(bits.view(np.float32)).to(
        device=device, dtype=torch.bfloat16)


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
    return tree_unflatten(like, leaves)


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
                    opt_state=None, backend: str = "npz") -> None:
    """Write <prefix>.npz, with ``opt_state`` (``train.loop.AdamState``)
    also <prefix>_opt.npz, and <prefix>.json (npz backend only)."""
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r} is not ported; "
                         "use 'npz'")
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    save_pytree(prefix + ".npz", {"params": params, "bn_state": bn_state})
    if opt_state is not None:
        save_pytree(prefix + "_opt.npz", opt_state)
    meta = {
        "cfg": json.loads(cfg.to_json()),
        "tcfg": json.loads(tcfg.to_json()),
        "extra": extra or {},
        "backend": backend,
        "has_opt": opt_state is not None,
    }
    with open(prefix + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(prefix: str, like_opt_state=None) -> Dict[str, Any]:
    """Load a checkpoint written by save_checkpoint of either package.

    Returns {"cfg", "tcfg", "extra", "params", "bn_state"}; parameters
    are numpy float32 arrays in the JAX package's structure (convert with
    ``models.mlp.params_from_jax``). With ``like_opt_state`` (a state of
    the structure wanted, e.g. ``make_optimizer(tcfg).init(params)``) and
    a <prefix>_opt.npz, also "opt_state": numpy leaves in that structure
    (convert with ``train.loop.opt_state_from_jax``). Raises for an orbax
    checkpoint.
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
    out = {"cfg": cfg, "tcfg": tcfg, "extra": meta.get("extra", {}),
           "params": state["params"], "bn_state": state["bn_state"]}
    if like_opt_state is not None and os.path.exists(prefix + "_opt.npz"):
        out["opt_state"] = load_pytree(prefix + "_opt.npz", like_opt_state)
    return out
