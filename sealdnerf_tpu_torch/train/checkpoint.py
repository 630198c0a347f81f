"""Checkpoint IO (numpy port of sealdnerf_tpu/train/checkpoint.py).

The port reads and writes the reference's .npz format unchanged, so a
checkpoint written by either package loads into the other.

Parity with reference nerf/utils.py:1033-1155 semantics:
- rolling `max_keep_ckpt` window of ngp_ep{N}.npz files + best checkpoint
  keyed on the eval metric (density grid stripped from best, :1084-1086).
- load selectors: latest | latest_model | best | scratch | explicit path;
  non-strict load (missing/extra keys warned, not fatal).

Format: a single .npz of the flattened pytree (keys are '/'-joined paths) plus
a JSON-encoded meta blob (epoch, global_step, stats). Orbax is deliberately
not used: these pytrees are plain dicts of arrays and npz keeps checkpoints
single-file, portable, and dependency-free.
"""

import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np


def flatten_pytree(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[prefix + "__seq__"] = np.array(
            [len(tree), int(isinstance(tree, tuple))])
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0)
    else:
        if hasattr(tree, "detach"):         # torch.Tensor
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]):
    """Inverse of flatten_pytree."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node and len(node) == 1:
            return None
        if "__seq__" in node:
            n, is_tuple = int(node["__seq__"][0]), int(node["__seq__"][1])
            seq = [rebuild(node[str(i)]) for i in range(n)]
            return tuple(seq) if is_tuple else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def save_checkpoint(path: str, state: Dict[str, Any], meta: Dict[str, Any]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = flatten_pytree(state)
    flat["__meta__"] = np.frombuffer(
        json.dumps(_jsonable(meta)).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode("utf-8")) \
        if "__meta__" in flat else {}
    return unflatten_pytree(flat), meta


def resolve_checkpoint(workspace: str, name: str, selector: str) -> Optional[str]:
    """latest | latest_model | best | scratch | <path> -> file path or None."""
    if selector == "scratch":
        return None
    if selector in ("latest", "latest_model"):
        pats = sorted(glob.glob(os.path.join(workspace, "checkpoints",
                                             f"{name}_ep*.npz")))
        return pats[-1] if pats else None
    if selector == "best":
        best = os.path.join(workspace, "checkpoints", f"{name}.npz")
        if os.path.exists(best):
            return best
        pats = sorted(glob.glob(os.path.join(workspace, "checkpoints",
                                             f"{name}_ep*.npz")))
        return pats[-1] if pats else None
    return selector if os.path.exists(selector) else None
