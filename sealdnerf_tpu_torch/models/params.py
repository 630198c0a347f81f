"""Parameter trees of the port's fields: dicts of tensors (and lists of
them) with the reference pytrees' names and layouts, so that weights cross
between the two packages unchanged, for every field: the CP/VM fields'
lines, planes and towers, and the Instant-NGP and D-NeRF fields' hash
tables [T, C] at their configs' offsets and towers {"w": [W_i [in, out]]}.
"""

import numpy as np
import torch


def map_params(fn, tree):
    """Apply fn to every leaf of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def param_leaves(tree):
    """Leaves of a params tree, dict keys in sorted order and lists in
    order: the leaf order of JAX's tree_leaves, so that leaf lists (the
    optimizer's, a checkpoint's) line up between the two packages."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def unflatten_like(tree, leaves):
    """Inverse of param_leaves: a tree shaped like `tree` holding `leaves`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(tree)


def params_from_jax(tree, device=None):
    """Reference params pytree (numpy leaves) -> dict of tensors with the
    same names and layouts."""
    return map_params(lambda a: torch.as_tensor(np.array(a)).to(device),
                      tree)


def params_to_numpy(params):
    """Inverse of params_from_jax: tensors -> numpy arrays."""
    return map_params(lambda t: t.detach().cpu().numpy(), params)


def params_version(params):
    """Identity of a params tree and of the values of its leaves: every
    in-place update of a tensor (an optimizer or EMA step) bumps its
    version counter."""
    return (id(params),) + tuple(t._version for t in param_leaves(params))


class PackedTables:
    """A field's kernel operands cached per parameter version: the mixin of
    the fields whose kernels take packed tables (CPField, NGPField), which
    give `_pack(params)`. The cache key holds the params dict's identity and
    the version counter of every leaf, so both a new dict and an in-place
    update of its tensors repack."""

    def kernel_tables(self, params):
        """Packed kernel operands of `params`, built once per version. Up to
        two versions are kept: the training params and the EMA params."""
        cache = self.__dict__.setdefault("_tables", {})
        key = params_version(params)
        if key not in cache:
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))
            # the entry holds `params`, so its id is not reused while cached
            cache[key] = (params, self._pack(params))
        return cache[key][1]
