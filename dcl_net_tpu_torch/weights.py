"""Weights carried between the JAX package's variable tree and the port.

The JAX DCLNet keeps {"params", "batch_stats"} trees whose paths the port's
module names follow, so the bridge changes layouts only:

  sparse-conv kernel   [kz, ky, kx, Cin, Cout] <-> Conv3d weight [Cout, Cin, kz, ky, kx]
  Dense kernel         [Cin, Cout]             <-> Linear weight [Cout, Cin]
  BN scale/bias        params                  <-> weight/bias
  BN mean/var          batch_stats             <-> running_mean/running_var

A JAX leaf with no port counterpart, or a port tensor left unfilled, raises.
Trees are nested dicts of numpy arrays (np.asarray of what model.init gives).
to_jax_gradients reads the port's parameter gradients out in the layout of
the JAX {"params"} tree, with the same transposes, so they compare leaf by
leaf with jax.grad.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dcl_net_tpu_torch.models.blocks import SparseConvBlock

_CONV_TO_TORCH = (4, 3, 0, 1, 2)
_CONV_TO_JAX = (2, 3, 4, 1, 0)

# (collection, leaf) -> attribute of a SparseConvBlock / of a BN module
_CONV_LEAVES = {
    ("params", "kernel"): "conv.weight",
    ("params", "scale"): "bn.weight",
    ("params", "bias"): "bn.bias",
    ("batch_stats", "mean"): "bn.running_mean",
    ("batch_stats", "var"): "bn.running_var",
}
_BN_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_LINEAR_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(model: nn.Module, collection: str, path: Tuple[str, ...]) -> str:
    parent, leaf = ".".join(path[:-1]), path[-1]
    try:
        mod = model.get_submodule(parent)
    except AttributeError as exc:
        raise KeyError(f"{collection}/{'/'.join(path)}: no module {parent!r} "
                       "in the port") from exc
    if isinstance(mod, SparseConvBlock):
        table = _CONV_LEAVES
    elif isinstance(mod, nn.Linear):
        table = _LINEAR_LEAVES
    else:
        table = _BN_LEAVES
    if (collection, leaf) not in table:
        raise KeyError(f"{collection}/{'/'.join(path)}: unmapped leaf for "
                       f"{type(mod).__name__}")
    attr = table[(collection, leaf)]
    return f"{parent}.{attr}" if parent else attr


def _to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name.endswith("conv.weight"):
        return arr.transpose(_CONV_TO_TORCH)
    if arr.ndim == 2:  # Dense kernel
        return arr.T
    return arr


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill the port's DCLNet from a JAX {"params", "batch_stats"} tree."""
    state = model.state_dict()
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name = _torch_name(model, collection, path)
            arr = _to_torch_layout(name, np.asarray(value))
            dst = state[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{name}: port shape {tuple(dst.shape)}, "
                                 f"JAX gives {arr.shape}")
            dst.copy_(torch.tensor(arr))
            filled.add(name)
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unmapped collections {sorted(unknown)}")
    missing = [k for k in state
               if k not in filled and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"port tensors with no JAX counterpart: {missing}")
    return model


def to_jax_variables(model: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The inverse: the port's weights as a JAX-layout variable tree."""
    return _export(model, lambda t: t, ("params", "batch_stats"))


def to_jax_gradients(model: nn.Module,
                     grads: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """The port's parameter gradients as a JAX-layout {"params": tree}.

    grads: parameter name (as named_parameters gives it) -> gradient;
    by default each parameter's .grad. A parameter without one raises."""
    named = dict(model.named_parameters())
    if grads is None:
        grads = {n: p.grad for n, p in named.items()}
    by_id = {id(p): grads.get(n) for n, p in named.items()}

    def grad_of(t: torch.Tensor) -> torch.Tensor:
        g = by_id[id(t)]
        if g is None:
            raise KeyError(f"parameter of shape {tuple(t.shape)} has no gradient")
        return g

    return _export(model, grad_of, ("params",))


def _export(model: nn.Module, value: Callable[[torch.Tensor], torch.Tensor],
            collections: Tuple[str, ...]) -> Dict[str, Dict[str, Any]]:
    """Walk the model in the JAX tree's layout; value(t) is what is written
    for each port tensor t, for the collections asked for."""
    out: Dict[str, Dict[str, Any]] = {c: {} for c in collections}

    def put(collection: str, name: str, leaf: str, t: torch.Tensor, perm=None):
        if collection not in out:
            return
        arr = value(t).detach().cpu().numpy()
        if perm is not None:
            arr = arr.transpose(perm)
        node = out[collection]
        for part in filter(None, name.split(".")):
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, order="C")  # a copy, never a view of the tensor

    conv_blocks = {n for n, m in model.named_modules()
                   if isinstance(m, SparseConvBlock)}
    for name, mod in model.named_modules():
        if name and name.rpartition(".")[0] in conv_blocks:
            continue  # the block's own conv and bn, written with the block
        if isinstance(mod, SparseConvBlock):
            put("params", name, "kernel", mod.conv.weight, _CONV_TO_JAX)
            bn = mod.bn
        elif isinstance(mod, nn.Linear):
            put("params", name, "kernel", mod.weight, (1, 0))
            if mod.bias is not None:
                put("params", name, "bias", mod.bias)
            continue
        elif isinstance(mod, nn.BatchNorm1d):
            bn = mod
        else:
            continue
        put("params", name, "scale", bn.weight)
        put("params", name, "bias", bn.bias)
        put("batch_stats", name, "mean", bn.running_mean)
        put("batch_stats", name, "var", bn.running_var)
    return out
