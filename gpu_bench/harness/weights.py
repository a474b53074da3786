"""The run's weights, made on the device from the seed in two large draws.

Both sides get the same tensors: the program loads them into its model
(load_state_dict) and the reference reads them by the same names. Conv and
dense kernels are lecun-normal; dense biases, BN scales and shifts and BN
running statistics are drawn too (not the identity), so that the eval
path's folding of BN into the convolutions is exercised.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _kind(key: str, shape: Tuple[int, ...]) -> str:
    leaf = key.rsplit(".", 1)[-1]
    owner = key.rsplit(".", 2)[-2] if key.count(".") else ""
    is_bn = owner == "bn" or owner.startswith("BatchNorm")
    if leaf == "num_batches_tracked":
        return "zero"
    if is_bn:
        return {"weight": "scale", "bias": "shift", "running_mean": "shift",
                "running_var": "scale"}[leaf]
    if leaf == "weight" and len(shape) >= 2:
        return "kernel"
    if leaf == "bias":
        return "shift"
    raise ValueError(f"weights: no rule for {key} {shape}")


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Tensors for every entry of `shapes` ({key: (shape, dtype)}, a model's
    state_dict order), from one Gaussian and one uniform draw of a
    torch.Generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    kinds = {k: _kind(k, s) for k, (s, _) in shapes.items()}
    sizes = {k: int(torch.Size(s).numel()) for k, (s, _) in shapes.items()}
    n_normal = sum(sizes[k] for k in shapes if kinds[k] in ("kernel", "shift"))
    n_uniform = sum(sizes[k] for k in shapes if kinds[k] == "scale")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for key, (shape, dtype) in shapes.items():
        kind, n = kinds[key], sizes[key]
        if kind == "kernel":
            fan_in = n // shape[0]
            t = normal[i:i + n] / fan_in ** 0.5
            i += n
        elif kind == "shift":
            t = normal[i:i + n] * 0.05
            i += n
        elif kind == "scale":
            t = 0.8 + 0.4 * uniform[j:j + n]
            j += n
        else:
            t = torch.zeros(n, device=device)
        out[key] = t.reshape(shape).to(dtype).clone()
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{key: (shape, dtype)} of a module's state_dict."""
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
