"""Tiled linear layers (port of ``deepspeed_tpu/runtime/zero/tiling.py``;
the reference's ``TiledLinear``).

A Linear of ``in_features x features`` stored as an ``in_splits x
out_splits`` grid of ``[in / in_splits, out / out_splits]`` parameters
named ``tile_{i}_{j}`` (the Flax ``[in, out]`` orientation, as the JAX
module keeps them), so each tile is its own ZeRO leaf: the engine decides
its sharding alone and a stage-3 gather never moves more than one tile.
The product loops over the output tiles, summing the input tiles'
products. A fresh tile is drawn from a normal truncated at 2 std with the
variance of the WHOLE fan-in (``1 / in_features``, flax
``variance_scaling(1 / in_splits, "fan_in", "truncated_normal")`` of a
tile), so the layer starts with ``nn.Dense``'s output statistics; the bias
starts at zero.
"""

import torch
from torch import nn


def _splits(total, n):
    if total % n != 0:
        raise ValueError(f"cannot split {total} into {n} even tiles")
    return total // n


class TiledLinear(nn.Module):
    """Drop-in linear layer with a tiled weight (module docstring). ``dtype``
    is the compute dtype (default: the input's); parameters are fp32."""

    def __init__(self, in_features, features, in_splits=1, out_splits=1, use_bias=True,
                 dtype=None, device=None, generator=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.dtype = dtype
        di, dj = _splits(in_features, in_splits), _splits(features, out_splits)
        std = (1.0 / in_features) ** 0.5 / 0.87962566103423978
        for j in range(out_splits):
            for i in range(in_splits):
                w = torch.empty(di, dj, dtype=torch.float32, device=device)
                if not w.is_meta:
                    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    w.mul_(std)
                self.register_parameter(f"tile_{i}_{j}", nn.Parameter(w))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device)) \
            if use_bias else None

    def _contract(self, x):
        dtype = self.dtype or x.dtype
        di = self.in_features // self.in_splits
        xs = [x[..., i * di:(i + 1) * di] for i in range(self.in_splits)]
        outs = []
        for j in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                part = xs[i] @ getattr(self, f"tile_{i}_{j}").to(dtype)
                acc = part if acc is None else acc + part
            outs.append(acc)
        y = torch.cat(outs, dim=-1)
        return y, None if self.bias is None else self.bias.to(dtype)

    def forward(self, x):
        y, bias = self._contract(x)
        return y if bias is None else y + bias

    @staticmethod
    def from_dense_kernel(kernel, in_splits, out_splits):
        """The tiles of a dense ``[in, out]`` kernel by parameter name (the
        reference's ``copy_params_from``)."""
        di = _splits(kernel.shape[0], in_splits)
        dj = _splits(kernel.shape[1], out_splits)
        return {f"tile_{i}_{j}": kernel[i * di:(i + 1) * di, j * dj:(j + 1) * dj]
                for i in range(in_splits) for j in range(out_splits)}


class TiledLinearReturnBias(TiledLinear):
    """Returns ``(output without bias, bias)`` so a caller can defer the
    bias add (the reference's ``TiledLinearReturnBias``)."""

    def forward(self, x):
        return self._contract(x)
