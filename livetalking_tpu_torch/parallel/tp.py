"""The tensor-parallel conv seam.

A conv whose parameters ``parallel.mesh.shard_params`` split over tp
holds this rank's slice of output channels. It computes that slice, then
gathers the channels over the tp group, so activations between layers are
whole on every tp rank: the layout XLA's partitioner reaches for the JAX
package's specs. Each output channel sums over the same inputs as in the
whole conv, so only the library's choice of algorithm for the narrower
conv can move a result (by rounding).

  - ``TPConv``: a ``{"w", "b"}`` node of a parameter tree (the U-Net's and
    the VAE's), recognised by ``diffusion_blocks.conv``/``conv_asym``;
  - ``TPConv2d``: the module that replaces an ``nn.Conv2d`` or
    ``nn.ConvTranspose2d`` (Wav2Lip's ``ConvLayer``).

The gather is differentiable (``gather_channels``): its backward hands
each rank the slice of the gradient that belongs to its channels. Every tp
rank computes the same loss from the same whole activations, so that slice
is the gradient of its shard; no collective runs in the backward.
"""

from __future__ import annotations

import torch
from torch import nn


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.tp_rank, ctx.c = mesh.tp_rank, x.shape[-1]
        tp = mesh.shape["tp"]
        g = mesh.all_gather(x, "tp")  # (tp * B, ..., c)
        g = g.reshape((tp,) + tuple(x.shape)).movedim(0, -2)  # (B, ..., tp, c)
        return g.reshape(tuple(x.shape[:-1]) + (tp * ctx.c,))

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.tp_rank * ctx.c
        return grad[..., lo:lo + ctx.c], None


def gather_channels(x: torch.Tensor, mesh) -> torch.Tensor:
    """(..., c) on each tp rank -> (..., tp * c), channels in tp order."""
    if mesh.shape["tp"] == 1:
        return x
    return _GatherChannels.apply(x, mesh)


def _slice(t: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    k = t.shape[axis] // mesh.shape["tp"]
    return t.narrow(axis, mesh.tp_rank * k, k).clone()


class TPConv(dict):
    """A conv node ``{"w": (O/tp, I, kh, kw), "b": (O/tp,)}`` holding this
    rank's output channels; ``mesh`` gathers them."""

    def __init__(self, node: dict, mesh):
        super().__init__(node)
        self.mesh = mesh

    @classmethod
    def from_whole(cls, node: dict, mesh) -> "TPConv":
        return cls({k: (None if v is None else _slice(v, 0, mesh)) for k, v in node.items()},
                   mesh)


def gather_conv_output(p, y_nhwc: torch.Tensor) -> torch.Tensor:
    """A conv's NHWC output, its channels gathered when ``p`` is a
    ``TPConv`` (``diffusion_blocks.conv``'s seam)."""
    return gather_channels(y_nhwc, p.mesh) if isinstance(p, TPConv) else y_nhwc


class TPConv2d(nn.Module):
    """An ``nn.Conv2d`` or ``nn.ConvTranspose2d`` with this rank's output
    channels; NCHW in and out (channels-last memory, as the modules run)."""

    def __init__(self, conv: nn.Module, mesh):
        super().__init__()
        self.conv = conv
        self.mesh = mesh

    @classmethod
    def from_whole(cls, conv: nn.Module, mesh) -> "TPConv2d":
        """Take over ``conv`` (a copy the caller owns), cut to this rank's
        output channels."""
        axis = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
        w = conv.weight
        conv.weight = nn.Parameter(_slice(w.data, axis, mesh), requires_grad=w.requires_grad)
        if conv.bias is not None:
            conv.bias = nn.Parameter(_slice(conv.bias.data, 0, mesh),
                                     requires_grad=conv.bias.requires_grad)
        conv.out_channels //= mesh.shape["tp"]
        return cls(conv, mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)  # (B, O/tp, H, W)
        return gather_channels(y.permute(0, 2, 3, 1), self.mesh).permute(0, 3, 1, 2)

