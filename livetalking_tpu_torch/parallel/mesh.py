"""Device meshes and the sharding rule (ports livetalking_tpu/parallel/mesh.py).

Usage, on every rank of a group (``parallel.dist``):

    mesh = make_mesh("dp=2,tp=2")
    params = shard_params(params, mesh)   # tp: the large convs' output channels
    batch = shard_batch(batch, mesh)      # dp: this rank's rows
    out = gather_batch(step(params, batch), mesh)

The JAX package places whole arrays with shardings and XLA's partitioner
inserts the collectives. Here each rank holds its own pieces and the
collectives are explicit: a tp-sharded conv gathers its output channels
over the tp group (``parallel/tp.py``), ``gather_batch`` gathers rows over
dp. Ranks are laid out row-major, as ``np.reshape(devices, (dp, tp))``
lays out JAX's mesh: rank = dp index * tp + tp index.

The mesh is ``torch.distributed.device_mesh.init_device_mesh`` over the
group (NCCL groups on CUDA, gloo otherwise). Outside any group a mesh has
one rank and every collective is the identity.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from livetalking_tpu_torch.parallel import dist as pdist
from livetalking_tpu_torch.parallel.tp import TPConv, TPConv2d

DP_AXIS = "dp"
TP_AXIS = "tp"


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'dp=4,tp=2' -> {'dp': 4, 'tp': 2}."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        out[name.strip()] = int(val)
    return out


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a dp x tp mesh: the axis sizes (``shape``), its
    coordinates, its device, and the groups of its dp row and tp column."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    dp_group: Any = None
    tp_group: Any = None
    world_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp_rank(self) -> int:
        return self.rank // self.shape[TP_AXIS]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.shape[TP_AXIS]

    def group(self, axis: Optional[str]):
        """The group over ``axis`` (None: every rank) and its size."""
        if axis is None:
            return self.world_group, self.size
        return (self.dp_group if axis == DP_AXIS else self.tp_group), self.shape[axis]

    def all_gather(self, t: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        return pdist.all_gather(t, *self.group(axis))

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        return pdist.all_reduce_(t, *self.group(axis))

    def broadcast_(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Rank 0's ``t`` (of the axis's group) on every rank, in place."""
        return pdist.broadcast_(t, *self.group(axis))


# one mesh per shape and process: the groups are made collectively, once
_meshes: Dict[tuple, Mesh] = {}


def make_mesh(spec: str = "", devices: Optional[Sequence] = None) -> Mesh:
    """Build the mesh from a spec string over every rank of the group; an
    empty spec puts all of them on dp. A spec whose product is not the
    number of ranks raises ``ValueError``.

    Outside a group the mesh has the one device ``devices[0]`` (the card by
    default). ``devices`` inside a group must list one device per rank."""
    info = pdist.current()
    if info is not None:
        n = info.world_size
    else:
        n = 1 if devices is None else len(devices)
    dims = parse_mesh_spec(spec) if spec else {DP_AXIS: n}
    unknown = set(dims) - {DP_AXIS, TP_AXIS}
    if unknown:
        raise ValueError(f"mesh spec {dims}: unknown axis {sorted(unknown)} "
                         f"(axes are {DP_AXIS!r} and {TP_AXIS!r})")
    size = math.prod(dims.values())
    if size != n:
        raise ValueError(f"mesh spec {dims} needs {size} devices, have {n}")
    dp, tp = dims.get(DP_AXIS, 1), dims.get(TP_AXIS, 1)
    shape = {DP_AXIS: dp, TP_AXIS: tp}
    if info is None:
        from livetalking_tpu_torch.utils.device import resolve_device

        return Mesh(shape, 0, resolve_device(devices[0] if devices else "cuda"))
    if devices is not None and torch.device(devices[info.rank]) != info.device:
        raise ValueError(f"rank {info.rank} runs on {info.device}, not {devices[info.rank]}")
    key = (dp, tp)
    if key not in _meshes:
        from torch.distributed.device_mesh import init_device_mesh

        # gloo groups carry CUDA tensors too (the one-card check): the mesh's
        # device type names the backend's, not the tensors'
        dm = init_device_mesh("cuda" if info.backend == "nccl" else "cpu", (dp, tp),
                              mesh_dim_names=(DP_AXIS, TP_AXIS))
        _meshes[key] = Mesh(shape, info.rank, info.device, dm.get_group(DP_AXIS),
                            dm.get_group(TP_AXIS), dist.group.WORLD)
    return _meshes[key]


def default_mesh_for(n_devices: int) -> Mesh:
    """Factor n into a dp x tp mesh (tp=2 when n is even and >= 4): batch
    parallel first, channel parallel second. Raises when fewer ranks
    exist."""
    info = pdist.current()
    have = 1 if info is None else info.world_size
    if have < n_devices:
        raise RuntimeError(
            f"default_mesh_for({n_devices}): only {have} rank(s); start {n_devices} with "
            "parallel.dist.Ranks / launch (or torchrun), one per device")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return make_mesh(f"{DP_AXIS}={n_devices // tp},{TP_AXIS}={tp}")


def param_spec(shape: Sequence[int], tp: int, transpose: bool = False) -> Optional[int]:
    """The axis of a conv weight to shard over tp, or None (replicate).

    JAX's rule (``_param_spec``) shards an HWIO kernel on its output
    channels (axis -1) when they are >= 128 and divisible by tp. The port
    keeps PyTorch's layouts: a conv weight is (O, I, kh, kw), so the
    output channels are axis 0; a transposed conv's is (I, O, kh, kw),
    axis 1. The conv's bias follows its weight. JAX's rule also shards
    other 1-D leaves >= 128 (norm scales, linear biases), which XLA
    gathers again before use; the port keeps those whole, as nothing it
    computes is sharded along them."""
    if len(shape) != 4 or tp <= 1:
        return None
    axis = 1 if transpose else 0
    o = shape[axis]
    return axis if o >= 128 and o % tp == 0 else None


def _shard_tree(node, mesh: Mesh):
    if isinstance(node, dict):
        w = node.get("w")
        if (isinstance(w, torch.Tensor) and param_spec(w.shape, mesh.shape[TP_AXIS]) == 0
                and set(node) <= {"w", "b"}):
            return TPConv.from_whole(node, mesh)
        return {k: _shard_tree(v, mesh) for k, v in node.items()}
    if isinstance(node, list):
        return [_shard_tree(v, mesh) for v in node]
    return node


def _shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    model = copy.deepcopy(model)
    tp = mesh.shape[TP_AXIS]
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if (isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)) and child.groups == 1
                    and param_spec(child.weight.shape, tp,
                                   isinstance(child, nn.ConvTranspose2d)) is not None):
                setattr(parent, name, TPConv2d.from_whole(child, mesh))
    return model


def shard_params(params: Any, mesh: Mesh) -> Any:
    """The parameters with their large convs' output channels split over
    tp (``param_spec``): a parameter tree (``{"w", "b"}`` conv nodes become
    ``TPConv`` nodes holding this rank's slice) or an ``nn.Module`` (a copy
    whose ``Conv2d``/``ConvTranspose2d`` become ``TPConv2d``). The steps
    take the result as they are (``diffusion_blocks.conv``, the modules'
    forward): the sharding travels with the parameters. Shard after
    ``prepare`` (it moves the tree, and makes plain dictionaries)."""
    if mesh.shape[TP_AXIS] == 1:
        return params
    if isinstance(params, nn.Module):
        return _shard_module(params, mesh)
    return _shard_tree(params, mesh)


def _rows(leaf, mesh: Mesh):
    dp = mesh.shape[DP_AXIS]
    n = leaf.shape[0]
    if n % dp:
        raise ValueError(f"batch of {n} rows does not split over dp={dp}")
    k = n // dp
    return leaf[mesh.dp_rank * k:(mesh.dp_rank + 1) * k]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's dp slice of the leading (batch) axis of every leaf
    (tensors or numpy arrays, in dicts, lists or alone)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return _rows(batch, mesh)
    return batch


def gather_batch(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of ``shard_batch`` for one tensor: every dp rank's rows,
    in dp order, on every rank."""
    return mesh.all_gather(t, DP_AXIS)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf as rank 0 holds it, on every rank's device."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [replicate(v, mesh) for v in tree]
    if isinstance(tree, torch.Tensor):
        return mesh.broadcast_(tree.to(mesh.device, copy=True))
    return tree


def _digest(tensors) -> torch.Tensor:
    """Two integer sums over the bits of every tensor (plain and position-
    weighted): equal on two ranks when the tensors are, to a 2^-64 chance."""
    d = torch.zeros(2, dtype=torch.int64, device=tensors[0].device)
    ints = {4: torch.int32, 2: torch.int16, 8: torch.int64}
    for t in tensors:
        v = t.detach().reshape(-1).view(ints[t.element_size()]).to(torch.int64)
        d[0] += v.sum()
        d[1] += (v * (torch.arange(v.numel(), device=v.device) % 8191 + 1)).sum()
    return d


def check_replicas(mesh: Mesh, tensors, step: int, axis: Optional[str] = None) -> None:
    """Raise unless ``tensors`` are bit-equal on every rank of ``mesh``
    (of its ``axis`` group)."""
    if mesh.group(axis)[1] == 1:
        return
    d = mesh.all_gather(_digest(tensors)[None], axis)
    if not bool((d == d[0]).all()):
        raise RuntimeError(f"parameters differ across ranks after step {step}: "
                           f"digests {d.tolist()}")


def all_reduce_mean(mesh: Mesh, grads) -> None:
    """Mean of ``grads`` over dp, in place: flattened into buckets of at
    most 256 MB per dtype, one all-reduce each (the training CLI's
    ``--mesh`` runs it before each optimizer update)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    dp = mesh.shape[DP_AXIS]
    if dp == 1:
        return
    buckets, cur, size = [], [], 0
    for g in grads:
        if cur and (g.dtype != cur[0].dtype or size + g.numel() * g.element_size() > 256 << 20):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(g)
        size += g.numel() * g.element_size()
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = mesh.all_reduce_(_flatten_dense_tensors(bucket), "dp").div_(dp)
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)
