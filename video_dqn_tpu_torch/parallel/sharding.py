"""The partition rule of the Q-net's parameters and the collectives that
let a layer hold one shard (counterpart of
video_dqn_tpu/parallel/sharding.py).

The rule is the JAX package's: a `top` Linear whose output features are a
multiple of 128 splits them over the model axis, weight and bias (Flax's
kernel is (in, out) split on dim 1; torch's weight is (out, in), split on
dim 0); everything else is replicated. For extra_capacity that is `top.0`
(-> 512) and `top.2` (-> 256); `top.4` (-> 15) and the basic head (-> 15)
are replicated.

XLA inserts the collectives a sharded layer needs; here `ShardedLinear`
runs Megatron's pair around its local product:
  * `copy_to_model`: identity forward; the backward all-reduces the input's
    gradient over the model group (each rank holds the part that flows
    through its own output features);
  * `gather_from_model`: the forward all-gathers the output shards; the
    backward keeps this rank's slice of the gradient. What follows is
    replicated, so every model rank already holds the whole gradient.
    (torch.distributed.nn.functional.all_gather reduce-scatters in its
    backward, which would multiply the head's gradients by M.)
`all_reduce_sum` is the differentiable all-reduce of the synced BatchNorm's
sums (models/resnet.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import MODEL_AXIS, Mesh

LANES = 128  # output features of a sharded layer are a multiple of this


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        ctx.width = y.shape[-1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_from_model(y: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromModel.apply(y, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


class ShardedLinear(nn.Linear):
    """A Linear holding this rank's block of output features (rows of the
    weight, entries of the bias); its output is the whole layer's, the same
    on every rank of the model group."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        nn.Module.__init__(self)  # no init draw: the weights are the Linear's
        self.in_features = linear.in_features
        self.out_features = linear.out_features // mesh.model
        self.full_out = linear.out_features
        self.mesh = mesh
        self.weight = nn.Parameter(mesh.shard(linear.weight.detach()).clone())
        bias = linear.bias
        self.bias = None if bias is None else nn.Parameter(mesh.shard(bias.detach()).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.mesh.model_group
        return gather_from_model(F.linear(copy_to_model(x, group), self.weight, self.bias),
                                 group)


def sharded(name: str, module: nn.Module) -> bool:
    """The partition rule: a `top` Linear with a multiple of 128 outputs."""
    full = getattr(module, "full_out", getattr(module, "out_features", 0))
    return name.split(".")[0] == "top" and isinstance(module, nn.Linear) and full % LANES == 0


def param_specs(model: nn.Module) -> Dict[str, Optional[str]]:
    """Per parameter name, the mesh axis its dim 0 is split over, or None
    (replicated); the same whether or not the model is sharded yet."""
    specs = {}
    for name, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            specs[f"{name}.{pname}" if name else pname] = \
                MODEL_AXIS if sharded(name, module) else None
    return specs


def shard_head(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace, in place, each Linear the rule shards by a ShardedLinear
    holding this rank's shard. Nothing on a model axis of 1."""
    if mesh.model == 1:
        return model
    for name, module in list(model.named_modules()):
        if sharded(name, module) and not isinstance(module, ShardedLinear):
            if module.out_features % mesh.model:
                raise ValueError(f"{name}: {module.out_features} features not divisible by "
                                 f"model={mesh.model}")
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child, ShardedLinear(module, mesh))
    return model


def local_tensor(name: str, t: torch.Tensor, specs: Mapping[str, Optional[str]],
                 mesh: Mesh) -> torch.Tensor:
    """The whole tensor of parameter `name` (or of its Adam moment) ->
    this rank's: its shard's rows where the name is sharded."""
    return mesh.shard(t) if specs.get(name) else t


def full_tensor(name: str, t: torch.Tensor, specs: Mapping[str, Optional[str]],
                mesh: Mesh) -> torch.Tensor:
    """This rank's tensor of `name` -> the whole one, gathered over the
    model group where the name is sharded (a collective: every rank of the
    group calls it, for the same names in the same order)."""
    return mesh.gather_model(t) if specs.get(name) else t
