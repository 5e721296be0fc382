"""Tensor parallelism over the mesh's `model` axis (counterpart of
medvae_tpu/parallel/tensor_parallel.py).

The rule is the JAX package's (`param_sharding_rule`, :26-47) read on
torch's layout: a conv or dense kernel shards its output features over
`model` when that axis divides by m and is at least 2·m. The output axis is
dim 0 of `Conv2d.weight` (Cout, Cin/groups, kh, kw) and of `Linear.weight`
(Out, In), where JAX reads the last axis of (kh, kw, Cin, Cout) and
(In, Out). Biases, norms and scalars replicate; the optimizer's moments and
the EMA mirror the params, so they are sharded alike.

The forward is the column-parallel layer that XLA's SPMD partitioner builds
from those shardings: a sharded conv or dense computes its own output
channels without bias, the channels are all-gathered over the model group
(parallel/collectives.py:gather_channels), and the full bias is added. Every
model rank then runs the same downstream on the same rows, so the kernels
B4-B7 see full channels and the gather's backward is the rank's slice of
the cotangent; the layer's input sums its gradient over the model group
(each shard gives only its rows' part of it). The data-parallel step pmeans the gradients over the batch
group only, and the optimizer's global norm, which its clip and the step's
`train/grad_norm` take, sums the shards' squares over the model group
(`with_tp_norm`).

A grouped conv (the flagship's `heads_conv2`, groups = modalities) whose
shard does not hold whole groups is computed group by group: each group the
shard touches convolves its own input channels with the shard's rows of
that group. So `heads_conv2` shards wherever the rule says, as in JAX.

Checkpoints hold full tensors (`ShardLayout.full` gathers before rank 0
saves, `ShardLayout.local` slices after every rank loads), so a
data-parallel checkpoint resumes under tensor parallelism and the reverse.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from medvae_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from medvae_tpu_torch.parallel.collectives import all_reduce_sum, gather_channels, sum_gradients


def param_sharding_rule(path: Sequence[str], shape: Sequence[int], model_size: int) -> Optional[int]:
    """The dim a param shards over `model` (0, its output features), or
    None to replicate: JAX's rule with `kernel` read as a conv's or
    dense's `weight` of two or more dims."""
    name = path[-1] if path else ""
    if (model_size > 1 and name == "weight" and len(shape) >= 2
            and shape[0] % model_size == 0 and shape[0] >= 2 * model_size):
        return 0
    return None


@dataclasses.dataclass
class ColumnShard:
    """A column-parallel layer's shard: rows [rank·k, (rank+1)·k) of its
    `out_features` output channels, gathered over `group`."""

    group: object
    size: int
    rank: int
    out_features: int
    groups: int = 1

    @property
    def rows(self) -> int:
        return self.out_features // self.size

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full tensor."""
        return full.narrow(0, self.rank * self.rows, self.rows)

    def full(self, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's rows (no gradient)."""
        return gather_channels(shard.detach(), 0, self.group)

    def _add_bias(self, y: torch.Tensor, bias: Optional[torch.Tensor], dim: int) -> torch.Tensor:
        if bias is None:
            return y
        shape = [1] * y.dim()
        shape[dim] = -1
        return y + bias.view(shape)

    def conv(self, module: nn.Conv2d, x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The conv's output with this rank's rows computed here and the
        rest gathered; `weight` is the (cast) shard."""
        conv = functools.partial(F.conv2d, stride=module.stride, padding=module.padding,
                                 dilation=module.dilation)
        x = sum_gradients(x, self.group)
        if self.groups == 1:
            y = conv(x, weight, None)
        else:
            og, ig = self.out_features // self.groups, x.shape[1] // self.groups
            lo, hi = self.rank * self.rows, (self.rank + 1) * self.rows
            if lo % og == 0 and hi % og == 0:  # whole groups: one grouped conv
                y = conv(x[:, lo // og * ig:hi // og * ig], weight, None, groups=(hi - lo) // og)
            else:  # a group split between ranks: group by group
                parts = []
                for j in range(lo // og, (hi - 1) // og + 1):
                    a, b = max(lo, j * og), min(hi, (j + 1) * og)
                    parts.append(conv(x[:, j * ig:(j + 1) * ig], weight[a - lo:b - lo], None))
                y = torch.cat(parts, dim=1)
        return self._add_bias(gather_channels(y, 1, self.group), bias, 1)

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """A dense (or 1x1 conv on tokens) over the last dim, column-parallel."""
        y = F.linear(sum_gradients(x, self.group), weight)
        return self._add_bias(gather_channels(y, -1, self.group), bias, -1)


def _plain_conv_forward(module: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return module.column.conv(module, x, module.weight, module.bias)


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, ColumnShard]:
    """Shard `model`'s convs and denses in place by the rule: each such
    module's `weight` becomes this rank's rows (a new Parameter) and the
    module computes column-parallel. Returns {param name: shard} of the
    weights it sharded (empty when mesh.model is 1). Call it once, after the
    full weights are in place and the same on every rank."""
    m = mesh.model
    shards: Dict[str, ColumnShard] = {}
    if m <= 1:
        return shards
    from medvae_tpu_torch.nn.blocks import Conv2d

    group = mesh.group(MODEL_AXIS)
    for mod_name, module in model.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.Linear)):
            continue
        w = module.weight
        if param_sharding_rule(("weight",), tuple(w.shape), m) is None:
            continue
        shard = ColumnShard(group=group, size=m, rank=mesh.model_rank, out_features=int(w.shape[0]),
                            groups=int(getattr(module, "groups", 1)))
        module.weight = nn.Parameter(shard.local(w.detach()).clone(), requires_grad=w.requires_grad)
        module.column = shard
        if isinstance(module, nn.Conv2d) and not isinstance(module, Conv2d):
            module.forward = functools.partial(_plain_conv_forward, module)
        shards[f"{mod_name}.weight" if mod_name else "weight"] = shard
    return shards


def state_shardings(params: Dict[str, torch.Tensor], model_size: int) -> Dict[str, Optional[int]]:
    """{param name: the dim it shards over `model`, or None} for a full
    param dict (the moments and the EMA follow their params), the port's
    `state_shardings`."""
    return {name: param_sharding_rule(tuple(name.split(".")), tuple(p.shape), model_size)
            for name, p in params.items()}


class ShardLayout:
    """Where the sharded params of a run are: `full(param, t)` is the full
    tensor of `t` (the param itself, a moment or the EMA of that param;
    collective), `local(param, t)` this rank's rows of a full one."""

    def __init__(self, modules: Sequence[nn.Module] = ()):
        self._by_param: Dict[int, ColumnShard] = {}
        for module in modules:
            for sub in module.modules():
                shard = getattr(sub, "column", None)
                if shard is not None:
                    self._by_param[id(sub.weight)] = shard

    def shard_of(self, param: torch.Tensor) -> Optional[ColumnShard]:
        return self._by_param.get(id(param))

    def full(self, param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        shard = self.shard_of(param)
        return t if shard is None else shard.full(t)

    def local(self, param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        shard = self.shard_of(param)
        return t if shard is None else shard.local(t)


def tp_norm(params: Sequence[torch.Tensor], layout: ShardLayout) -> Callable:
    """The global norm of gradients in `params`' order whose sharded
    entries hold only this rank's rows: the shards' squares summed over the
    model group, plus the replicated ones' (counted once)."""
    flags = [layout.shard_of(p) for p in params]
    group = next((s.group for s in flags if s is not None), None)

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        rep = sum((g.float().square().sum() for g, s in zip(grads, flags) if s is None), zero)
        sh = sum((g.float().square().sum() for g, s in zip(grads, flags) if s is not None), zero.clone())
        return torch.sqrt(rep + all_reduce_sum(sh, group))

    return norm


def with_tp_norm(tx, params: Sequence[torch.Tensor], layout: ShardLayout):
    """`tx` whose norm (its clip's and the step's `train/grad_norm`) is the
    whole gradients' (itself when nothing in `params` is sharded)."""
    if not any(layout.shard_of(p) is not None for p in params):
        return tx
    return dataclasses.replace(tx, norm=tp_norm(params, layout))
