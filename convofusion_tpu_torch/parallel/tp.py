"""Tensor parallelism: the JAX package's placement rules over the port's
parameter names, and the column- and row-parallel layers they imply.

Counterpart of ``convofusion_tpu/parallel/tp.py:22-83``.  JAX places each
parameter leaf with a ``PartitionSpec`` over the ('data', 'model') mesh and
lets XLA insert the collectives.  Here each model rank keeps, as a plain
parameter, the elements JAX puts on it, and the modules that own those
parameters compute on their shard with explicit collectives over the
'model' group (Megatron's pattern):

* a column-parallel ``Linear`` (JAX ``P(None, 'model')`` on a flax (in, out)
  kernel; the torch (out, in) weight and its bias split along dim 0) takes a
  replicated input through :meth:`ModelAxis.copy_to` (identity forward,
  all-reduce of the input's gradient) and leaves its output split, or
  all-gathers it where a residual add needs it whole (the TimeBlock's
  ``out_layers.2``);
* a row-parallel ``Linear`` (``P('model', None)``: weight dim 1) takes the
  split input and all-reduces its output before the replicated bias;
* the packed q/k/v (``in_proj_weight`` / ``in_proj_bias``, the reference's
  layout, ``compat/from_jax.py``) splits each third along dim 0, as JAX
  splits ``q_proj``, ``k_proj`` and ``v_proj`` each: model rank r holds
  ``[q_r; k_r; v_r]`` (:class:`Packed`), and the attention runs on its own
  heads when they divide by the model ranks, else on all-gathered q/k/v
  (the single-head cross-attention streams);
* a dropout between a column- and a row-parallel layer draws its mask at
  the whole activation's shape and keeps this rank's slice, so every model
  rank advances the shared generator alike and the masks are one
  process's.

A parameter whose split dimension does not divide by the model ranks stays
replicated, as JAX skips such a spec (``:48-59``).  The rules place every
matching parameter, trainable or frozen (the T5 trunk's ``wi`` / ``wo``, the
VAE's layers), as JAX's do.  Placement mutates the model: build the
:class:`~convofusion_tpu_torch.train.trainer.Trainer` after it (its ``mesh``
argument places the model itself).  Replicated parameters get the same
gradient on every model rank; a split one its shard's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard


@dataclasses.dataclass(frozen=True)
class Packed:
    """``Shard(dim)`` of each of ``parts`` equal blocks of ``dim``: the
    packed q/k/v, rank r holding ``[q_r; k_r; v_r]``."""
    dim: int
    parts: int


# (port parameter name, placement on the 'model' axis); JAX's rules
# (convofusion_tpu/parallel/tp.py:22-38) through compat/from_jax's names and
# (in, out) -> (out, in) transposes.  Anything unmatched stays replicated.
TP_RULES: List[Tuple[str, object]] = [
    # FFN: linear1 column-parallel (kernel and bias), linear2 row-parallel
    (r".*\.linear1\.(weight|bias)", Shard(0)),
    (r".*\.linear2\.weight", Shard(1)),
    # TimeBlock out layers (d -> d) column-parallel on the output
    (r".*\.time_block\d\.out_layers\.2\.(weight|bias)", Shard(0)),
    # attention: q/k/v column-parallel, each third of the packed tensor
    (r".*\.in_proj_(weight|bias)", Packed(0, 3)),
    (r".*\.out_proj\.weight", Shard(1)),
    # T5 feed-forward
    (r".*\.DenseReluDense\.wi\.weight", Shard(0)),
    (r".*\.DenseReluDense\.wo\.weight", Shard(1)),
]

# column-parallel Linears whose output a residual add needs whole
_GATHERED = re.compile(r".*\.time_block\d\.out_layers\.2")
# a column-parallel Linear that leaves its output split -> the Dropout on
# that output, beside it in the same module
_SPLIT_DROPOUTS = {"linear1": "ffn_dropout", "wi": "dropout"}

COLUMN, ROW = "column", "row"


# ------------------------------------------------------------- collectives
Function = torch.autograd.Function


class _CopyTo(Function):
    """Identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(Function):
    """Sum over the model ranks forward; identity backward (what follows is
    replicated, so each rank's gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x, dim, group, size):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherFrom(Function):
    """All-gather along ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _all_gather(x, dim, axis.group, axis.size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.rank * ctx.n,
                           ctx.n).contiguous(), None, None


class _ScatterTo(Function):
    """This rank's slice along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.axis.group,
                           ctx.axis.size), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's place on the mesh's 'model' axis and its group."""
    group: object
    rank: int
    size: int

    @classmethod
    def of(cls, mesh) -> "ModelAxis":
        return cls(mesh.get_group("model"), mesh.get_local_rank("model"),
                   mesh.size(1))

    def copy_to(self, x):
        return _CopyTo.apply(x, self.group)

    def reduce_from(self, x):
        return _ReduceFrom.apply(x, self.group)

    def gather_from(self, x, dim=-1):
        return _GatherFrom.apply(x, self, dim % x.dim())

    def scatter_to(self, x, dim=-1):
        return _ScatterTo.apply(x, self, dim % x.dim())


def reduce_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model ranks (no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=axis.group)
    return x


def linear(module, x):
    """A split ``Linear``'s forward (``module.tp`` = (axis, COLUMN | ROW,
    gather)): the input cast to the weight's dtype, as ``Linear`` does."""
    axis, mode, gather = module.tp
    x = x.to(module.weight.dtype)
    if mode == ROW:
        y = axis.reduce_from(torch.nn.functional.linear(x, module.weight))
        return y if module.bias is None else y + module.bias
    y = torch.nn.functional.linear(axis.copy_to(x), module.weight,
                                   module.bias)
    return axis.gather_from(y, -1) if gather else y


# --------------------------------------------------------------- placement
def placement_for(name: str, shape, n_model: int):
    """The placement of parameter ``name`` of ``shape`` on a 'model' axis of
    ``n_model`` ranks: the first matching rule's, if its split dimension
    divides, else ``Replicate()``."""
    for pattern, placement in TP_RULES:
        if re.fullmatch(pattern, name):
            dim = placement.dim
            parts = placement.parts if isinstance(placement, Packed) else 1
            if dim < len(shape) and shape[dim] % (parts * n_model) == 0:
                return placement
            return Replicate()
    return Replicate()


def local_shard(tensor: torch.Tensor, placement, n_model: int, r: int
                ) -> torch.Tensor:
    """The elements model rank ``r`` of ``n_model`` holds of ``tensor``
    under ``placement`` (a view where it can be)."""
    if isinstance(placement, Replicate):
        return tensor
    if isinstance(placement, Packed):
        blocks = tensor.chunk(placement.parts, placement.dim)
        return torch.cat([local_shard(b, Shard(placement.dim), n_model, r)
                          for b in blocks], placement.dim)
    n = tensor.shape[placement.dim] // n_model
    return tensor.narrow(placement.dim, r * n, n)


def full_tensor(local: torch.Tensor, placement, axis: ModelAxis
                ) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard, gathered
    over the model ranks (a collective: every model rank calls it)."""
    if isinstance(placement, Replicate):
        return local
    parts = [torch.empty_like(local) for _ in range(axis.size)]
    dist.all_gather(parts, local.detach().contiguous(), group=axis.group)
    if isinstance(placement, Packed):
        per_rank = [p.chunk(placement.parts, placement.dim) for p in parts]
        return torch.cat([torch.cat([blocks[i] for blocks in per_rank],
                                    placement.dim)
                          for i in range(placement.parts)], placement.dim)
    return torch.cat(parts, placement.dim)


def tp_placements(model: nn.Module, mesh) -> Dict[str, Tuple]:
    """Parameter name -> its placements over ('data', 'model'):
    ``Replicate()`` over 'data' and :func:`placement_for` over 'model'.
    Reads the global shapes, so call it on an unplaced model (a placed one
    answers from its record)."""
    placed = getattr(model, "tp_placements", None)
    if placed is not None:
        return dict(placed)
    n_model = mesh.size(1)
    return {name: (Replicate(), placement_for(name, p.shape, n_model))
            for name, p in model.named_parameters()}


def placed_mesh(model: nn.Module):
    """The mesh :func:`apply_tp` placed ``model`` on, or None."""
    return getattr(model, "tp_mesh", None)


def apply_tp(model: nn.Module, mesh) -> nn.Module:
    """Keep on this rank only the elements its model index holds under
    :func:`tp_placements`, and switch the modules that own a split
    parameter to their parallel forward.  Idempotent on one mesh; raises on
    a model placed on another."""
    done = placed_mesh(model)
    if done is mesh:
        return model
    if done is not None:
        raise ValueError("the model is already placed on another mesh")
    placements = tp_placements(model, mesh)
    axis = ModelAxis.of(mesh)
    owners = {}
    for name, (_, placement) in placements.items():
        if isinstance(placement, Replicate):
            continue
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        old = getattr(module, leaf)
        new = nn.Parameter(
            local_shard(old.detach(), placement, axis.size,
                        axis.rank).clone(),
            requires_grad=old.requires_grad)
        setattr(module, leaf, new)
        owners[owner] = (module, placement)
    for owner, (module, placement) in owners.items():
        if isinstance(placement, Packed):          # the attention
            module.tp = axis
            if module.num_heads % axis.size == 0:  # it attends on its heads
                module.attn_dropout.shard = (axis, 1)
            continue
        mode = COLUMN if placement.dim == 0 else ROW
        gather = mode == COLUMN and _GATHERED.fullmatch(owner) is not None
        module.tp = (axis, mode, gather)
        parent, _, leaf = owner.rpartition(".")
        if mode == COLUMN and not gather:
            dropout = getattr(model.get_submodule(parent),
                              _SPLIT_DROPOUTS[leaf])
            dropout.shard = (axis, -1)
    model.tp_mesh, model.tp_placements = mesh, placements
    return model


def describe_tp(model: nn.Module, mesh) -> Dict[str, int]:
    """Counts of split and replicated parameters, and their elements in the
    whole model (for logs and tests).  JAX counts its q, k and v leaves
    apart where the port packs them in one tensor, so the element totals
    are what compare."""
    counts = {"sharded": 0, "replicated": 0, "sharded_elements": 0,
              "replicated_elements": 0}
    n_model = mesh.size(1)
    params = dict(model.named_parameters())
    for name, (_, placement) in tp_placements(model, mesh).items():
        kind = "replicated" if isinstance(placement, Replicate) \
            else "sharded"
        numel = params[name].numel()
        if placed_mesh(model) is not None and kind == "sharded":
            numel *= n_model
        counts[kind] += 1
        counts[f"{kind}_elements"] += numel
    return counts


def model_axis(model: nn.Module) -> Optional[ModelAxis]:
    """The 'model' axis of a placed model, or None."""
    mesh = placed_mesh(model)
    return None if mesh is None else ModelAxis.of(mesh)
