"""The two differentiable collectives of the sharded pricers.

A sharded price is a per-rank computation on replicated inputs whose result
is summed over the ranks; every rank then holds the same price.  Its
derivative needs a matching pair of autograd functions, of which exactly
one reduces:

- :func:`all_reduce_sum` (per-rank → replicated): the forward sums over the
  group, the backward passes the cotangent through.  A replicated value's
  cotangent is the same on every rank, and that is each rank's share.
- :func:`replicate` (replicated → per-rank): the forward is the identity on
  the tensors that require grad, the backward sums their per-rank gradients
  over the groups, in one all-reduce.

So ``torch.autograd.grad`` of a sharded price on any rank equals the
single-device gradient.  ``torch.distributed.nn.functional.all_reduce``
is not such a pair: its backward also all-reduces, which gives each rank
the group size times its own share.  A value computed alike on every rank
after the reduction (a discount factor of the rate) takes the caller's own
tensors, not the replicated copies, or its gradient would be summed too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import map_leaves, tree_leaves

__all__ = ["all_reduce_sum", "replicate"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        out = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        ctx.layout = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        device = ctx.layout[0][2]
        flat = torch.cat([ct.to(device=device, dtype=torch.float64).reshape(-1) for ct in cts])
        for group in ctx.groups:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        grads, start = [], 0
        for shape, dtype, dev in ctx.layout:
            n = shape.numel()
            grads.append(flat[start:start + n].reshape(shape).to(device=dev, dtype=dtype))
            start += n
        return (None, *grads)


def all_reduce_sum(x: torch.Tensor, *groups) -> torch.Tensor:
    """The sum of ``x`` over the ranks of each group in turn (a group may be
    a ``torch.distributed`` group or a mesh dimension's); its backward is the
    identity."""
    return _AllReduceSum.apply(x, groups)


def replicate(tree, *groups):
    """``tree`` (a problem, a market, a tuple of them) with each tensor leaf
    that requires grad replaced by a copy whose gradient is summed over the
    ranks of ``groups`` in the backward: the input of a per-rank computation
    on values every rank holds alike."""
    wanted = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor) and x.requires_grad]
    unique = list({id(x): x for x in wanted}.values())
    if not unique or not torch.is_grad_enabled():
        return tree
    copies = dict(zip((id(x) for x in unique), _Replicate.apply(groups, *unique)))
    return map_leaves(lambda x: copies.get(id(x), x) if isinstance(x, torch.Tensor) else x, tree)
