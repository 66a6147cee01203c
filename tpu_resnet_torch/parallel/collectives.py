"""The collectives of the data-parallel step, over the default process
group: flat buckets (one collective for many tensors) and the
differentiable all-reduce that synced BN's moments take.

Each is a plain ``torch.distributed`` call on tensors of the step's
device, so that on CUDA a captured step records the NCCL launches in its
graph; gloo carries the same calls on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One float32 vector of every tensor's elements, in order."""
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``flat`` cut back into tensors of ``like``'s shapes (views)."""
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape))
        at += n
    return out


def _gloo_on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``out`` = this rank's ``out.numel()`` elements of Σ over the ranks
    of ``inp`` (``[world · out.numel()]``). gloo on CUDA tensors (ranks
    sharing a card) takes the whole sum and keeps its slice."""
    if _gloo_on_cuda(inp):
        total = inp.clone()
        dist.all_reduce(total)
        n = out.numel()
        out.copy_(total[dist.get_rank() * n:(dist.get_rank() + 1) * n])
        return
    dist.reduce_scatter_tensor(out, inp)


def all_gather(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``out`` (``[world · inp.numel()]``) = every rank's ``inp`` in rank
    order."""
    if _gloo_on_cuda(inp):
        dist.all_gather(list(out.view(-1, inp.numel()).unbind(0)), inp)
        return
    dist.all_gather_into_tensor(out, inp)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (the reference's ``pmean``:
    the sum, then divided by the rank count), in one all-reduce."""
    flat = flatten(tensors)
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    return unflatten(flat, tensors)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; its gradient is Σ over the ranks of the
    cotangents (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable Σ of ``x`` over the ranks."""
    return _AllReduceSum.apply(x)
