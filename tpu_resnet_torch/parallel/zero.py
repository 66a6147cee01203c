"""The weight update across ranks (port of ``tpu_resnet/parallel/zero.py``).

:func:`make_update_fn` returns ``update(state, lr, means) -> (grad_norm,
means)``, run after the backward. ``means`` are the other tensors the
step averages over the ranks (loss, precision, and under per-replica BN
the running statistics); the result holds their means.

- one rank and no process group (or no partitioner): ``train/state.py``
  ``sgd_update`` and the norm of the gradient, as the one-card step has
  them;
- ``replicated``: one all-reduce of a flat bucket of every gradient and
  of ``means``, each divided by the rank count (the reference's
  ``pmean``), then ``sgd_update`` on every rank;
- ``zero1`` (:class:`Zero1Update`): the scheme of "Automatic
  Cross-Replica Sharding of Weight Update in Data-Parallel Training"
  (arXiv:2004.13336). A reduce-scatter leaves each rank the mean gradient
  of its slot shards (``parallel/partition.py`` picks each leaf's axis);
  one all-reduce carries the small replicated leaves' gradients, ``means``
  and the shards' sums of squares; momentum runs on this rank's shards
  only (``train/state.py`` ``sgd_apply``, ``sgd_update``'s arithmetic);
  an all-gather hands every rank the new parameters. ``grad_norm`` is the
  norm of the whole mean gradient.

A shard is a slice of rows of the leaf with its slot axis moved to the
front; its momentum buffer is kept in that layout.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_resnet_torch.parallel.collectives import (all_gather,
                                                   all_reduce_mean, flatten,
                                                   reduce_scatter, unflatten)
from tpu_resnet_torch.parallel.partition import make_partitioner
from tpu_resnet_torch.train.state import sgd_apply, sgd_update


def _grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.square(g.float()).sum() for g in grads]).sum())


def plain_update(state, lr: torch.Tensor, means: List[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One rank: the one-card update."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    grad_norm = _grad_norm(grads)
    sgd_update(state, lr)
    return grad_norm, list(means)


def replicated_update(state, lr: torch.Tensor, means: List[torch.Tensor]
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The gradients and ``means`` averaged in one all-reduce, then the
    one-card update on every rank."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    avg = all_reduce_mean(grads + list(means))
    # One multi-tensor copy back, not a launch a gradient.
    torch._foreach_copy_(grads, avg[:len(grads)])
    grad_norm = _grad_norm(grads)
    sgd_update(state, lr)
    return grad_norm, avg[len(grads):]


class Zero1Update:
    """The zero1 update over the default process group; ``axes`` from
    ``StatePartitioner.slot_axes``. Also gathers and scatters the momentum
    shards for a checkpoint (:meth:`full_slots`, :meth:`load_slots`)."""

    def __init__(self, partitioner, model: torch.nn.Module):
        self.n = partitioner.data_size
        self.rank = partitioner.mesh.rank
        axes = partitioner.slot_axes(model)
        named = list(model.named_parameters())
        self.sharded = [(n, p, axes[n]) for n, p in named
                        if axes[n] is not None]
        self.replicated = [(n, p) for n, p in named if axes[n] is None]

    # ------------------------------------------------------------ layout
    def _rows(self, t: torch.Tensor, ax: int) -> torch.Tensor:
        """This rank's shard of ``t`` (its slot axis first): a view."""
        moved = t.movedim(ax, 0)
        k = moved.shape[0] // self.n
        return moved[self.rank * k:(self.rank + 1) * k]

    def _scatter_layout(self, tensors) -> torch.Tensor:
        """[n · S]: rank r's shards of every sharded leaf at row r."""
        return torch.cat([t.movedim(ax, 0).reshape(self.n, -1)
                          for t, (_, _, ax) in zip(tensors, self.sharded)],
                         dim=1).reshape(-1)

    def _gathered(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The whole leaves from an all-gather of every rank's shards."""
        rows = flat.view(self.n, -1)
        out, at = [], 0
        for _, p, ax in self.sharded:
            moved = p.movedim(ax, 0).shape
            s = p.numel() // self.n
            whole = rows[:, at:at + s].reshape(moved)
            out.append(whole.movedim(0, ax))
            at += s
        return out

    def _all_gather(self, shards: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        send = flatten(shards)
        recv = torch.empty(self.n * send.numel(), dtype=send.dtype,
                           device=send.device)
        all_gather(recv, send)
        return self._gathered(recv)

    # ------------------------------------------------------------ update
    def __call__(self, state, lr: torch.Tensor, means: List[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        send = self._scatter_layout([p.grad for _, p, _ in self.sharded])
        recv = torch.empty(send.numel() // self.n, dtype=send.dtype,
                           device=send.device)
        reduce_scatter(recv, send)
        recv.div_(self.n)
        shard_grads = unflatten(recv, [self._rows(p, ax)
                                       for _, p, ax in self.sharded])
        repl = [p.grad for _, p in self.replicated]
        sq = torch.square(recv).sum().reshape(1)
        flat = flatten(repl + list(means) + [sq])
        dist.all_reduce(flat)
        parts = unflatten(flat, repl + list(means) + [sq])
        for g, a in zip(repl, parts):
            g.copy_(a / self.n)
        means = [m / self.n for m in parts[len(repl):-1]]
        sq_total = parts[-1].sum()
        if repl:
            sq_total = sq_total + torch.stack(
                [torch.square(g).sum() for g in repl]).sum()
        grad_norm = torch.sqrt(sq_total)
        shards = [self._rows(p.detach(), ax) for _, p, ax in self.sharded]
        owners = [p for _, p, _ in self.sharded] + [p for _, p in
                                                    self.replicated]
        sgd_apply(shards + [p for _, p in self.replicated],
                  shard_grads + repl,
                  [state.optimizer.state[p] for p in owners],
                  state.optimizer.param_groups[0]["momentum"], lr)
        with torch.no_grad():
            for (_, p, _), whole in zip(self.sharded,
                                        self._all_gather(shards)):
                p.copy_(whole)
        return grad_norm, means

    # -------------------------------------------------------- checkpoints
    def full_slots(self, state) -> Dict[str, torch.Tensor]:
        """{parameter name: whole momentum buffer}, gathered from every
        rank's shards (a collective: every rank calls it)."""
        out = {}
        bufs = [state.optimizer.state.get(p, {}).get("momentum_buffer")
                for _, p, _ in self.sharded]
        if self.sharded and all(b is not None for b in bufs):
            for (name, _, _), whole in zip(self.sharded,
                                           self._all_gather(bufs)):
                out[name] = whole
        for name, p in self.replicated:
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[name] = buf
        return out

    def load_slots(self, state, buffers: Dict[str, torch.Tensor]) -> None:
        """Set every momentum buffer from whole ones: this rank's shards
        of the sharded leaves (written in place where they exist), the
        replicated ones whole; a leaf ``buffers`` lacks is zeroed."""
        with torch.no_grad():
            for name, p, ax in self.sharded:
                self._load(state, p, buffers.get(name), ax)
            for name, p in self.replicated:
                self._load(state, p, buffers.get(name), None)

    def _load(self, state, p, whole, ax) -> None:
        slot = state.optimizer.state[p]
        old = slot.get("momentum_buffer")
        if whole is None:
            if old is not None:
                old.zero_()
            return
        whole = whole.to(device=p.device, dtype=p.dtype)
        part = whole if ax is None else self._rows(whole, ax)
        if old is None:
            slot["momentum_buffer"] = part.clone().contiguous()
        else:
            old.copy_(part)


def make_update_fn(partitioner=None, model=None):
    """The step's update for ``partitioner``'s layout (None: one rank).
    With a process group open the update is the replicated one even at
    one rank: its all-reduce over one rank is exact, so the step is the
    one-card step bit for bit and still holds its collective."""
    if partitioner is None or (partitioner.data_size == 1
                               and not dist.is_initialized()):
        return plain_update
    if not partitioner.is_sharded:
        return replicated_update
    return Zero1Update(partitioner, model)


def attach(state, mesh_cfg, mesh):
    """The update of ``mesh_cfg.partition`` over ``mesh`` (a
    ``parallel.Mesh``; None: one rank) for ``state``'s model, whose leaves
    it validates first; a zero1 update takes over ``state``'s momentum
    buffers (``state.zero``)."""
    if mesh is None:
        return plain_update
    partitioner = make_partitioner(mesh_cfg, mesh)
    partitioner.validate(state.model)
    update = make_update_fn(partitioner, state.model)
    if isinstance(update, Zero1Update):
        state.zero = update
    return update
