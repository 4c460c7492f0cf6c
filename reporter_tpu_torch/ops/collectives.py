"""The mesh's collectives: the counterparts of ``jax.lax.pmin``, ``pmax``,
``psum`` and ``all_gather`` over one mesh axis, for a program driven from
one process.

Each takes one tensor per rank of the axis, in rank order, moves them to
the first rank's device, reduces them there and hands each rank its copy
on its own device (the same tensor where ranks share a device).  A
cross-device ``Tensor.to`` is ordered after the work queued on both
devices' current streams (PyTorch's peer copy waits on each), so the
pieces are read after the kernels that wrote them.  Callers hold the
mesh's ``lock`` across one dispatch's launches and collectives, so two
dispatching threads never interleave one collective's pieces.

The sums are exact where the callers need them to be: the slab gather's
int32 bit patterns add one nonzero block to zeros.

``all_reduce`` continues a reduction across processes (a mesh that spans
controllers, ``parallel/multihost.py``): ``torch.distributed.all_reduce``
over a process group, in place on a contiguous copy.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def _hand(out: torch.Tensor, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [out if p.device == out.device else out.to(p.device) for p in parts]


def _reduce(parts: Sequence[torch.Tensor],
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    root = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p.to(root))
    return _hand(out, parts)


def pmin(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise minimum over the ranks."""
    return _reduce(parts, torch.minimum)


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise maximum over the ranks."""
    return _reduce(parts, torch.maximum)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise sum over the ranks, in rank order."""
    return _reduce(parts, torch.add)


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
    """The ranks' blocks concatenated along ``dim`` in rank order (the
    reference's ``all_gather(tiled=True)``)."""
    root = parts[0].device
    return _hand(torch.cat([p.to(root) for p in parts], dim), parts)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced elementwise ("min", "max" or "sum") over the processes
    of ``group`` (``torch.distributed``); every process gets the result."""
    import torch.distributed as dist

    ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
           "sum": dist.ReduceOp.SUM}
    out = t.contiguous().clone()
    dist.all_reduce(out, op=ops[op], group=group)
    return out
