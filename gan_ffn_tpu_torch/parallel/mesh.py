"""Data parallelism over ``torch.distributed`` (counterpart of
``gan_ffn_tpu/parallel/mesh.py``).

The JAX package shards the batch axis over a 1-D device mesh, replicates
the parameters and lets XLA insert the gradient all-reduce; its masked
losses are global, so a DP step is the single-device step.  The port runs
one process per card, launched by ``python -m torch.distributed.run``
(NCCL on a card, gloo on the CPU), and does by hand what XLA does:

- every rank loads the whole batch, computes the whole batch's loss
  denominators (``nn.losses``) and takes its contiguous slice of the batch
  axis (:func:`shard_batch`), so its loss is its own numerator over the
  global denominator;
- a data-parallel step (``train/gan.py``, ``train/classifier.py``) sums
  each update's gradients over the group (:func:`all_reduce_grads`) before
  Adam, which then applies the single-process gradient on every rank, and
  sums the ranks' losses;
- :func:`replicate` starts every rank from rank 0's parameters and Adam
  state.

Batch-axis roles, as JAX's (:func:`batch_sharding`): the time-major
``text``, ``visual``, ``audio`` and ``qmask`` (L, B, D) split axis 1, the
batch-first ``umask`` and ``label`` (B, L) axis 0, and the rest
(``valid_len``, the seed) is replicated; ``n_real`` becomes the rank's own
count of real dialogues, which ``train.gan.duel_mask`` reads.

Dropout differs from JAX's: a rank's kernels address their masks by the
element's index in the rank's slice, so each rank folds its rank into the
step's seed base (``ops.dropout.fold_rank``; rank 0 keeps the
single-process base), and torch's own RNG is reseeded per rank
(:func:`fold_torch_seed`).  Sharded dropout is therefore held to the
single-process dropout by distribution, not in bits.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..ops.dropout import fold_rank

TIME_MAJOR = ("text", "visual", "audio", "qmask")
BATCH_FIRST = ("umask", "label")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank's place in a data-parallel group: its ``rank`` and the
    group's ``world`` size, the ``group`` (None: one process, no group) and
    the ``device`` the rank runs on."""

    rank: int = 0
    world: int = 1
    group: Optional[object] = None
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None


def init_data_parallel(device="cuda",
                       timeout: Optional[datetime.timedelta] = None) -> DataParallel:
    """This process's :class:`DataParallel` from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``MASTER_ADDR``/``MASTER_PORT``).
    On a card (``device`` of type cuda) the rank runs on ``cuda:LOCAL_RANK``
    over NCCL; on the CPU, where the caller asks for it, over gloo.  Without
    a torchrun environment: world size 1, no group.  A failed init raises:
    nothing falls back to another backend or to one process."""
    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return DataParallel(device=device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    kw = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
        kw["device_id"] = device
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device}")
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return DataParallel(rank, world, dist.group.WORLD, device, backend)


def leave(dp: Optional[DataParallel]) -> None:
    """Leave ``dp``'s process group (the default one), where there is one."""
    if dp is not None and dp.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def active(dp: Optional[DataParallel]) -> Optional[DataParallel]:
    """``dp`` where it has a group, else None (one process: no hooks)."""
    return dp if dp is not None and dp.group is not None else None


def batch_sharding(name: str) -> Optional[int]:
    """The batch axis of the batch array ``name``: 1 for the time-major
    features and speaker mask, 0 for the batch-first ``umask`` and
    ``label``, None (replicated) for the rest."""
    if name in TIME_MAJOR:
        return 1
    if name in BATCH_FIRST:
        return 0
    return None


def shard_batch(batch: Mapping[str, object], rank: int, world: int) -> Dict[str, object]:
    """Rank ``rank``'s contiguous slice of ``batch`` (tensors of
    ``train.loop.batch_to_tensors``, or host ints beside them) over
    ``world`` ranks, by :func:`batch_sharding`.  ``n_real`` (and
    ``host_n_real``) become the rank's count of real dialogues,
    ``clamp(n_real - offset, 0, B / world)``.  The batch size must be a
    multiple of ``world``, as the JAX mesh requires."""
    B = batch["text"].shape[1]
    if B % world:
        raise ValueError(f"a batch of {B} dialogues does not split over {world} ranks")
    size = B // world
    offset = rank * size
    out: Dict[str, object] = {}
    for name, value in batch.items():
        axis = batch_sharding(name)
        if axis is not None:
            out[name] = value.narrow(axis, offset, size).contiguous()
        elif name in ("n_real", "host_n_real"):
            out[name] = (torch.clamp(value - offset, 0, size) if isinstance(value, torch.Tensor)
                         else min(max(int(value) - offset, 0), size))
        else:
            out[name] = value
    return out


def _group_src(dp: DataParallel) -> int:
    """The global rank of ``dp.group``'s rank 0."""
    return dist.get_global_rank(dp.group, 0) if dp.group is not dist.group.WORLD else 0


def _broadcast(t: torch.Tensor, dp: DataParallel) -> None:
    """``t`` from the group's rank 0, in place (through ``dp.device`` for a
    host tensor under NCCL)."""
    buf = t if dp.backend != "nccl" or t.device == dp.device else t.to(dp.device)
    dist.broadcast(buf, src=_group_src(dp), group=dp.group)
    if buf is not t:
        t.copy_(buf)


@torch.no_grad()
def replicate(modules: Iterable[nn.Module], optimizers: Iterable[torch.optim.Optimizer],
              dp: Optional[DataParallel]) -> None:
    """Give every rank of ``dp`` rank 0's parameters and buffers of
    ``modules`` and the state of ``optimizers`` (Adam's moments and step
    counts, where they exist), in place.  No group: nothing to do."""
    if active(dp) is None:
        return
    for module in modules:
        for t in list(module.parameters()) + list(module.buffers()):
            _broadcast(t.data, dp)
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                for key in sorted(state):
                    if isinstance(state[key], torch.Tensor):
                        _broadcast(state[key], dp)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], dp: DataParallel) -> None:
    """Sum the ``.grad`` of ``params`` over ``dp``'s group: one all-reduce
    of one flat buffer per dtype, whose slices become the new ``.grad``s
    (no copy back)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, group=dp.group)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad = g.view_as(p)


def all_reduce_sum(t: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """``t`` summed over ``dp``'s group (in float32, returned at ``t``'s
    dtype; a new tensor)."""
    out = t.detach().float().clone()
    dist.all_reduce(out, group=dp.group)
    return out.to(t.dtype)


def all_gather_cat(t: torch.Tensor, dp: DataParallel, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (one shape on every rank) concatenated on ``dim`` in
    rank order."""
    parts = [torch.empty_like(t) for _ in range(dp.world)]
    dist.all_gather(parts, t.contiguous(), group=dp.group)
    return torch.cat(parts, dim=dim)


def fold_torch_seed(dp: Optional[DataParallel]) -> None:
    """Reseed torch's RNG (``F.dropout``) on a rank ``r > 0`` of ``dp`` with
    ``fold_rank(torch.initial_seed(), r)``, so that the ranks' torch
    dropouts differ; rank 0 keeps its state."""
    if dp is not None and dp.rank:
        torch.manual_seed(fold_rank(torch.initial_seed() & (2**63 - 1), dp.rank))
