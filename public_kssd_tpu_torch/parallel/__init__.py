"""Device meshes and the cross-process merges of the sharded paths.

The JAX package runs its sharded search and composite as one program over
a ``jax.sharding.Mesh`` (``shard_map``). Here a mesh is an explicit grid
of torch devices driven from one process: a step is a loop over the
mesh's slots that launches each shard's kernel on that slot's device
(every kernel wrapper makes its device current and launches on that
device's stream), and the merge of the per-slot results runs on the host.

Across processes (``torch.distributed``, see ``parallel.distributed``)
the mesh is laid out over the global device list ordered by rank, the way
``jax.devices()`` orders devices by process; each process builds, uploads
and launches only the slots it owns, and ``all_gather_objects`` /
``all_reduce_sum`` stand in for ``process_allgather`` and ``psum``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def process_index() -> int:
    """This process's rank (0 without an initialised process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The number of processes (1 without an initialised process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp x ref`` grid of torch devices, row-major: slot ``d * ref + r``
    counts query block ``d`` against DB shard ``r``.

    ``devices`` names each slot's device as its owning process names it;
    ``ranks`` gives that process (``None``: this process owns every slot).
    A device may repeat: ``[cpu] * 8`` is the twin of the JAX package's 8
    virtual CPU devices, and ``[cuda:0] * 4`` runs a 4-shard mesh on one
    card."""

    dp: int
    ref: int
    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.dp < 1 or self.ref < 1:
            raise ValueError(f"mesh shape {self.dp}x{self.ref}: both must be >= 1")
        if len(self.devices) != self.dp * self.ref:
            raise ValueError(
                f"mesh {self.dp}x{self.ref} needs {self.dp * self.ref} "
                f"devices, got {len(self.devices)}"
            )
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError("one rank per mesh device")

    def local_slots(self) -> list[tuple[int, int, torch.device]]:
        """(d, r, device) of every slot this process owns."""
        me = process_index()
        return [
            (i // self.ref, i % self.ref, dev)
            for i, dev in enumerate(self.devices)
            if (self.ranks[i] if self.ranks is not None else 0) == me
        ]


def make_mesh(dp: int, ref: int, device: str | torch.device = "cuda",
              local_devices: list[torch.device] | None = None) -> Mesh:
    """The first ``dp * ref`` devices of the global device list as a mesh.

    In one process: ``cuda`` takes the first ``dp * ref`` visible cards
    and raises ``ValueError`` when fewer are visible (a device is never
    repeated silently); ``cpu`` repeats the CPU. Across processes each
    process contributes ``local_devices`` (default: its current card, as
    ``distributed.initialize`` set it, or one CPU) and the list is
    ordered by rank."""
    n = dp * ref
    kind = torch.device(device).type
    if local_devices is None:
        if process_count() > 1:
            local_devices = [torch.device("cuda", torch.cuda.current_device())
                             if kind == "cuda" else torch.device("cpu")]
        elif kind == "cuda":
            local_devices = [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())]
        else:
            local_devices = [torch.device("cpu")] * n
    local_devices = [torch.device(d) for d in local_devices]
    if process_count() == 1:
        devices, ranks = local_devices, [0] * len(local_devices)
    else:
        per_rank = all_gather_objects([str(d) for d in local_devices])
        devices = [torch.device(d) for names in per_rank for d in names]
        ranks = [r for r, names in enumerate(per_rank) for _ in names]
    if len(devices) < n:
        raise ValueError(
            f"mesh {dp}x{ref}: need {n} devices ({len(devices)} visible)"
        )
    return Mesh(dp, ref, tuple(devices[:n]), tuple(ranks[:n]))


def _collective_device() -> torch.device:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj) -> list:
    """``obj`` of every process, in rank order (``[obj]`` in one
    process)."""
    if process_count() == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(a: np.ndarray) -> np.ndarray:
    """Element-wise sum of ``a`` over all processes, in place and returned.
    uint32 / uint64 arrays travel as int32 / int64 bit views: the two's
    complement sum wraps as unsigned addition does, so the result is
    exact mod 2^32 / 2^64."""
    if process_count() == 1:
        return a
    import torch.distributed as dist

    signed = {4: np.int32, 8: np.int64}[a.dtype.itemsize]
    t = torch.from_numpy(np.ascontiguousarray(a).view(signed))
    dev = _collective_device()
    buf = t.to(dev)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    a[...] = buf.cpu().numpy().view(a.dtype).reshape(a.shape)
    return a
