"""Multi-process orchestration: torch.distributed wiring + sharded artifacts.

The reference is strictly single-node (SURVEY.md §2: OpenMP + mmap, no
communication backend). The scale-out contract here (the JAX package's
parallel/distributed.py on torch.distributed):

  * sketching — genomes are sharded across processes round-robin; each
    writes an independent reference-format sketch dir plus a manifest
    entry, restartable per shard (the file-boundary recoverability of
    the reference, per shard instead of per run),
  * merged view — shard dirs concatenate into one sketch dir with index
    rebasing (combine.combine_queries), or are consumed shard-wise,
  * search — the DB CSR shards across the global device mesh
    (parallel.sharded_search); per-shard counts merge across processes
    with all_gather / all_reduce.

Every artifact stays byte-compatible with the reference; the manifest is
an additional json file the reference simply ignores.
"""

from __future__ import annotations

import atexit
import json
import os

MANIFEST = "manifest.json"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str = "cuda") -> tuple[int, int]:
    """Initialise torch.distributed when running multi-process; returns
    (process_index, process_count). Safe to call in one process (no-op).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (a
    free port). On the default ``device``, a card, the backend is nccl
    and each process takes card ``process_id`` modulo the visible cards
    as its current device, so ``parallel.make_mesh`` lays rank r on that
    card; it raises when no card is visible (no CPU fallback).
    ``device="cpu"`` gives a gloo group on the CPU. The group is
    destroyed when the interpreter exits (``_destroy_at_exit``)."""
    import torch
    import torch.distributed as dist

    from public_kssd_tpu_torch import parallel

    if coordinator_address is not None and not dist.is_initialized():
        cuda = torch.device(device).type == "cuda"
        if cuda:
            cards = torch.cuda.device_count()
            if not cards:
                raise RuntimeError(
                    f"initialize: device {device!r} needs a CUDA card for its "
                    "nccl group and none is visible; pass device=\"cpu\" "
                    "(--device cpu) for a gloo group on the CPU"
                )
            torch.cuda.set_device(process_id % cards)
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
        )
        atexit.register(_destroy_at_exit)
    return parallel.process_index(), parallel.process_count()


def _destroy_at_exit() -> None:
    """Destroy the default process group, if one is still up, before the
    interpreter tears down: a gloo group left to the interpreter's exit
    can abort the process ("terminate called without an active
    exception") while its threads still run."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_files(files: list[str], n_shards: int, shard_id: int) -> list[str]:
    """Round-robin file assignment (size-agnostic load balance; the
    reference shuffles input order for the same reason,
    command_dist.c:75)."""
    return files[shard_id::n_shards]


def shard_dir(root: str, shard_id: int) -> str:
    return os.path.join(root, f"shard_{shard_id}")


def sketch_shard(
    files: list[str],
    out_root: str,
    params,
    shuffled_dim,
    opts=None,
    shard_id: int = 0,
    n_shards: int = 1,
    *,
    device,
):
    """Sketch this host's file shard into <out_root>/shard_<id> on the
    torch ``device`` and record it in the manifest. Re-running a finished
    shard is a no-op (idempotent restart)."""
    from public_kssd_tpu_torch import pipeline

    my_files = shard_files(files, n_shards, shard_id)
    d = shard_dir(out_root, shard_id)
    done_marker = os.path.join(d, ".complete")
    if not os.path.exists(done_marker):
        stat = pipeline.run_stage1(my_files, d, params, shuffled_dim, opts,
                                   device=device)
        with open(done_marker, "w") as f:
            f.write(str(stat.all_ctx_ct))
    _update_manifest(out_root, shard_id, n_shards, my_files, params.id)
    return d


def _update_manifest(root, shard_id, n_shards, files, params_id):
    """One manifest file PER SHARD (manifest.shard_<id>.json): concurrent
    hosts never write the same file, so there is no read-modify-write
    race (a lost-update hazard the old single-json design had when two
    hosts finished simultaneously)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{MANIFEST}.shard_{shard_id}")
    entry = {
        "version": 2, "n_shards": n_shards, "params_id": params_id,
        "shard_id": shard_id, "dir": f"shard_{shard_id}",
        "files": list(files),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=1)
    os.replace(tmp, path)  # atomic publish


def read_manifest(root: str) -> dict:
    """Merged view over all per-shard manifests (legacy single-json
    manifests are still understood)."""
    import glob as _glob

    shard_files = sorted(_glob.glob(os.path.join(root, f"{MANIFEST}.shard_*")))
    if not shard_files:
        with open(os.path.join(root, MANIFEST)) as f:
            return json.load(f)
    man = {"version": 2, "n_shards": None, "params_id": None, "shards": {}}
    for p in shard_files:
        with open(p) as f:
            e = json.load(f)
        if man["n_shards"] is None:
            man["n_shards"] = e["n_shards"]
            man["params_id"] = e["params_id"]
        elif (man["n_shards"] != e["n_shards"]
              or man["params_id"] != e["params_id"]):
            raise RuntimeError(f"inconsistent shard manifest {p}")
        man["shards"][str(e["shard_id"])] = {
            "dir": e["dir"], "files": e["files"],
        }
    return man


def merge_shards(root: str, out_dir: str):
    """Concatenate all completed shard dirs into one reference-format
    sketch dir (index rebasing via combine.combine_queries)."""
    from public_kssd_tpu_torch import combine

    man = read_manifest(root)
    dirs = [
        os.path.join(root, man["shards"][str(s)]["dir"])
        for s in range(man["n_shards"])
        if str(s) in man["shards"]
    ]
    for d in dirs:
        if not os.path.exists(os.path.join(d, ".complete")):
            raise RuntimeError(f"shard {d} incomplete; rerun its host")
    return combine.combine_queries(dirs, out_dir)
