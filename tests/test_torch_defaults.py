"""The port's Python entry points run on the card unless the caller asks
for the CPU, as the JAX package's run on its accelerator: each default
``device`` names the card, and on a host with no card a call that names
none raises before it does any work (no silent CPU fallback).
``device="cpu"`` is the plain PyTorch path and ``device=None`` the host
oracle; the other tests hold both to the JAX package."""

import inspect
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from public_kssd_tpu_torch import composite, formats, search, stattab
from public_kssd_tpu_torch.ops import count
from public_kssd_tpu_torch.parallel import distributed

torch.set_num_threads(1)

NO_CARD = 'device="cpu"'


def _refuse(*_a, **_k):
    raise AssertionError("work ran before the device was resolved")


def _codes():
    """One query of one code against a one-genome index stub: the count
    wrappers' arguments up to their ``device``."""
    sp = types.SimpleNamespace(n_genomes=1)
    return np.zeros(1, np.uint32), np.array([0, 1], np.uint64), sp, 1


def _weights():
    qc, qi, sp, n = _codes()
    return qc, qi, np.ones(1, np.uint32), sp, n


ENTRY_POINTS = {
    "search.search": (search.search, lambda tmp: ("ref", "qry", str(tmp / "o"))),
    "search.compute_shared_counts": (search.compute_shared_counts,
                                     lambda tmp: ("qry", [], 1)),
    "composite.species_abundance": (composite.species_abundance,
                                    lambda tmp: ("ref", "qry")),
    "composite.abv_search_device": (composite.abv_search_device,
                                    lambda tmp: (str(tmp / "ref"), ["a.abv"], 0)),
    "count.count_shared_tensors": (count.count_shared_tensors, lambda tmp: _codes()),
    "count.count_shared": (count.count_shared, lambda tmp: _codes()),
    "count.count_shared_koc": (count.count_shared_koc, lambda tmp: _weights()),
    "count.count_shared_weighted": (count.count_shared_weighted,
                                    lambda tmp: _weights()),
    "distributed.initialize": (distributed.initialize,
                               lambda tmp: ("127.0.0.1:1", 2, 1)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name, monkeypatch, tmp_path):
    """The default names the card; with no card visible a call that names
    no device raises the error that names ``device="cpu"``, before it
    reads a file, counts or joins a group."""
    fn, args = ENTRY_POINTS[name]
    assert torch.device(inspect.signature(fn).parameters["device"].default).type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for mod, attr in [(stattab, "read_co_stat_table"), (stattab, "read_mco_stat_table"),
                      (formats, "read_combco"), (count, "count_shared_np"),
                      (count, "count_shared_weighted_np"),
                      (count.DeviceIndex, "from_sparse"),
                      (dist, "init_process_group")]:
        monkeypatch.setattr(mod, attr, _refuse)
    with pytest.raises(RuntimeError, match=NO_CARD):
        fn(*args(tmp_path))


@pytest.mark.parametrize("device, backend, card", [
    (None, "nccl", 6 % 4),  # the default
    ("cuda", "nccl", 6 % 4),
    ("cpu", "gloo", None),
])
def test_initialize_takes_its_ranks_card(device, backend, card, monkeypatch):
    """On a card the group is nccl and rank r takes card r % cards as its
    current device before the group is made; ``device="cpu"`` is gloo
    and touches no card."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(distributed.atexit, "register", lambda fn: calls.append(fn))
    kw = {} if device is None else {"device": device}
    assert distributed.initialize("127.0.0.1:29500", 8, 6, **kw) == (0, 1)
    group = (backend, {"init_method": "tcp://127.0.0.1:29500", "world_size": 8,
                       "rank": 6})
    want = ([] if card is None else [("card", card)]) + [group,
                                                         distributed._destroy_at_exit]
    assert calls == want


def test_initialize_in_one_process_asks_for_nothing(monkeypatch):
    """With no coordinator the call is a no-op on any host: no card is
    looked for and no group is made."""
    monkeypatch.setattr(torch.cuda, "device_count", _refuse)
    monkeypatch.setattr(dist, "init_process_group", _refuse)
    assert distributed.initialize() == (0, 1)
