"""The card's start, on a thread beside a command's host work.

Before its first kernel runs, a fresh ``kssd_torch`` process pays for
CUDA's initialisation and the card's context, torch's CUDA runtime, the
kernel libraries and the first pinned staging buffers. ``CardStart`` does that
work on one thread (``kssd-card-start``) while the main thread imports
torch and the command's modules, lists the input files, starts stage I's
parse pool and reads the stats:

1. in a process that has not imported torch yet, ``cuInit`` and the
   card's primary context (``cuDevicePrimaryCtxRetain``) through
   ``libcuda.so.1``'s C API (with ctypes, which releases the
   interpreter lock in each call), beside torch's import on the main
   thread; torch's runtime then finds the context made;
2. the kernel libraries the command launches
   (``kernels.CudaKernel.library``, built first where the checkout has
   no build of them);
3. torch's CUDA start: its first allocation on the card;
4. the pinned staging sets the command borrows (``ops.staging.prepare``).

The work is named by what the command runs on the card: ``"sketch"``
(stage I: the sketch kernels and the stream's staging set), ``"count"``
(the search's count kernels) and ``"index"`` (the index loader's staging
set); with none of them (stage II's sort on the card) the thread makes
the context alone.

The main thread calls ``join`` before its first device call: it waits
for the thread and raises what the thread raised, so a start that fails
fails the command; there is no fallback and no retry. ``close`` waits for
the thread and raises nothing, for a command that ends, or fails for
another reason, before its first device call.
"""

from __future__ import annotations

import ctypes
import sys
import threading


def _ordinal(name: str) -> int:
    """The index of the card ``name`` ("cuda" or "cuda:N") among the
    visible ones: N, else the first, which torch takes for "cuda" in a
    process that has not started CUDA."""
    _, _, index = name.partition(":")
    return int(index) if index else 0


def _cuinit(ordinal: int) -> None:
    """``cuInit`` and card ``ordinal``'s primary context, made and
    retained for the process (torch's runtime retains and uses the same
    one)."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise RuntimeError(
            f"libcuda.so.1 cannot be loaded ({e}); pass "
            "--device cpu to run the plain PyTorch path") from e
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    calls = (
        ("cuInit", [ctypes.c_uint], (0,)),
        ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
         (ctypes.byref(dev), ordinal)),
        ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int],
         (ctypes.byref(ctx), dev)),
    )
    for name, argtypes, args in calls:
        fn = getattr(cuda, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{name} returned CUresult {err} for card {ordinal}; pass "
                "--device cpu to run the plain PyTorch path")


def _fresh() -> bool:
    """Whether this process has not imported torch, and so has not started
    CUDA, yet."""
    return "torch" not in sys.modules


def _context(device) -> None:
    """torch's CUDA start on ``device``: its first allocation there."""
    import torch

    torch.empty(1, device=device)


class CardStart:
    """The start of card ``name`` ("cuda" or "cuda:N") for ``work`` (names
    among "sketch", "count" and "index"), running on its own thread from
    construction."""

    def __init__(self, name: str, work):
        self.name = name
        self.work = tuple(work)
        self._error: BaseException | None = None
        # a process that has imported torch may have started CUDA already
        self._cuinit = _fresh()
        self._thread = threading.Thread(target=self._run, name="kssd-card-start",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            # the cuInit step goes first: the main thread begins torch's
            # import meanwhile, and this thread's import below waits for
            # it (a fresh process whose torch was imported on this thread
            # took 2.0-2.5 s longer on an H100 host)
            if self._cuinit:
                _cuinit(_ordinal(self.name))
            from public_kssd_tpu_torch import kernels

            libraries = {"sketch": (kernels.sketch_kernel, kernels.sketch_wide_kernel),
                         "count": (kernels.count_kernel, kernels.count_koc_kernel)}
            for name in self.work:
                for k in libraries.get(name, ()):
                    k.library()
            import torch

            device = torch.device("cuda", _ordinal(self.name))
            _context(device)
            from public_kssd_tpu_torch.ops import staging

            if "sketch" in self.work:
                from public_kssd_tpu_torch.ops import sketch

                staging.prepare(device, sketch.STREAM_BLOCK)
            if "index" in self.work:
                from public_kssd_tpu_torch import index

                staging.prepare(device, index.INDEX_BLOCK, index.INDEX_READ_THREADS + 2)
        except BaseException as e:  # raised again on the main thread, by join
            self._error = e

    def join(self) -> None:
        """Wait for the start; raise what it raised."""
        self._thread.join()
        if self._error is not None:
            raise self._error

    def close(self) -> None:
        """Wait for the start; raise nothing."""
        self._thread.join()
