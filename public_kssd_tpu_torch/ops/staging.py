"""Host staging buffers for uploads to a device.

A few host buffers that data is assembled or read into before it goes to
the device: pinned for a card, so each upload runs asynchronously on a
side stream while the next buffer fills, and plain on the CPU, where an
upload is a synchronous copy. A set is kept for the process and reused by
later users of the same device, block size and buffer count (``borrow``),
so only the first pays for pinning; ``prepare`` makes a set ahead of its
first user (the card's start, ``start.py``). Stage I's sketch stream
(``ops/sketch.py``) and the search's index loader (``index.py``
``load_device_index``) share this. The buffers also carry results the
other way (``Staging.fetch``): the mesh search's count blocks, each
copied from the device into a pinned buffer and from there into its
place in the caller's array.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

# host buffers a set rotates through: one is filled while the uploads of
# the others run
STAGING_BUFFERS = 3


class Staging:
    """``count`` host buffers of ``block`` bytes (uint8), pinned for a
    card, with the side stream that uploads them and the event that ends
    each one's last upload."""

    def __init__(self, device: torch.device, block: int,
                 count: int = STAGING_BUFFERS):
        self.device = device
        cuda = device.type == "cuda"
        self.bufs = [torch.empty(block, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(count)]
        self.host = [b.numpy() for b in self.bufs]
        self.events: list[torch.cuda.Event | None] = [None] * count
        self.stream = torch.cuda.Stream(device) if cuda else None

    @property
    def count(self) -> int:
        return len(self.bufs)

    def writable(self, i: int) -> np.ndarray:
        """Buffer ``i`` as a numpy array, once its last upload has ended."""
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        return self.host[i]

    def upload(self, i: int, n: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """The first ``n`` bytes of buffer ``i`` on the device: in ``out``
        (uint8 [n] on the device, a slice of a larger tensor where the
        bytes belong) when it is given, else in a new tensor. On a card the
        copy runs on the side stream, after the work torch's current stream
        has queued so far (``out`` may reuse memory that work freed), and
        the current stream, where the kernels launch, waits for it."""
        src = self.bufs[i][:n]
        if self.stream is None:
            return src.clone() if out is None else out.copy_(src)
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            if out is not None:
                self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                if out is None:
                    out = torch.empty(n, dtype=torch.uint8, device=self.device)
                    out.record_stream(current)
                out.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            current.wait_event(done)
        self.events[i] = done
        return out

    def fetch(self, src: torch.Tensor, dst: np.ndarray) -> None:
        """The 2-D tensor ``src`` (on this set's device) into ``dst``, a
        numpy array of its shape and item size (a strided view of a
        larger array or of a memmap serves): ``src`` goes a piece of whole
        rows at a time (column ranges of a row wider than a buffer) into
        the next buffer, on a card on torch's current stream, and each
        piece is copied into its place in ``dst`` once its copy has ended,
        while the next pieces' copies run."""
        if src.dim() != 2 or tuple(src.shape) != dst.shape or (
                src.element_size() != dst.itemsize):
            raise ValueError(f"cannot fetch {src.dtype} {tuple(src.shape)} into "
                             f"{dst.dtype} {dst.shape}")
        rows, cols = dst.shape
        width = src.element_size()
        block = self.host[0].size
        if cols * width > block:
            step = max(block // width, 1)
            for c0 in range(0, cols, step):
                c1 = min(c0 + step, cols)
                self.fetch(src[:, c0:c1].contiguous(), dst[:, c0:c1])
            return
        src = src.contiguous()
        per = max(block // max(cols * width, 1), 1)
        pending: collections.deque = collections.deque()

        def land(done, i, r0, r1):
            if done is not None:
                done.synchronize()
            n = (r1 - r0) * cols * width
            dst[r0:r1] = self.host[i][:n].view(dst.dtype).reshape(r1 - r0, cols)

        with contextlib.ExitStack() as stack:
            if self.stream is not None:
                stack.enter_context(torch.cuda.device(self.device))
            for k, r0 in enumerate(range(0, rows, per)):
                r1 = min(r0 + per, rows)
                i = k % self.count
                if len(pending) == self.count:
                    land(*pending.popleft())
                self.writable(i)
                piece = src[r0:r1].reshape(-1).view(torch.uint8)
                self.bufs[i][:piece.numel()].copy_(piece, non_blocking=True)
                done = None
                if self.stream is not None:
                    done = torch.cuda.Event()
                    done.record()
                pending.append((done, i, r0, r1))
            while pending:
                land(*pending.popleft())


_SETS: dict[tuple[torch.device, int, int], list[Staging]] = {}
_LOCK = threading.Lock()


def prepare(device: torch.device, block: int, count: int = STAGING_BUFFERS) -> None:
    """Make a set of ``count`` staging buffers of ``block`` bytes for
    ``device`` and keep it where ``borrow`` looks, so that the first user
    of that device, block size and count finds it made; nothing when a
    set is kept there already."""
    key = (device, block, count)
    with _LOCK:
        if _SETS.get(key):
            return
    st = Staging(device, block, count)
    with _LOCK:
        _SETS.setdefault(key, []).append(st)


@contextlib.contextmanager
def borrow(device: torch.device, block: int, count: int = STAGING_BUFFERS):
    """A set of ``count`` staging buffers of ``block`` bytes for one user:
    kept for the process and reused by later users of the same device,
    block size and count; a user that runs while another holds the set
    gets a new one."""
    key = (device, block, count)
    with _LOCK:
        free = _SETS.setdefault(key, [])
        st = free.pop() if free else None
    if st is None:
        st = Staging(device, block, count)
    try:
        yield st
    finally:
        with _LOCK:
            _SETS[key].append(st)
