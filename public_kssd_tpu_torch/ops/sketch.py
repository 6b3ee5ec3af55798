"""Sketch kernel: base-code streams -> kept sketch codes (drtuples).

The reference's rolling scalar loop (fasta2co hot loop,
iseq2comem.c:205-270) becomes one independent computation per window
start p over W = 2k bases:

  window fwd value  F[p] = sum_j b[p+j] * 4^(W-1-j)
  window rc  value  R[p] = sum_j (3-b[p+j]) * 4^j
  canonical         U[p] = min(F[p], R[p])               (iseq2comem.c:245)
  inner substring   I[p] = (U[p] >> 2(k-s)) & (16^s - 1) (iseq2comem.c:246)
  rank              P[p] = Feistel(I[p]) or table[I[p]]
  keep              dim_start <= P[p] < dim_end           (iseq2comem.c:248)
  drtuple           ((U & undomask) + ((U & right) << 4s)) >> 4l + P
                                                          (iseq2comem.c:250-253)

``sketch_windows_math`` is the plain PyTorch version (int64 tensors: torch
has no arithmetic on unsigned 32/64-bit tensors, so the canonical compare
and the right shifts are written sign-safe for W = 32, where the window
value reaches bit 63). ``sketch_windows_kept`` is the wrapper of the
hand-written kernels in ``csrc/sketch.cu``: it returns the kept windows'
positions and codes in ascending position. For CUDA tensors it launches
the narrow kernel (drtuple <= 31 bits, int32 codes) or the wide one
(32..64-bit drtuples, int64 codes), whose keep pass and fill pass compact
the survivors on the card; for CPU tensors it runs the plain version
(``torch.nonzero`` over the dense codes of
``sketch_windows_dense_plain``).

Streaming (``_stream_packed``): the host copies each piece of symbols
once into a staging buffer (pinned for a card, three in rotation), and
each chunk's symbols go to the device asynchronously, on a side stream.
There they are packed to 2 bits per base (16 per uint32 word,
``pack2_torch``) and their BREAKs summed; the keep pass runs at once,
and the fill pass after the next chunk is on its way (no host wait per
chunk). The survivors whose window reaches past the chunk's real length
or covers a BREAK are dropped by position on the device, and the kept
(position, code) pairs of all chunks come back in one fetch. CPU tensors
run the same code with unpinned buffers and the plain version. Narrow
and wide geometries share this path.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

import numpy as np
import torch

from public_kssd_tpu_torch import kernels, resolve_device, shufspace
from public_kssd_tpu_torch.config import SketchParams
from public_kssd_tpu_torch.ops.staging import Staging, borrow
from public_kssd_tpu_torch.seqio import BREAK

# dense code of a dropped window: int32 -1 (uint32 0xFFFFFFFF) for narrow
# geometries, int64 -1 (uint64 all-ones) for wide ones. No real drtuple is
# all ones: below 64 bits it is too short, and at 64 bits (k = 16, l = 0) a
# canonical k-mer that starts with T ends with A.
SENTINEL = -1
_SIGN = -(1 << 63)  # the int64 sign bit
# symbols a staging buffer of the stream holds: the chunk the kernels take
STREAM_BLOCK = 1 << 24


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 values read as uint64."""
    return x if n == 0 else (x >> n) & ((1 << (64 - n)) - 1)


def _i64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def dense_dtype(params: SketchParams) -> torch.dtype:
    """Dtype of the dense per-window codes: int32 up to 31-bit drtuples,
    int64 above."""
    return torch.int64 if params.drtuple_bits > 31 else torch.int32


def as_shuf(shuf, device: torch.device):
    """A shuffle space as the sketch functions take it: a ComputedShuf
    (Feistel, evaluated in registers) as is, or a permutation table as an
    int32 tensor on ``device``."""
    if isinstance(shuf, shufspace.ComputedShuf):
        return shuf
    if isinstance(shuf, torch.Tensor):
        return shuf.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(shuf, dtype=np.int32)).to(device)


def _norm_shuf(shuf):
    """Split a shuffle-space argument into (table|None, ComputedShuf|None)."""
    if isinstance(shuf, shufspace.ComputedShuf):
        return None, shuf
    return shuf, None


def sketch_windows_math(
    symbols: torch.Tensor,  # uint8 [N] base codes 0..3 or BREAK(4)
    shuffled_dim: torch.Tensor | None,  # int32 [16^s] or None with computed
    params: SketchParams,
    computed: shufspace.ComputedShuf | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(drtuple int64 [M], keep bool [M]) for all M = N-W+1 windows, on
    the device of ``symbols``.

    ``drtuple`` entries where ``keep`` is False are arbitrary. Order of
    windows == sequence order, matching the reference scanner's emission
    order. Values are uint64 bit patterns held in int64: at W = 32 the
    window uses all 64 bits, so the canonical minimum compares with the
    sign bit flipped and every right shift is logical.
    """
    W = params.TL
    n = symbols.shape[0]
    m = max(n - W + 1, 0)
    dev = symbols.device
    if m == 0:
        return (
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev),
        )

    b = symbols.to(torch.int64)
    fwd = torch.zeros(m, dtype=torch.int64, device=dev)
    rc = torch.zeros(m, dtype=torch.int64, device=dev)
    for j in range(W):
        bj = b[j : j + m]
        fwd = (fwd << 2) | bj
        rc = rc | ((3 ^ bj) << (2 * j))

    # validity: no break inside [p, p+W)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    brk_pos = torch.where(symbols >= BREAK, pos, torch.full_like(pos, -1))
    last_brk = torch.cummax(brk_pos, dim=0).values
    valid = last_brk[W - 1 : W - 1 + m] < pos[:m]

    uni = torch.where((fwd ^ _SIGN) < (rc ^ _SIGN), fwd, rc)  # unsigned min
    inner = _lsr(uni, 2 * params.half_outctx_len) & (params.dim_shuf_len - 1)
    if computed is not None:
        pf = shufspace.feistel_torch(inner, computed.seed, computed.subctx_len)
    else:
        pf = shuffled_dim[inner].to(torch.int64)
    keep = valid & (pf >= params.dim_start) & (pf < params.dim_end)

    left = uni & _i64(params.undomask)
    right = (uni & params.rightmask) << (4 * params.half_subctx_len)
    drtuple = _lsr(left + right, 4 * params.drlevel) + (pf - params.dim_start)
    return drtuple, keep


def sketch_windows_dense_math(
    symbols: torch.Tensor, shuffled_dim, params: SketchParams
) -> torch.Tensor:
    """Plain dense form: ``dense_dtype(params)`` [N], position p holds the
    code of the window starting at p, SENTINEL where dropped (including
    the last W-1 positions, whose windows run past the stream)."""
    table, computed = _norm_shuf(shuffled_dim)
    drtuple, keep = sketch_windows_math(symbols, table, params, computed)
    dtype = dense_dtype(params)
    dense = torch.full(
        (symbols.shape[0],), SENTINEL, dtype=dtype, device=symbols.device
    )
    m = drtuple.shape[0]
    dense[:m] = torch.where(keep, drtuple, SENTINEL).to(dtype)
    return dense


def unpack2(words: torch.Tensor) -> torch.Tensor:
    """int32 (bit view of uint32) words -> uint8 base codes, 16 per word,
    low bits first (the layout of ``pack2``)."""
    shifts = torch.arange(16, dtype=torch.int64, device=words.device) * 2
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, None] >> shifts) & 3).to(torch.uint8).reshape(-1)


def sketch_windows_dense_plain(
    words: torch.Tensor, n_valid: int, shuffled_dim, params: SketchParams
) -> torch.Tensor:
    """``dense_dtype(params)`` [n_words*16] per-window codes of packed
    words, SENTINEL where the window is filtered out or reaches past
    ``n_valid`` symbols, on the device of ``words``: unpack, mark every
    symbol from ``n_valid`` on as BREAK, run the dense window math."""
    sym = unpack2(words)
    sym[n_valid:] = BREAK
    return sketch_windows_dense_math(sym, shuffled_dim, params)


@functools.lru_cache(maxsize=64)
def _round_keys(computed: shufspace.ComputedShuf) -> tuple[int, ...]:
    """The Feistel round keys of a computed shuffle space (numpy work
    that a streaming run would otherwise repeat for every block)."""
    return computed.keys


def sketch_windows_kept_plain(
    words: torch.Tensor, n_valid: int, shuffled_dim, params: SketchParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``sketch_windows_kept`` (same arguments, same
    result): ``torch.nonzero`` over the dense codes."""
    dense = sketch_windows_dense_plain(words, n_valid, shuffled_dim, params)
    pos = torch.nonzero(dense != SENTINEL).squeeze(1)
    return pos, dense[pos]


# windows per block of csrc/sketch.cu (256 threads x 32 window starts);
# the kernel refuses a launch whose tile count disagrees
SKETCH_TILE = 8192


def sketch_windows_keep(
    words: torch.Tensor,  # int32 [n_words]: pack2 output, bit view
    n_valid: int,
    shuffled_dim,  # ComputedShuf or int32 [16^s] tensor on words.device
    params: SketchParams,
) -> Callable[[], tuple[torch.Tensor, torch.Tensor]]:
    """The keep pass of ``sketch_windows_kept``, launched now; returns the
    function that launches the fill pass and returns its (pos, code).

    The keep pass's total is copied to pinned host memory behind an
    event, so a caller that does other work between the two calls (the
    stream assembles and launches its next chunk) finds it there without
    waiting on the card. CPU tensors run the plain version at once."""
    if words.device.type != "cuda":
        kept = sketch_windows_kept_plain(words, n_valid, shuffled_dim, params)
        return lambda: kept
    table, computed = _norm_shuf(shuffled_dim)
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be a 1-D int32 tensor (pack2 bit view)")
    if not 0 <= n_valid <= words.numel() * 16:
        raise ValueError(f"n_valid {n_valid} outside [0, {words.numel() * 16}]")
    words = words.contiguous()
    if table is not None:
        if (
            table.device != words.device
            or table.dtype != torch.int32
            or table.numel() != params.dim_shuf_len
        ):
            raise TypeError(
                "shuffle table must be int32 [16^s] on the device of words"
            )
        table = table.contiguous()
        keys = (0, 0, 0, 0)
    else:
        keys = _round_keys(computed)
    dev = words.device
    dtype = dense_dtype(params)
    n_tiles = -(-words.numel() * 16 // SKETCH_TILE)
    if n_tiles == 0:
        empty = (torch.zeros(0, dtype=torch.int64, device=dev),
                 torch.zeros(0, dtype=dtype, device=dev))
        return lambda: empty
    kernel = kernels.sketch_wide_kernel if dtype == torch.int64 else kernels.sketch_kernel
    mask = torch.empty(n_tiles * 256, dtype=torch.int32, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)

    def args():
        # words, table and mask stay referenced here until the fill pass
        return (
            words.data_ptr(), words.numel(), int(n_valid), params.TL,
            2 * params.half_outctx_len, params.dim_shuf_len - 1,
            params.undomask, params.rightmask, 4 * params.half_subctx_len,
            4 * params.drlevel, params.dim_start, params.dim_end,
            2 * params.half_subctx_len, *keys,
            table.data_ptr() if table is not None else None, n_tiles,
            mask.data_ptr(),
        )

    with torch.cuda.device(dev):
        stream = kernels.stream_handle(dev)
        kernel.launch(0, *args(), counts.data_ptr(), None, None, stream)
        cum = torch.cumsum(counts, 0)  # int64
        total = torch.empty((), dtype=torch.int64, pin_memory=True)
        total.copy_(cum[-1], non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def fill() -> tuple[torch.Tensor, torch.Tensor]:
        done.synchronize()
        n = int(total)
        with torch.cuda.device(dev):
            pos = torch.empty(n, dtype=torch.int64, device=dev)
            code = torch.empty(n, dtype=dtype, device=dev)
            if n:
                kernel.launch(1, *args(), cum.data_ptr(), pos.data_ptr(),
                              code.data_ptr(), stream, count=False)
        return pos, code

    return fill


def sketch_windows_kept(
    words: torch.Tensor,  # int32 [n_words]: pack2 output, bit view
    n_valid: int,
    shuffled_dim,  # ComputedShuf or int32 [16^s] tensor on words.device
    params: SketchParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos int64 [m], code ``dense_dtype(params)`` [m]): every window of
    the first ``n_valid`` symbols that the shuffle space keeps, in
    ascending position.

    CUDA tensors launch ``csrc/sketch.cu`` (the narrow kernel for int32
    codes, the wide one for int64 codes): a keep pass writes a keep mask
    and a survivor count per block, ``torch.cumsum`` of the counts sizes
    the output exactly, and a fill pass writes the survivors; the two
    passes count as one launch. CPU tensors run the plain version."""
    return sketch_windows_keep(words, n_valid, shuffled_dim, params)()


def pack2(symbols: np.ndarray, total: int) -> np.ndarray:
    """Host-side 2-bit packing: uint8 codes -> uint32 words (16 bases each),
    the layout the kernels read (the stream packs on the device with
    ``pack2_torch``, its twin).

    BREAK symbols are packed as code 0: the kernels never see breaks.
    ``total`` (multiple of 16) pads with code 0. Uses the native C packer
    when available, numpy otherwise.
    """
    from public_kssd_tpu_torch import native

    out = native.pack2(symbols, total)
    if out is not None:
        return out
    a = np.zeros(total, np.uint8)
    np.bitwise_and(symbols, 3, out=a[: symbols.size])
    a = a.reshape(-1, 4)
    by = a[:, 0] | (a[:, 1] << 2) | (a[:, 2] << 4) | (a[:, 3] << 6)
    return by.view("<u4")


def pack2_torch(symbols: torch.Tensor, total: int) -> torch.Tensor:
    """``pack2`` on the device of ``symbols`` (uint8 [n], n <= total):
    int32 words (the uint32 bit view), 16 bases each, low bits first;
    BREAK packs as code 0 and the symbols from n to ``total`` (a multiple
    of 16) as 0."""
    a = torch.zeros(total, dtype=torch.uint8, device=symbols.device)
    torch.bitwise_and(symbols, 3, out=a[: symbols.numel()])
    a = a.view(-1, 4)
    by = a[:, 0] | (a[:, 1] << 2) | (a[:, 2] << 4) | (a[:, 3] << 6)
    return by.view(torch.int32)


def _assemble(pieces, block: int, W: int, staging: Staging):
    """Copy an iterator of symbol arrays into the staging buffers in
    rotation, as (global_start, n, buffer) chunks of at most ``block``
    symbols, consecutive chunks overlapping by W-1 so every window is
    seen exactly once: each symbol is copied once, and only the W-1
    overlap symbols again into the next buffer. Consumes ``pieces``
    lazily, so upstream parsing overlaps downstream work. Chunk sizes
    ramp up (4M -> 8M -> ... -> block) so the first chunk starts as soon
    as about one genome has parsed."""
    gstart = 0
    target = min(1 << 22, block)
    slot = 0
    buf = staging.writable(slot)
    fill = 0
    for piece in pieces:
        off = 0
        while off < piece.size:
            take = min(piece.size - off, target - fill)
            buf[fill:fill + take] = piece[off:off + take]
            fill += take
            off += take
            if fill == target:
                yield gstart, fill, slot
                nxt = (slot + 1) % staging.count
                head = staging.writable(nxt)
                head[:W - 1] = buf[target - (W - 1):target]
                gstart += target - (W - 1)
                slot, buf, fill = nxt, head, W - 1
                target = min(target * 2, block)
    if fill >= W:
        yield gstart, fill, slot


def _stream_packed(
    pieces,
    shuffled_dim,
    params: SketchParams,
    block: int,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming core: each chunk's symbols go to the device once, where
    they are packed to 2 bits a base and their breaks summed; the keep
    pass runs, and its fill pass waits until the next chunk is on its
    way; the kept windows that reach past the chunk or cover a BREAK are
    marked there by position, and the pairs of all chunks come back in
    one fetch. Returns (codes uint64, positions int64) in sequence
    order."""
    if block % 16 or block < max(params.TL, 16):
        raise ValueError(f"block {block}: a multiple of 16 of at least a window")
    device = resolve_device(device)  # names the card: one staging set per card
    shuf = as_shuf(shuffled_dim, device)
    W = params.TL
    span = torch.profiler.record_function
    kept: list[tuple[torch.Tensor, torch.Tensor]] = []

    def finish(gstart, n, breaks, fill):
        pos, code = fill()
        # breaks[p] = BREAKs before p: a window at p covers none when
        # breaks[p + W] == breaks[p]
        end = (pos + W).clamp_(max=n)
        ok = (breaks[end] == breaks[pos]) & (pos <= n - W)
        # int32 codes are non-negative; int64 codes are uint64 bit patterns
        kept.append((torch.stack([pos + gstart, code.to(torch.int64)]), ok))

    with borrow(device, block) as staging:
        chunks = _assemble(pieces, block, W, staging)
        pending = None
        while True:
            with span("sketch.assemble"):
                item = next(chunks, None)
            if item is None:
                break
            gstart, n, slot = item
            with span("sketch.upload"):
                sym = staging.upload(slot, n)
            with span("sketch.launch"):
                bucket = min(block, max(4096, 1 << (n - 1).bit_length()))
                words = pack2_torch(sym, bucket)
                breaks = torch.zeros(n + 1, dtype=torch.int32, device=device)
                torch.cumsum(sym >= BREAK, 0, dtype=torch.int32, out=breaks[1:])
                fill = sketch_windows_keep(words, n, shuf, params)
            if pending is not None:
                with span("sketch.fill"):
                    finish(*pending)
            pending = (gstart, n, breaks, fill)
        if pending is not None:
            with span("sketch.fill"):
                finish(*pending)
    if not kept:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    with span("sketch.fetch"):
        pairs = torch.cat([p for p, _ in kept], 1)[:, torch.cat([k for _, k in kept])]
        out = pairs.cpu().numpy()
    return out[1].view(np.uint64), out[0]


def sketch_codes_stream(
    symbols: np.ndarray,
    shuffled_dim,
    params: SketchParams,
    block: int = STREAM_BLOCK,
    *,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray]:
    """Stream a symbol array through the device kernel in blocks; returns
    (codes uint64, window start positions int64), both in sequence
    order."""
    if symbols.size < params.TL:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return _stream_packed([symbols], shuffled_dim, params, block, device)


def sketch_codes_multi(
    streams,
    shuffled_dim,
    params: SketchParams,
    block: int = STREAM_BLOCK,
    *,
    device: torch.device,
) -> list[np.ndarray]:
    """Sketch MANY symbol streams (list OR lazy iterator) in one
    concatenated device pass.

    Streams are joined with BREAK separators; kept codes are attributed
    back to their stream by window position. A lazy ``streams`` iterator
    lets host parsing overlap the device pass (pipeline.parsed_streams).
    """
    brk = np.array([BREAK], dtype=np.uint8)
    bounds = [0]

    def pieces():
        # a stream may itself be an iterator of symbol pieces (the
        # bounded-RAM file streaming of seqio.stream_*_codes)
        for s in streams:
            if isinstance(s, np.ndarray):
                size = s.size
                yield s
            else:
                size = 0
                for p in s:
                    size += p.size
                    yield p
            yield brk
            bounds.append(bounds[-1] + size + 1)

    codes, pos = _stream_packed(pieces(), shuffled_dim, params, block, device)
    nb = np.asarray(bounds, dtype=np.int64)  # complete once collected
    sid = np.searchsorted(nb, pos, side="right") - 1
    return [codes[sid == i] for i in range(nb.size - 1)]


def sketch_codes_reads(
    reads: list[np.ndarray],
    shuffled_dim,
    params: SketchParams,
    block: int = STREAM_BLOCK,
    *,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray]:
    """Sketch a list of reads; returns (codes, read_id) arrays with codes
    in (read, position) order — the --byread streaming layout
    (reads2mco, iseq2comem.c:78-186).

    Reads are concatenated with BREAK separators and pushed through the
    same windowed kernel, so one device pass covers the whole batch.
    """
    if not reads:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    brk = np.array([BREAK], dtype=np.uint8)
    pieces = []
    bounds = np.zeros(len(reads) + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        pieces.append(r)
        pieces.append(brk)
        bounds[i + 1] = bounds[i] + r.size + 1
    symbols = np.concatenate(pieces)
    codes, pos = sketch_codes_stream(symbols, shuffled_dim, params, block,
                                     device=device)
    # window starting at p belongs to the read whose span contains p
    read_id = np.searchsorted(bounds, pos, side="right") - 1
    return codes, read_id
