"""Computed shuffle space: a Feistel-network permutation of the inner
substring space.

The reference samples k-mer space with a Fisher-Yates random permutation
table of the 16^s inner-substring space (shuffle(), command_shuffle.c:
131-153). Any bijection of [0, 16^s) gives a valid, deterministic,
order-free sample of k-mer space with the same statistical guarantees (a
uniformly random choice among permutations is not required, only fixed and
well-mixing). So the default shuffle space is a 4-round balanced Feistel
network over the 4s-bit inner value, whose round keys derive from the
``.shuf`` id: the sketch kernel evaluates rank and membership in
registers, with no table gather.

Interop is preserved in both directions:

  * ``make_feistel_dim`` materialises the identical ``.shuf`` table/file
    (command_shuffle.c:184-185 format), so the reference binary can
    consume sketches/DBs produced with a computed space.
  * ``detect`` recognises a ``.shuf`` file that encodes a Feistel space
    (the header ``id`` doubles as the seed) and upgrades the kernel to
    the gather-free path; any foreign ``.shuf`` falls back to the
    table-gather path with unchanged semantics.

``feistel_torch`` is the same permutation on int64 tensors (torch has no
arithmetic on unsigned 32-bit tensors): every product is masked back to 32
bits, which keeps it bit-identical to the uint32 evaluation on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from public_kssd_tpu_torch.config import SketchParams

_ROUNDS = 4
_GOLDEN = 0x9E3779B1  # 2^32/phi, odd -> bijective multiplier mod 2^32
_MIX2 = 0x85EBCA6B  # murmur3 fmix constant


class ComputedShuf(NamedTuple):
    """Static (hashable) description of a computed shuffle space.

    Passed in place of the shuffled-dim table; the sketch kernel
    evaluates the permutation in-register instead of gathering.
    """

    seed: int  # .shuf header id
    subctx_len: int  # s: permutation domain is 16^s

    @property
    def keys(self) -> tuple[int, ...]:
        return _round_keys(self.seed)


def _round_keys(seed: int) -> tuple[int, ...]:
    """Derive _ROUNDS 32-bit round keys from the seed (splitmix32)."""
    x = np.uint64(seed & 0xFFFFFFFF)
    keys = []
    for _ in range(_ROUNDS):
        x = (x + np.uint64(0x9E3779B9)) & np.uint64(0xFFFFFFFF)
        z = x
        z = ((z ^ (z >> np.uint64(16))) * np.uint64(0x21F0AAAD)) & np.uint64(
            0xFFFFFFFF
        )
        z = ((z ^ (z >> np.uint64(15))) * np.uint64(0x735A2D97)) & np.uint64(
            0xFFFFFFFF
        )
        z = z ^ (z >> np.uint64(15))
        keys.append(int(z))
    return tuple(keys)


def feistel(xp, inner, seed: int, subctx_len: int):
    """Permutation value (rank) of ``inner`` in [0, 16^s).

    ``xp`` is numpy or jax.numpy; ``inner`` is a uint32 array. A 4-round
    balanced Feistel network on (2s | 2s) bits: structurally a bijection
    of [0, 16^s) for any round function. All ops wrap mod 2^32, so the
    numpy and jnp evaluations are bit-identical.
    """
    h = 2 * subctx_len  # half width in bits
    mask = xp.uint32((1 << h) - 1)
    left = (inner >> xp.uint32(h)) & mask
    right = inner & mask
    # Right shifts are masked to the logically-shifted width: a no-op under
    # correct uint32 semantics, but required inside Pallas kernels, where
    # Mosaic lowers uint32 ``>>`` as an ARITHMETIC i32 shift (sign bits
    # would smear into the high lanes and corrupt the permutation).
    m15 = xp.uint32(0xFFFFFFFF >> 15)
    m13 = xp.uint32(0xFFFFFFFF >> 13)
    for key in _round_keys(seed):
        # round function: multiply-add-xor mixer, truncated to h bits
        f = right * xp.uint32(_GOLDEN) + xp.uint32(key)
        f = f ^ ((f >> xp.uint32(15)) & m15)
        f = f * xp.uint32(_MIX2)
        f = (f ^ ((f >> xp.uint32(13)) & m13)) & mask
        left, right = right, left ^ f
    return (left << xp.uint32(h)) | right


def make_feistel_dim(params: SketchParams, seed: int | None = None) -> np.ndarray:
    """Materialise the computed permutation as a ``.shuf``-shaped table.

    ``seed`` defaults to ``params.id`` -- writing the table with
    ``formats.write_shuf`` then makes the file self-describing (detect()
    recovers the computed space from the header alone).
    """
    if seed is None:
        seed = params.id
    idx = np.arange(params.dim_shuf_len, dtype=np.uint32)
    return feistel(np, idx, seed, params.half_subctx_len).astype("<i4")


def detect(
    params: SketchParams, table: np.ndarray, device: torch.device | None = None
) -> ComputedShuf | None:
    """Return the ComputedShuf encoded by a ``.shuf`` table, or None.

    The candidate seed is the header id; a cheap spot-check precedes the
    full-table comparison so foreign tables bail out in microseconds. On
    a CUDA ``device`` the full comparison runs on the card
    (``_matches_feistel_torch``); otherwise it is numpy's, as in the
    JAX package.
    """
    cand = ComputedShuf(seed=params.id, subctx_len=params.half_subctx_len)
    n = params.dim_shuf_len
    probe = np.arange(0, n, max(n // 64, 1), dtype=np.uint32)
    expect = feistel(np, probe, cand.seed, cand.subctx_len)
    if not np.array_equal(
        np.asarray(table, dtype=np.int64)[probe.astype(np.int64)],
        expect.astype(np.int64),
    ):
        return None
    if device is not None and torch.device(device).type == "cuda":
        return cand if _matches_feistel_torch(table, cand, device) else None
    full = make_feistel_dim(params, cand.seed)
    if not np.array_equal(np.asarray(table, dtype="<i4"), full):
        return None
    return cand


_CHECK_CHUNK = 1 << 24  # entries a step: 16^6 in one, 16^7 in 16


def _matches_feistel_torch(
    table: np.ndarray, cand: ComputedShuf, device: torch.device
) -> bool:
    """Whether ``table`` holds ``feistel_torch`` of every index, computed
    on ``device``: the table goes up once as int32 and the answer comes
    back with one sync. Steps of ``_CHECK_CHUNK`` entries bound the int64
    temporaries at 16^7 entries."""
    n = 1 << (4 * cand.subctx_len)
    if np.size(table) != n:
        return False
    tab = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int32)).to(device)
    ok = torch.ones((), dtype=torch.bool, device=device)
    for lo in range(0, n, _CHECK_CHUNK):
        idx = torch.arange(lo, min(lo + _CHECK_CHUNK, n), device=device)
        rank = feistel_torch(idx, cand.seed, cand.subctx_len)
        ok &= (rank == tab[lo:lo + idx.numel()]).all()
    return bool(ok)


_M32 = 0xFFFFFFFF


def feistel_torch(inner: torch.Tensor, seed: int, subctx_len: int) -> torch.Tensor:
    """``feistel`` on an int64 tensor of inner values in [0, 16^s): the
    rank as int64, bit-identical to ``feistel(np, inner.astype(uint32))``.

    int64 products wrap mod 2^64 in two's complement, so masking with
    2^32-1 after each multiply gives the uint32 product exactly; shifts
    act on masked, non-negative values only."""
    h = 2 * subctx_len
    mask = (1 << h) - 1
    left = (inner >> h) & mask
    right = inner & mask
    for key in _round_keys(seed):
        f = (right * _GOLDEN + key) & _M32
        f = f ^ (f >> 15)
        f = (f * _MIX2) & _M32
        f = (f ^ (f >> 13)) & mask
        left, right = right, left ^ f
    return (left << h) | right
