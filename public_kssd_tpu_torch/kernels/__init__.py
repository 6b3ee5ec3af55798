"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<source>.cu`` exposes plain C entry points, one per kernel,
that launch on the stream they are given and return ``cudaGetLastError()``.
A source is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``build/public_kssd_tpu_torch/`` under the checkout, at first use, under a
name keyed by the source's hash and the flags, and loaded with ctypes; the
kernels of one source share its library. Nothing is compiled when this
module is imported.

A build failure (no ``nvcc``, a compile error) raises ``KernelBuildError``
with the compiler's output; a launch that returns an error raises
``KernelLaunchError``. Callers never fall back to another path on either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(_PKG), "build", "public_kssd_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    cand = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked for {cand} and on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


class CudaKernel:
    """One kernel: its entry point in a lazily built and loaded library
    (``csrc/<source>.cu``, ``source`` defaulting to ``name``), with a
    launch count.

    ``launches`` counts the successful launches through ``launch`` and
    nothing else, so a run can show that its path went through the
    kernel. A kernel whose work takes two launches (the keep or count
    pass and the fill pass of the sketch and join kernels) counts the
    second with ``count=False``."""

    def __init__(self, name: str, entry: str, argtypes: list,
                 source: str | None = None):
        self.name = name
        self.entry = entry
        self.argtypes = argtypes
        self.source = os.path.join(CSRC_DIR, f"{source or name}.cu")
        self.launches = 0
        self._lib = None
        self._fn = None

    def so_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        with open(self.source, "rb") as f:
            h.update(f.read())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless this exact build exists; returns the
        library path. Writes a temporary name first and renames it, so a
        concurrent process never loads a half-written library."""
        so = self.so_path()
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
        return so

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(self.build())
        return self._lib

    def function(self):
        if self._fn is None:
            fn = getattr(self.library(), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def constant(self, entry: str) -> int:
        """An int that the library exports through the C function
        ``entry`` of no arguments: a size the kernel and its wrapper must
        agree on, kept in the source alone."""
        fn = getattr(self.library(), entry)
        fn.argtypes, fn.restype = [], ctypes.c_int
        return fn()

    def launch(self, *args, count: bool = True) -> None:
        """Launch through the C entry; raise on a nonzero cudaError_t."""
        err = self.function()(*args)
        if err != 0:
            raise KernelLaunchError(
                f"{self.entry} returned cudaError_t {err}"
            )
        if count:
            self.launches += 1


_SKETCH_ARGS = [_I, _P, _I64, _I64, _I, _I, _U32, _U64, _U64, _I, _I, _I, _I,
                _I, _U32, _U32, _U32, _U32, _P, _I64, _P, _P, _P, _P, _P]
sketch_kernel = CudaKernel("sketch", "kssd_sketch", _SKETCH_ARGS)
sketch_wide_kernel = CudaKernel(
    "sketch_wide", "kssd_sketch_wide", _SKETCH_ARGS, source="sketch"
)
# variant, codes, qids, [weights,] n_codes, seg, n_qry, uniq, nnz, dir,
# n_buckets, shift, offsets, gids, n_ref, counts, [weighted,] stream
_COUNT_ARGS = [_I, _P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _I, _P, _P,
               _I64, _P, _P]
_COUNT_KOC_ARGS = [_I, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _I, _P,
                   _P, _I64, _P, _P, _P]
count_kernel = CudaKernel("count", "kssd_count_shared", _COUNT_ARGS)
count_koc_kernel = CudaKernel(
    "count_koc", "kssd_count_koc", _COUNT_KOC_ARGS, source="count"
)
# pass, u, n_rows, [offs,] gids, sq, sqid, sab, dir, n_buckets, dir_shift,
# qid_shift, n_tiles, n_pieces, hit_bits, tile_counts, keys, stream
_JOIN_ARGS = [_I, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I64,
              _P, _P, _P, _P]
join_kernel = CudaKernel("join", "kssd_join", _JOIN_ARGS)
# the 64-bit-key instances of the mesh paths (folded component keys)
count64_kernel = CudaKernel(
    "count64", "kssd_count_shared64", _COUNT_ARGS, source="count"
)
count_koc64_kernel = CudaKernel(
    "count_koc64", "kssd_count_koc64", _COUNT_KOC_ARGS, source="count"
)
join64_kernel = CudaKernel(
    "join64", "kssd_join64", _JOIN_ARGS[:3] + _JOIN_ARGS[4:], source="join",
)
ALL = (sketch_kernel, sketch_wide_kernel, count_kernel, count_koc_kernel,
       join_kernel, count64_kernel, count_koc64_kernel, join64_kernel)


def stream_handle(device) -> int:
    """The raw cudaStream_t of torch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
