"""public_kssd_tpu_torch — the k-mer substring-space sketching framework
on PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

This package runs the ``dist`` main path of ``public_kssd_tpu`` — shuffle
space -> stage I sketch -> stage II index -> search -> ``distance.out`` —
with the same on-disk artifacts, byte for byte:

  host (python / C helpers)          device (torch + CUDA kernels)
  ---------------------------        ----------------------------------
  fasta/fastq parsing + 2-bit    ->  window extraction, canonical k-mer,
  packing, dedup, file formats       shuffled-space filter, drtuple
                                     repack (csrc/sketch.cu)
  CSR index artifacts            ->  shared-k-mer counting with integer
                                     atomics (csrc/count.cu)
  exact float64 stats + printf   <-  count matrices
  formatting (ops.stats)

Every kernel has a plain PyTorch version in the same module; a wrapper
uses the plain version for CPU tensors and launches the kernel (or
raises) for CUDA tensors. Nothing here imports jax. Importing the package
(and its CLI, ``cli.py``) imports no torch: a fresh ``kssd_torch``
process starts the card before torch is imported (``start.py``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"
__all__ = ["__version__", "resolve_device"]


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``, with a CUDA device always carrying its
    index; raises when CUDA is asked for and no card is visible (there is
    no silent CPU fallback). Before torch has started CUDA in this
    process, the current card is the first: that index is given without
    starting CUDA here, so that a thread starting the card
    (``start.CardStart``) is not waited for."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu (device=\"cpu\" from Python) to "
                "run the plain PyTorch path"
            )
        if dev.index is None:
            # "cuda" and "cuda:0" compare unequal: always name the card
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_initialized() else 0)
    return dev
