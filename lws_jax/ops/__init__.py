"""GPU kernels for the LWS sweeps (the kernels the processor runs).

- `gs_sweeps` — batch/no-future sweeps in exact frame order, one program
  per utterance; the production batch kernel.
- `segmented_gs_sweeps` — the same with each utterance's time axis split
  into segments that run as separate programs (long single streams).
- `online_sweeps` / `online_chunk` / `online_chunk_init` — online
  (TF-RTISI-LA) kernel, offline and carried-state streaming forms.
- `kernel_supported` — the kernels' shape rule.
"""
from .gpu_sweeps import (
    MAX_BINS,
    MAX_Q,
    gs_sweeps,
    kernel_supported,
    online_chunk,
    online_chunk_init,
    online_sweeps,
    segmented_gs_sweeps,
)

__all__ = [
    "MAX_BINS",
    "MAX_Q",
    "gs_sweeps",
    "kernel_supported",
    "online_chunk",
    "online_chunk_init",
    "online_sweeps",
    "segmented_gs_sweeps",
]
