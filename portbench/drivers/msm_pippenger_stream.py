"""Driver for `curdleproofs_tpu_torch.ops.msm.msm_pippenger_stream`: one
whole MSM through the engine `msm()` picks from `STREAM_MIN` bases up, with
the bases on the card as the batch verifier's `PointVec` keeps them and the
scalars as host (16, n) uint32 limbs, as `msm()` hands them over. The
engine's own choices (window bits, window chunks, the selection scan, the
gather) are left to it.

Set-up is `msm_pippenger.py`'s, loaded from that file: b_i and the first
scalars drawn on the card from the seed, the bases P_i = b_i * G made there.
The scalars are then copied home once. Call i first gives `lanes_per_call`
lanes new scalars (one lane drawn in each of as many equal strides, the
values by the traffic's sampler, on the host from a generator seeded by the
seed), then runs the engine on the bases and the host scalars as they now
stand. `collect`, `check`, the plain reference and the control are the
other driver's, unchanged.

Set-up first fixes the C allocator's thresholds (`keep_freed_memory`), as a
long-running client sets `MALLOC_MMAP_THRESHOLD_` and
`MALLOC_TRIM_THRESHOLD_`: the host tables a call allocates (about 12 MiB)
then come back from the heap the next call. Left to glibc's defaults they
go back to the kernel after every call and are faulted in again, some
3,100 page faults a call whose cost follows the host's memory traffic, so
the runs of one program spread by 20 % and more.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import importlib
import importlib.util
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _load_sibling(name: str):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_device_sorted = _load_sibling("msm_pippenger")

ENTRY_MODULE = _device_sorted.ENTRY_MODULE
ENTRY = "msm_pippenger_stream"
# Port functions the traced run wraps in a profiler span of their own, so an
# idle stretch of the card is named by the host work open at the time.
TRACE_SPANS = {
    "curdleproofs_tpu_torch.ops.msm": ["stream_prep", "_stream_chunks", "_combine_packed"],
    "curdleproofs_tpu_torch.ops.g1": ["jpoints_to_host"],
}
CONTROLS = _device_sorted.CONTROLS

# glibc's mallopt parameters and the values set: allocations below 32 MiB
# come from the heap, and the heap keeps up to 256 MiB of freed top
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MMAP_THRESHOLD_BYTES = 32 << 20
TRIM_THRESHOLD_BYTES = 256 << 20


def keep_freed_memory() -> bool:
    """Fix the C allocator's mmap and trim thresholds for this process, so
    memory a call frees is reused by the next one. False where the C
    library has no `mallopt` or refuses a value (the defaults stay)."""
    name = ctypes.util.find_library("c")
    try:
        mallopt = ctypes.CDLL(name).mallopt
    except (OSError, AttributeError, TypeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    return (mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD_BYTES) == 1
            and mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD_BYTES) == 1)


class Cell(_device_sorted.Cell):
    """One configuration under one traffic mix, set up on `device`; the
    scalars live on the host."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, control: Optional[str] = None) -> None:
        keep_freed_memory()
        super().__init__(config, traffic, seed, device, control)
        self.scalars = self.scalars.cpu().numpy().astype(np.uint32)
        self.offsets = torch.arange(self.lanes, dtype=torch.int64) * self.stride
        self.host_gen = torch.Generator().manual_seed(seed)
        self.entry = getattr(importlib.import_module(ENTRY_MODULE), ENTRY)

    def call(self, i: int):
        """New scalars in this call's lanes, on the host, then the engine on
        all n."""
        lanes = self.offsets + torch.randint(0, self.stride, (self.lanes,), generator=self.host_gen)
        vals = self.draw(self.host_gen, self.lanes, "cpu")
        self.scalars[:, lanes.numpy()] = vals.numpy()
        self.rewrites.append((i, lanes, vals))
        return i, self.entry(self.bases, self.scalars)


def setup(config: dict, traffic: dict, seed: int, device, control: Optional[str] = None) -> Cell:
    return Cell(config, traffic, seed, device, control)
