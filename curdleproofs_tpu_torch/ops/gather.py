"""Exact 32-bit gather along the last axis.

Counterpart of the JAX package's `ops.gather` (`gather_u32`,
`gather_u32_shared`; kernels `_build` and `_build_wlead`). There the gather
is a one-hot matrix product, because that machine has no fast lane gather; a
GPU thread loads from the address, so the CUDA kernel (`gather_kernel` in
../csrc/kernels.cu) is a direct indexed copy and one kernel serves both the
shared-table and the per-window layout. Bound by bytes: every output word is
one load and one store; stores coalesce, loads are as scattered as the
indices.

Semantics: out[r, w, j] = table[r, w, idx[w, j]], and 0 where the index lies
outside [0, N). The streaming MSM leans on that: an all-zero Jacobian triple
has z == 0, the identity, so empty boundaries need no mask.
"""
from __future__ import annotations

import torch

from curdleproofs_tpu_torch.ops import cuda_g1


def gather_u32_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_u32`."""
    R, W, N = table.shape
    idx = idx.to(torch.int64)
    hit = (idx >= 0) & (idx < N)
    safe = idx.clamp(0, N - 1)
    g = torch.take_along_dim(table, safe.unsqueeze(0).expand(R, -1, -1), dim=-1)
    return torch.where(hit.unsqueeze(0), g, torch.zeros_like(g))


def gather_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, W, N) int32, idx (W, M) int32 -> (R, W, M) int32. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if table.ndim != 3 or idx.ndim != 2 or idx.shape[0] != table.shape[1]:
        raise ValueError(
            f"gather_u32: table {tuple(table.shape)} / idx {tuple(idx.shape)} mismatch"
        )
    if not table.is_cuda:
        return gather_u32_ref(table, idx)
    R, W, N = table.shape
    M = idx.shape[1]
    cuda_g1.check_tensor("gather_u32 table", table, (R, W, N))
    cuda_g1.check_tensor("gather_u32 idx", idx, (W, M))
    out = torch.empty((R, W, M), dtype=torch.int32, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = cuda_g1.lib().curdle_gather_u32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, W, N, M, cuda_g1.stream_ptr()
        )
    cuda_g1.check_launch("gather_u32", rc)
    cuda_g1.launch_counts["gather_u32"] += 1
    return out


def gather_u32_shared(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather with one shared table: table (R, N), idx (W, M) -> (R, W, M).
    The W windows are flattened into the M axis of one unbatched call."""
    R, N = table.shape
    W, M = idx.shape
    flat = gather_u32(table.unsqueeze(1), idx.reshape(1, W * M))
    return flat.reshape(R, W, M)
