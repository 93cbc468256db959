"""Exact 32-bit gathers: along the last axis, row-local, and routed.

Counterpart of the JAX package's `ops.gather` (`gather_u32`,
`gather_u32_shared` over kernels `_build` and `_build_wlead`;
`rowwise_gather` over `_build_rowwise`; `routed_gather`). There every gather
is a one-hot matrix product, because that machine has no fast lane gather; a
GPU thread loads from the address, so the CUDA kernels are direct indexed
copies: `gather_kernel` (../csrc/kernels.cu) serves both the shared-table and
the per-window layout of `gather_u32`, `rowwise_gather_kernel`
(../csrc/gather.cu) the row-local batched gather. Both are bound by bytes:
every output word is one load and one store; stores coalesce, loads are as
scattered as the indices.

Semantics: out[r, w, j] = table[r, w, idx[w, j]] (`gather_u32`) and
out[g, r, m] = table[g, r, idx[g, m]] (`rowwise_gather`), and 0 where the
index lies outside the table. The streaming MSM leans on that: an all-zero
Jacobian triple has z == 0, the identity, so empty boundaries need no mask.

`routed_gather` applies a permutation to a shared table as three row-local
gathers over the (r x c) view of the positions, from the index tables of
`ops.route.decompose`, with two transposes between them. It computes what
one `gather_u32_shared` call computes.
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


def rowwise_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `rowwise_gather`."""
    G, R, K = table.shape
    idx = idx.to(torch.int64)
    hit = (idx >= 0) & (idx < K)
    safe = idx.clamp(0, max(K - 1, 0))
    g = torch.take_along_dim(table, safe.unsqueeze(1).expand(-1, R, -1), dim=-1)
    return torch.where(hit.unsqueeze(1), g, torch.zeros_like(g))


def rowwise_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row-local gather: table (G, R, K) int32, idx (G, M) int32 ->
    (G, R, M) int32, out[g, :, m] = table[g, :, idx[g, m]], 0 where the index
    lies outside [0, K). The CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if table.ndim != 3 or idx.ndim != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(
            f"rowwise_gather: table {tuple(table.shape)} / idx {tuple(idx.shape)} mismatch"
        )
    if not table.is_cuda:
        return rowwise_gather_ref(table, idx)
    G, R, K = table.shape
    M = idx.shape[1]
    cuda_g1.check_tensor("rowwise_gather table", table, (G, R, K))
    cuda_g1.check_tensor("rowwise_gather idx", idx, (G, M))
    out = torch.empty((G, R, M), dtype=torch.int32, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = cuda_g1.lib().curdle_rowwise_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), G, R, K, M, cuda_g1.stream_ptr()
        )
    cuda_g1.check_launch("rowwise_gather", rc)
    cuda_g1.launch_counts["rowwise_gather"] += 1
    return out


def routed_gather(
    packed: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor
) -> torch.Tensor:
    """Permutation gather of a shared table via 3-stage routing tables.

    packed (R, n) int32; i1 (W, r, c), i2 (W, c, r), i3 (W, r, c) int32 from
    `ops.route.decompose`. Returns (R, W, n) int32 with
    out[:, w, a2*c + b] = packed[:, src_w[a2*c + b]] for the permutation
    src_w the tables encode. Three `rowwise_gather` launches; the reshapes
    and transposes between the stages are plain tensor ops (one copy each)."""
    R, n = packed.shape
    W, r, c = i1.shape
    if r * c != n or tuple(i2.shape) != (W, c, r) or tuple(i3.shape) != (W, r, c):
        raise ValueError(
            f"routed_gather: tables {tuple(i1.shape)}, {tuple(i2.shape)}, {tuple(i3.shape)} "
            f"do not route {n} positions"
        )
    # stage 1: r groups SHARED by all windows -> gather all W*c targets of
    # each source row at once (bigger M per group, no table broadcast)
    tab1 = packed.reshape(R, r, c).transpose(0, 1).contiguous()  # (r, R, c)
    idx1 = i1.transpose(0, 1).reshape(r, W * c).contiguous()
    s1 = rowwise_gather(tab1, idx1)  # (r, R, W*c): s1[a, :, (w, j)]
    # stage 2 table: X2[(w, j), :, a] = s1[a, :, (w, j)]
    tab2 = s1.reshape(r, R, W, c).permute(2, 3, 1, 0).reshape(W * c, R, r).contiguous()
    s2 = rowwise_gather(tab2, i2.reshape(W * c, r).contiguous())  # (W*c, R, r)
    # stage 3 table: X3[(w, a2), :, j] = s2[(w, j), :, a2]
    tab3 = s2.reshape(W, c, R, r).permute(0, 3, 2, 1).reshape(W * r, R, c).contiguous()
    s3 = rowwise_gather(tab3, i3.reshape(W * r, c).contiguous())  # (W*r, R, c)
    return s3.reshape(W, r, R, c).permute(2, 0, 1, 3).reshape(R, W, n)
