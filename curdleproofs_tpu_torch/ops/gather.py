"""Exact 32-bit gathers: along the last axis, row-local, and routed.

Counterpart of the JAX package's `ops.gather` (`gather_u32`,
`gather_u32_shared` over kernels `_build` and `_build_wlead`;
`rowwise_gather` over `_build_rowwise`; `routed_gather`). There every gather
is a one-hot matrix product, because that machine has no fast lane gather; a
GPU thread loads from the address, so the CUDA kernels are direct indexed
copies, both bound by bytes (every output word is one load and one store):

  * `gather_kernel` (../csrc/kernels.cu) serves `gather_u32` and
    `gather_u32_shared`, with a table a window or one shared table. Where a
    gather fetches most records of a large table (`records_pay`), the
    wrapper first copies the (R, W, N) limb rows to (W, N, RP) records
    (`record_major`), so a record is a few aligned 16-byte loads and not R
    loads a table row apart; elsewhere the kernel reads the limb rows in
    place (`gather_layout` takes either).
  * `rowwise_gather_kernel` (../csrc/gather.cu) is the row-local batched
    gather; stores coalesce, loads stay inside one table row.

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


def record_pitch(R: int) -> int:
    """Words a record takes in the record-major table: R rounded up to whole
    32-byte sectors."""
    return -(-R // 8) * 8


def record_major(table: torch.Tensor) -> torch.Tensor:
    """(R, W, N) limb rows -> (W, N, RP) records, one copy; the pad words
    are never read into an output and stay uninitialised."""
    R, W, N = table.shape
    rec = torch.empty((W, N, record_pitch(R)), dtype=table.dtype, device=table.device)
    rec[..., :R].copy_(table.permute(1, 2, 0))
    return rec


def gather_records_ref(rec: torch.Tensor, idx: torch.Tensor, R: int) -> torch.Tensor:
    """Plain PyTorch version of the record-major gather kernel: rec (Wt, N,
    RP) with Wt 1 (shared) or W, idx (W, M) -> (R, W, M)."""
    Wt, N, _ = rec.shape
    W = idx.shape[0]
    idx = idx.to(torch.int64)
    hit = (idx >= 0) & (idx < N)
    safe = idx.clamp(0, N - 1)
    win = torch.arange(W, device=rec.device).unsqueeze(1) if Wt != 1 else torch.zeros(
        (W, 1), dtype=torch.int64, device=rec.device
    )
    g = rec[win, safe][..., :R]
    g = torch.where(hit.unsqueeze(-1), g, torch.zeros_like(g))
    return g.permute(2, 0, 1).contiguous()


def records_pay(R: int, Wt: int, N: int, W: int, M: int) -> bool:
    """Whether `gather_u32` copies the table record-major first: where the
    gather fetches at least as many records as the table holds, from a table
    of 4 MiB or more. Gathering from the limb-major rows reads a 32-byte
    sector for each 4-byte word, L2 or not; the copy pays for that where
    most records are fetched, but not where few are, nor on a table so small
    that the copy's own launch is most of the time. On an H100 (chip_smoke.py,
    `kernel_times`): the copy paid, 2.1 to 2.3x, for the sorted-order gather
    of all point records from tables of 6.4, 12.8 and 25.7 MB (msm() at n =
    2^14, 2^15, 2^16); it lost for the stitch's boundary gathers, 8,191 a
    window from 32,768 selected prefixes and from the 1.5 MB lane-offset
    table. Between 1.5 and 6.4 MB the crossing is not measured."""
    return W * M >= Wt * N and Wt * N * R >= 1 << 20


def gather_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, W, N) int32, idx (W, M) int32 -> (R, W, M) int32. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if table.ndim != 3 or idx.ndim != 2 or idx.shape[0] != table.shape[1]:
        raise ValueError(
            f"gather_u32: table {tuple(table.shape)} / idx {tuple(idx.shape)} mismatch"
        )
    return _gather(table, idx)


def gather_u32_shared(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather with one shared table: table (R, N), idx (W, M) -> (R, W, M).
    The kernel reads the one table for all W windows."""
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(
            f"gather_u32_shared: table {tuple(table.shape)} / idx {tuple(idx.shape)} mismatch"
        )
    return _gather(table.unsqueeze(1), idx)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, Wt, N) with Wt 1 (shared) or W, idx (W, M) -> (R, W, M), in
    the layout `records_pay` picks."""
    R, Wt, N = table.shape
    W, M = idx.shape
    if records_pay(R, Wt, N, W, M):
        return gather_layout(record_major(table), idx, R, records=True)
    return gather_layout(table, idx, R, records=False)


def gather_layout(src: torch.Tensor, idx: torch.Tensor, R: int, records: bool) -> torch.Tensor:
    """The gather kernel on a table already in its layout: (Wt, N, RP)
    record-major with RP = record_pitch(R), or (R, Wt, N) limb-major; Wt is 1
    (shared) or W; idx (W, M) -> (R, W, M). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if src.ndim != 3 or idx.ndim != 2:
        raise ValueError(f"gather_layout: table {tuple(src.shape)} / idx {tuple(idx.shape)} mismatch")
    W, M = idx.shape
    Wt, N, RP = src.shape if records else (src.shape[1], src.shape[2], R)
    want = (Wt, N, record_pitch(R)) if records else (R, Wt, N)
    if tuple(src.shape) != want or Wt not in (1, W):
        raise ValueError(
            f"gather_layout: a {'record' if records else 'limb'}-major table of {R}-word records "
            f"for {W} windows cannot have shape {tuple(src.shape)}"
        )
    if not src.is_cuda:
        if records:
            return gather_records_ref(src, idx, R)
        return gather_u32_ref(src.expand(R, W, N), idx)
    cuda_g1.check_tensor("gather_u32 table", src, want)
    cuda_g1.check_tensor("gather_u32 idx", idx, (W, M))
    out = torch.empty((R, W, M), dtype=torch.int32, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        rc = cuda_g1.lib().curdle_gather_u32(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), R, RP, Wt, W, N, M, int(records),
            cuda_g1.stream_ptr(),
        )
    cuda_g1.check_launch("gather_u32", rc)
    cuda_g1.launch_counts["gather_u32"] += 1
    return out


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
