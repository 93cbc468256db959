"""Streaming group-prefix-scan over digit-sorted point records.

Phase 1 of the host-sorted Pippenger MSM (ops.msm). Counterpart of the JAX
package's `ops.stream_scan` (`scan_records`, `scan_records_sel`; kernels
`_build_scan` and `_build_scan_sel`).

  * The n sorted points of each window are laid out column-major over L
    lanes: lane l holds sorted ranks [l*T, (l+1)*T), flat position
    w*T*L + t*L + l. Each (window, lane) is a running prefix over
    t = 0..T-1, one Jacobian+affine mixed add a step, held in registers by
    K GPU threads, one a sub-chain of T/K steps (below).
  * Per-lane totals come out as a (72, W, L) side output; a small scan over
    the L lanes (ops.scan._hs_scan) turns them into lane offsets, and only
    bucket-boundary prefixes are ever stitched (ops.msm).

Two kernels, one template (`scan_kernel<FULL>`, ../csrc/kernels.cu), both
bound by operations — about 11 Montgomery products per record against 49
words read:

  * `scan_records` (`scan_full`): the complete mixed add, every prefix
    written.
  * `scan_records_sel` (`scan_sel`): the mixed add WITHOUT the doubling
    branch plus a per-window flag, and only the prefixes the host selected
    per step are written. If a flag fires, the caller redoes the work on the
    complete scan: exactness is kept, adversarial inputs only cost time.

Both run each lane's T steps as `split` = K sub-chains of T/K steps (sums
from the identity, a Hillis-Steele scan over the K sums with the complete
add, then each sub-chain again from its offset), which gives the card K
times the threads on chains about 2T/K adds long. The prefixes and totals
are the same points at every K, and at K = 1 the same Jacobian triples as
the JAX package's scans; at K > 1 they are other representatives of those
points, which the MSM only ever adds and reduces.

The plain PyTorch versions (`scan_records_ref`, `scan_records_sel_ref`) run
the kernels' three phases with the formulas of ops.g1, in the kernels'
order, and are what CPU tensors get.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og

# lane width override for tests and tuning (0 = default), read from
# CURDLEPROOFS_SCAN_LANES as the JAX package reads it
_LANES = int(os.environ.get("CURDLEPROOFS_SCAN_LANES", "0"))

# Sub-chains a lane of both scans by default, on the CPU as on the card: the
# fastest of K in {1, 2, 4, 8, 16, 32} for `scan_records_sel` on an H100 at
# the n = 2^16 shapes (chip_smoke.py, `split_sweep`).
SCAN_SPLIT = 16


def pick_lanes(n: int) -> int:
    """Scan lane width: the number of sequential chains per window. Wider L
    means more threads and shorter chains at the cost of more lane-offset
    stitch work (2*log2(L)*L adds per window). Kept at the JAX package's 512
    so every intermediate compares at equal L; not yet tuned for this card."""
    if _LANES:
        return min(_LANES, n)
    return min(512, n)


def _check_records(records: torch.Tensor, W: int, T: int, L: int) -> None:
    if tuple(records.shape) != (49, W * T * L):
        raise ValueError(
            f"records: expected shape {(49, W * T * L)}, got {tuple(records.shape)}"
        )


def _split(records: torch.Tensor, W: int, T: int, L: int):
    rec = records.reshape(49, W, T, L)
    return rec[:24], rec[24:48], rec[48] != 0


def split_steps(T: int, split: Optional[int] = None) -> int:
    """The sub-chains a lane gets: `split` (default SCAN_SPLIT, a power of
    two up to 32, the kernel's limit), lowered to the largest power of two
    that divides T."""
    k = SCAN_SPLIT if split is None else split
    if k < 1 or k & (k - 1) or k > 32:
        raise ValueError(f"split must be a power of two from 1 to 32, got {k}")
    return min(k, T & -T)


def _split_scan(records: torch.Tensor, W: int, T: int, L: int, K: int, full: bool):
    """The kernels' three phases on tensors, K sub-chains a lane: the mixed
    add complete (`full`) or without the doubling branch and flagged.
    Returns (the prefix after every step (72, W, T*L), lane totals (72, W, L),
    flags (W, K, L), all False where `full`)."""
    steps = T // K
    x, y, infv = _split(records, W, T, L)
    # sub-chain k of a lane holds steps k*steps .. (k+1)*steps - 1
    x = x.reshape(24, W, K, steps, L)
    y = y.reshape(24, W, K, steps, L)
    infv = infv.reshape(W, K, steps, L)
    dev = records.device
    flag = torch.zeros((W, K, L), dtype=torch.bool, device=dev)

    def walk(acc, keep):
        nonlocal flag
        for u in range(steps):
            q = og.APoints(x[:, :, :, u], y[:, :, :, u], infv[:, :, u])
            if full:
                acc = og._jmadd_formulas(acc, q)
            else:
                acc, dbl = og._jmadd_formulas_flagged(acc, q)
                flag |= dbl
            if keep is not None:
                keep.append(torch.cat([acc.x, acc.y, acc.z], dim=0))
        return acc

    offset = og.jinf((W, K, L), device=dev)
    if K > 1:
        # A: each sub-chain's sum; B: inclusive scan over the K sums with the
        # complete add, p the earlier one, then shifted by one for each
        # sub-chain's offset
        acc = walk(og.jinf((W, K, L), device=dev), None)
        d = 1
        while d < K:
            earlier = og.JPoints(*(a[:, :, : K - d] for a in acc))
            later = og.JPoints(*(a[:, :, d:] for a in acc))
            summed = og._jadd_formulas(earlier, later)
            acc = og.JPoints(*(torch.cat([a[:, :, :d], b], dim=2) for a, b in zip(acc, summed)))
            d *= 2
        offset = og.JPoints(*(torch.cat([o[:, :, :1], a[:, :, : K - 1]], dim=2) for o, a in zip(offset, acc)))
    steps_out = []
    walk(offset, steps_out)  # C: every prefix, step t = k*steps + u
    pref = torch.stack(steps_out, dim=3).reshape(72, W, T * L)
    return pref, steps_out[-1][:, :, K - 1], flag


def scan_records_ref(records: torch.Tensor, W: int, T: int, L: int, split: Optional[int] = None):
    """Plain PyTorch version of `scan_records`: the complete scan in K
    sub-chains (`split_steps`), with the formulas and the order of the
    kernel."""
    _check_records(records, W, T, L)
    pref, totals, _ = _split_scan(records, W, T, L, split_steps(T, split), full=True)
    return pref, totals


def scan_records(records: torch.Tensor, W: int, T: int, L: int, split: Optional[int] = None):
    """Per-lane streaming scan with the complete mixed add.

    records (49, W*T*L) int32 [x limbs 0-23, y 24-47, inf 48]; split:
    sub-chains a lane (`split_steps`). Returns (prefix (72, W, T*L),
    lane_totals (72, W, L)); prefix[.., w, t*L + l] is the inclusive
    within-lane prefix of sorted ranks [l*T, l*T + t].

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    K = split_steps(T, split)
    if not records.is_cuda:
        return scan_records_ref(records, W, T, L, K)
    cuda_g1.check_tensor("scan_records records", records, (49, W * T * L))
    dev = records.device
    prefix = torch.empty((72, W, T * L), dtype=torch.int32, device=dev)
    totals = torch.empty((72, W, L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_g1.lib().curdle_scan_full(
            records.data_ptr(), prefix.data_ptr(), totals.data_ptr(), W, T, L, K,
            cuda_g1.stream_ptr(),
        )
    cuda_g1.check_launch("scan_full", rc)
    cuda_g1.launch_counts["scan_full"] += 1
    return prefix, totals


def scan_records_sel_ref(
    records: torch.Tensor, sel: torch.Tensor, W: int, T: int, L: int, S: int,
    split: Optional[int] = None,
):
    """Plain PyTorch version of `scan_records_sel`: the flagged no-doubling
    scan in K sub-chains, with the formulas and the order of the kernel, then
    the selection read off the full prefix."""
    _check_records(records, W, T, L)
    pref, totals, flag = _split_scan(records, W, T, L, split_steps(T, split), full=False)
    dev = records.device
    lane = sel.reshape(W, T, S).to(torch.int64)
    hit = (lane >= 0) & (lane < L)
    pos = torch.arange(T, device=dev).reshape(1, T, 1) * L + lane
    pos = torch.where(hit, pos, torch.zeros_like(pos)).reshape(W, T * S)
    bs = torch.take_along_dim(pref, pos.unsqueeze(0).expand(72, -1, -1), dim=-1)
    bs = torch.where(hit.reshape(1, W, T * S), bs, torch.zeros_like(bs))
    return bs, totals, flag.any(dim=-1).any(dim=-1).to(torch.int32)


def scan_records_sel(
    records: torch.Tensor, sel: torch.Tensor, W: int, T: int, L: int, S: int,
    split: Optional[int] = None,
):
    """Streaming scan emitting only host-selected boundary prefixes.

    records (49, W*T*L) int32 as in scan_records; sel (W*T, S) int32 lane ids
    (outside [0, L), e.g. -1 = empty slot, emits the zero triple = identity);
    split: sub-chains a lane (`split_steps`). Returns (bsel (72, W, T*S)
    selected prefixes, lane_totals (72, W, L), dbl_flags (W,) int32 — nonzero
    where the no-doubling mixed add hit the p == q case and the window result
    is INVALID; the caller must redo on the doubling-safe path).

    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if tuple(sel.shape) != (W * T, S):
        raise ValueError(f"sel: expected shape {(W * T, S)}, got {tuple(sel.shape)}")
    K = split_steps(T, split)
    if not records.is_cuda:
        return scan_records_sel_ref(records, sel, W, T, L, S, K)
    cuda_g1.check_tensor("scan_records_sel records", records, (49, W * T * L))
    cuda_g1.check_tensor("scan_records_sel sel", sel, (W * T, S))
    dev = records.device
    bsel = torch.empty((72, W, T * S), dtype=torch.int32, device=dev)
    totals = torch.empty((72, W, L), dtype=torch.int32, device=dev)
    flags = torch.zeros((W,), dtype=torch.int32, device=dev)  # the kernel ORs into it
    with torch.cuda.device(dev):
        rc = cuda_g1.lib().curdle_scan_sel(
            records.data_ptr(), sel.data_ptr(), bsel.data_ptr(), totals.data_ptr(),
            flags.data_ptr(), W, T, L, S, K, cuda_g1.stream_ptr(),
        )
    cuda_g1.check_launch("scan_sel", rc)
    cuda_g1.launch_counts["scan_sel"] += 1
    return bsel, totals, flags
