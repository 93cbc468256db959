"""Driver for `curdleproofs_tpu_torch.ops.msm.msm_pippenger`: one whole MSM
on the card from inputs that already live there (the sort on the device).

Set-up, all on the device and from the seed, by one CUDA generator:
- b_i, n discrete logs below r, drawn by the traffic's sampler;
- the bases P_i = b_i * G, by the program's scalar multiplication on a
  broadcast generator, then made affine by one batched inversion (a product
  tree over the program's plain Montgomery product, one inversion on the
  host at the root);
- one set of n scalars, drawn by the traffic's sampler
  (`portbench/scalars/<name>.py`).
Call i first gives `lanes_per_call` lanes new scalars (one lane drawn in
each of as many equal strides, the values by the sampler), then runs the
entry on the bases and the scalars as they now stand. No two calls share
their inputs, so no cache of answers can serve one.

After the window `collect` keeps the answers and each call's new lanes on
the host and frees the device state; `check` holds every answer against the
plain reference (`reference.py`), which carries sum_i s_i * b_i mod r from
call to call by (v - s_j) * b_j for each lane j given the value v.
"""
from __future__ import annotations

import importlib
import importlib.util
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import reference
from curdleproofs_tpu_torch.ops import fieldspec as fs
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import modarith as ma

ENTRY_MODULE = "curdleproofs_tpu_torch.ops.msm"
ENTRY = "msm_pippenger"
# Port functions the traced run wraps in a profiler span of their own, so an
# idle stretch of the card is named by the host work open at the time.
TRACE_SPANS = {
    "curdleproofs_tpu_torch.ops.msm": ["_window_partials", "_pack_records", "_combine_packed"],
    "curdleproofs_tpu_torch.ops.g1": ["jpoints_to_host"],
}
# the control: the reference in the program's place with the top window of
# every scalar dropped (bits 240 to 254), the shortcut a later change could
# be tempted by
CONTROLS = {"top_window_dropped": 240}

LIMBS_FQ = 24
GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
SCALARS = Path(__file__).resolve().parent.parent / "scalars"

Affine = Optional[Tuple[int, int]]


def load_sampler(name: str):
    """The scalar sampler `portbench/scalars/<name>.py`."""
    path = SCALARS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no scalar sampler {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_scalars_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mont_column(v: int, n: int, device) -> torch.Tensor:
    """The Montgomery form of v as (24, n) limbs, every lane alike."""
    m = v * fs.FQ_SPEC.r_mod % fs.FQ_SPEC.modulus
    col = torch.from_numpy(fs.int_to_limbs(m, LIMBS_FQ).astype(np.int32)).to(device)
    return col.reshape(LIMBS_FQ, 1).expand(LIMBS_FQ, n).contiguous()


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ma.mont_mul(fs.FQ_SPEC, a, b)


def batch_inverse(z: torch.Tensor) -> torch.Tensor:
    """(24, n) nonzero Montgomery values -> their inverses: padded with ones
    to a power of two, products of pairs up a tree, one inversion at the
    root on the host, and back down, about three products a lane in all."""
    n = z.shape[-1]
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        z = torch.cat([z, _mont_column(1, m - n, z.device)], dim=-1)
    levels = [z]
    while levels[-1].shape[-1] > 1:
        cur = levels[-1]
        levels.append(_mul(cur[:, 0::2], cur[:, 1::2]))
    p = fs.FQ_SPEC.modulus
    root = fs.limbs_to_ints(levels[-1][:, 0])
    inv_root = fs.FQ_SPEC.r2_mod * pow(root, -1, p) % p  # (R / root) in Montgomery form
    inv = torch.from_numpy(fs.int_to_limbs(inv_root, LIMBS_FQ).astype(np.int32)).to(z.device).reshape(LIMBS_FQ, 1)
    for lvl in reversed(levels[:-1]):
        a, b = lvl[:, 0::2], lvl[:, 1::2]
        inv = torch.stack([_mul(inv, b), _mul(inv, a)], dim=-1).reshape(LIMBS_FQ, -1)
    return inv[:, :n]


def make_bases(b: torch.Tensor) -> og.APoints:
    """P_i = b_i * G as affine device points (Montgomery limbs)."""
    n = b.shape[-1]
    dev = b.device
    gen = og.APoints(_mont_column(GEN_X, n, dev), _mont_column(GEN_Y, n, dev), torch.zeros(n, dtype=torch.bool, device=dev))
    jac = og.scalar_mul(gen, b)
    del gen
    zinv = batch_inverse(jac.z)
    zinv2 = _mul(zinv, zinv)
    x = _mul(jac.x, zinv2)
    y = _mul(jac.y, _mul(zinv, zinv2))
    return og.APoints(x.contiguous(), y.contiguous(), torch.zeros(n, dtype=torch.bool, device=dev))


def _from_mont(limbs: np.ndarray) -> List[int]:
    p = fs.FQ_SPEC.modulus
    rinv = pow(fs.FQ_SPEC.r_mod, -1, p)
    return [v * rinv % p for v in fs.limbs_to_ints(limbs)]


def _affine(result) -> Affine:
    """A returned host G1 point as an affine pair (None: infinity)."""
    return None if result.inf else (int(result.x), int(result.y))


class Cell:
    """One configuration under one traffic mix, set up on `device`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, control: Optional[str] = None) -> None:
        if control is not None and control not in CONTROLS:
            raise ValueError(f"no control {control!r} for this driver (it has {', '.join(CONTROLS)})")
        self.control = control
        self.n = int(config["bases"])
        self.c = int(traffic["window_bits"])
        self.items_per_call = self.n
        self.lanes = min(int(traffic["lanes_per_call"]), self.n)
        self.stride = self.n // self.lanes
        self.base_sample_size = int(traffic.get("base_sample", 16))
        self.seed = seed
        self.draw = load_sampler(traffic["scalars"]).draw
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        b = self.draw(self.gen, self.n, device)
        b[0] |= 1  # odd, so never 0: no base is the identity
        self.scalars = self.draw(self.gen, self.n, device)
        # the reference's inputs, as the harness made them, before any call
        self.b_host = b.cpu().numpy().astype(np.int64)
        self.s0_host = self.scalars.cpu().numpy().astype(np.int64)
        self.offsets = torch.arange(self.lanes, device=device, dtype=torch.int64) * self.stride
        self.rewrites: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        self.bases = make_bases(b)
        self.entry = getattr(importlib.import_module(ENTRY_MODULE), ENTRY)

    def call(self, i: int):
        """New scalars in this call's lanes, then the entry on all n."""
        dev = self.scalars.device
        lanes = self.offsets + torch.randint(0, self.stride, (self.lanes,), generator=self.gen, device=dev)
        vals = self.draw(self.gen, self.lanes, dev)
        self.scalars.index_copy_(1, lanes, vals)
        self.rewrites.append((i, lanes, vals))
        return i, self.entry(self.bases, self.scalars, c=self.c)

    def base_sample(self) -> List[Tuple[int, Affine]]:
        """Bases picked from the seed, read back: (i, (x, y))."""
        rng = random.Random(self.seed)
        idx = sorted(rng.sample(range(self.n), min(self.base_sample_size, self.n)))
        sel = torch.tensor(idx, device=self.bases.x.device)
        xs = _from_mont(self.bases.x[:, sel].cpu().numpy())
        ys = _from_mont(self.bases.y[:, sel].cpu().numpy())
        inf = self.bases.inf[sel].cpu().numpy()
        return [(i, None if f else (x, y)) for i, x, y, f in zip(idx, xs, ys, inf)]

    def collect(self, results) -> dict:
        """The window's answers and what the reference needs, on the host;
        the program's state on the card is freed."""
        got = {
            "answers": [(i, _affine(r)) for i, r in results],
            "rewrites": [(i, lanes.cpu().numpy(), vals.cpu().numpy().astype(np.int64)) for i, lanes, vals in self.rewrites],
            "bases": self.base_sample(),
        }
        del self.bases, self.scalars, self.offsets
        self.rewrites = []
        return got

    def _dots(self, rewrites, wanted, bits: Optional[int] = None) -> Dict[int, int]:
        """sum_i s_i * b_i mod r after each wanted call, the scalars as the
        calls left them (each with every bit from `bits` up cleared, where
        given)."""
        def view(s):
            return s if bits is None else reference.truncated(s, bits)

        s = self.s0_host.copy()
        b = self.b_host
        cur = reference.dot_mod_r(view(s), b)
        out = {}
        for i, lanes, vals in rewrites:
            old, new = view(s[:, lanes]), view(vals)
            for t, j in enumerate(lanes):
                cur += (reference.limbs_to_int(new[:, t]) - reference.limbs_to_int(old[:, t])) * reference.limbs_to_int(b[:, j])
            cur %= reference.R
            s[:, lanes] = vals
            if i in wanted:
                out[i] = cur
        return out

    def check(self, got: dict) -> Tuple[Dict[str, dict], int]:
        """Every answer against the reference for its call, and the bases
        read back against b_i * G. Each number with its limit, and the
        number of calls that failed."""
        answers = dict(got["answers"])
        expected = {i: reference.mul(d, reference.G) for i, d in self._dots(got["rewrites"], answers).items()}
        if self.control is not None:
            dots = self._dots(got["rewrites"], answers, CONTROLS[self.control])
            answers = {i: reference.mul(d, reference.G) for i, d in dots.items()}
        mismatched = sum(1 for i, a in answers.items() if i not in expected or a != expected[i])
        bad_bases = sum(
            1 for i, pt in got["bases"] if pt != reference.mul(reference.limbs_to_int(self.b_host[:, i]), reference.G)
        )
        checks = {
            "mismatched_calls": {"value": mismatched, "limit": 0},
            "mismatched_bases": {"value": bad_bases, "limit": 0},
        }
        return checks, mismatched


def setup(config: dict, traffic: dict, seed: int, device, control: Optional[str] = None) -> Cell:
    return Cell(config, traffic, seed, device, control)
