"""A word-level model of the field arithmetic of csrc/fq.cuh.

The CUDA arithmetic runs on inline PTX carry chains (mad.lo.cc, madc.hi.cc,
add.cc, sub.cc) that no CPU can execute, so this file runs the same
schedule on Python integers, instruction for instruction: each asm
statement of fq.cuh is read from the source and interpreted (`run_asm`: the
carry flag of every `.cc` step as its own bit, clear at the start of each
statement, as the compiler keeps no flag between statements), and
`mont_mul` / `mont_sqr` call them in the order fq_mont / fq_mont_sqr do:
the even and odd accumulators, the one-word reduction per step, the merge,
and the final subtraction; `fq_add` / `fq_sub` the same way. Where the
schedule lets a carry fall from an addition (an instruction without `.cc`)
the model asserts that it is zero. The results are held against
a * b * 2^-384 mod p, a + b and a - b mod p on edge words and on hypothesis
cases; the compiled code is held on the card (chip_smoke.py,
tests/test_torch_cuda_kernels.py). CPU only, no JAX."""
import random
import re
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import curdleproofs_tpu_torch
from curdleproofs_tpu_torch.fields import FQ_MOD as P

M32 = (1 << 32) - 1
R = 1 << 384
RINV = pow(R, -1, P)
N0 = -pow(P, -1, 1 << 32) % (1 << 32)


def words(x: int, n: int = 12) -> list:
    return [(x >> (32 * i)) & M32 for i in range(n)]


def value(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


PW = words(P)


# Every asm statement of fq.cuh: (function, L for the row_pairs variants) ->
# (instructions, output operand expressions, input operand expressions).
SRC = (Path(curdleproofs_tpu_torch.__file__).parent / "csrc" / "fq.cuh").read_text()
_STR = r'"((?:[^"\\]|\\.)*)"'


def _asm_blocks() -> dict:
    blocks = {}
    for m in re.finditer(r"asm\(\s*((?:" + _STR + r"\s*)+):(.*?):(.*?)\);", SRC, re.S):
        text = "".join(re.findall(_STR, m.group(1))).replace("\\n", "").replace("\\t", "")
        ins = [tuple(re.split(r"[\s,]+", i.strip())) for i in text.split(";") if i.strip()]
        outs = [compile(e, e, "eval") for e in re.findall(r'"\+r"\(([^)]*)\)', m.group(3))]
        stores = [compile(f"{e} = _v", e, "exec") for e in re.findall(r'"[+=]r"\(([^)]*)\)', m.group(3))]
        ins_ops = [compile(e, e, "eval") for e in re.findall(r'"r"\(([^)]*)\)', m.group(4))]
        head = SRC[: m.start()]
        fn = re.findall(r"(?:void|uint32_t) (\w+)\(", head)[-1]
        case = re.findall(r"L == (\d+)", head[re.search(rf"(?:void|uint32_t) {fn}\(", head).start() :])
        blocks[(fn, int(case[-1])) if case else fn] = (ins, outs, stores, ins_ops)
    return blocks


BLOCKS = _asm_blocks()


def run_asm(key, env: dict) -> None:
    """Run one asm statement of fq.cuh on Python integers: its operands are
    the C++ expressions bound in env (arrays as lists), "+r" and "=r"
    operands are written back. The carry flag starts clear, each .cc
    instruction sets it from its own carry (or borrow) out, and an addition
    without .cc must not carry (a subtraction without .cc wraps: `subc 0, 0`
    turns the borrow into a mask)."""
    ins, outs, stores, ins_ops = BLOCKS[key]
    # "+r" operands, then the "=r" ones (written only), then the inputs
    regs = [eval(c, {}, env) for c in outs] + [0] * (len(stores) - len(outs)) + [eval(c, {}, env) for c in ins_ops]
    cc = 0
    for op, *args in ins:
        parts = op.split(".")
        val = [regs[int(x[1:])] if x.startswith("%") else int(x, 0) for x in args[1:]]
        carry_in = cc if parts[0] in ("madc", "addc", "subc") else 0
        if parts[0] in ("mad", "madc"):
            prod = val[0] * val[1]
            v = ((prod >> 32) if parts[1] == "hi" else (prod & M32)) + val[2] + carry_in
        elif parts[0] in ("add", "addc"):
            v = val[0] + val[1] + carry_in
        else:
            assert parts[0] in ("sub", "subc"), op
            v = val[0] - val[1] - carry_in
        if "cc" in parts:
            cc = 1 if (v >> 32) or v < 0 else 0
        else:
            assert parts[0].startswith("sub") or v >> 32 == 0, f"{key}: {op} would lose a carry"
        regs[int(args[0][1:])] = v & M32
    for i, c in enumerate(stores):
        env["_v"] = regs[i]
        exec(c, {}, env)


def mul_pairs(acc, a, s, bi):
    """acc[2j], acc[2j+1] = a[s + 2j] * bi: disjoint word pairs, no carries
    (plain C++ in fq.cuh)."""
    for j in range(6):
        prod = a[s + 2 * j] * bi
        acc[2 * j], acc[2 * j + 1] = prod & M32, prod >> 32


def cmad_pairs(acc, a, s, bi, top=None):
    """acc += sum a[s + 2j] * bi * 2^(64j); the chain's carry goes to
    top = (array, index), or must be zero."""
    if top is None:
        run_asm("cmad_pairs", {"acc": acc, "a": a, "S": s, "bi": bi})
    else:
        arr, i = top
        env = {"acc": acc, "a": a, "S": s, "bi": bi, "top": arr[i]}
        run_asm("cmad_pairs_top", env)
        arr[i] = env["top"]


def rshift_pairs(e, o, a, bi):
    """e[0] += o[1], then o = (o >> 64) + sum a[2j + 1] * bi * 2^(64j) with
    that carry in: the division by 2^32 of the step before, fused with this
    step's odd products."""
    env = {"e0": e[0], "o": o, "a": a, "bi": bi}
    run_asm("rshift_pairs", env)
    e[0] = env["e0"]


def merge_shift(e, o):
    run_asm("merge_shift", {"e": e, "o": o})


def add_words(e, h):
    run_asm("add_words", {"e": e, "h": h})


def row_pairs(acc, s, j, n, a, bi):
    """One row of the squaring's off-diagonal products: n products
    a[j], a[j + 2], ... times bi at acc[s ..], the carry into acc[s + 2n]."""
    run_asm(("row_pairs", n), {"acc": acc, "S": s, "J": j, "a": a, "bi": bi})


def reduce_once(t):
    """fq_reduce_once: t - p by sub_mask, kept where it did not borrow;
    (result, whether the subtraction was taken)."""
    d = list(t)
    env = {"d": d, "s": PW, "mask": 0}
    run_asm("sub_mask", env)
    keep = env["mask"]  # all ones where t < p
    assert value(t) < 2 * P
    return value([(a & keep) | (b & ~keep & M32) for a, b in zip(t, d)]), keep == 0


def fq_add(x: int, y: int) -> int:
    d = words(x)
    run_asm("add_wrap", {"d": d, "s": words(y)})
    return reduce_once(d)[0]


def fq_sub(x: int, y: int) -> int:
    """d = x - y, and p added back (as a masked word array) where it wrapped."""
    d = words(x)
    env = {"d": d, "s": words(y), "mask": 0}
    run_asm("sub_mask", env)
    run_asm("add_wrap", {"d": d, "s": [w & env["mask"] for w in PW]})
    return value(d)


def mont_mul(x: int, y: int):
    """fq_mont: 12 steps of one word of b, each with its one-word reduction;
    the even and odd accumulators swap roles every step."""
    a, b = words(x), words(y)
    A, B = [0] * 12, [0] * 12
    for i in range(12):
        E, O = (A, B) if i % 2 == 0 else (B, A)
        if i == 0:
            mul_pairs(E, a, 0, b[0])
            mul_pairs(O, a, 1, b[0])
        else:
            rshift_pairs(E, O, a, b[i])
            cmad_pairs(E, a, 0, b[i], top=(O, 11))
        mi = E[0] * N0 & M32
        cmad_pairs(O, PW, 1, mi)
        cmad_pairs(E, PW, 0, mi, top=(O, 11))
        assert E[0] == 0
    merge_shift(A, B)
    return reduce_once(A)


def mont_sqr(x: int):
    """fq_sqr_mont: the 66 off-diagonal products once (rows into an even and
    an odd wide accumulator), doubled, plus the 12 squares; then the same
    one-word reductions on the low half, and the high half added."""
    a = words(x)
    E, O = [0] * 24, [0] * 24  # E[k] at word k, O[k] at word k + 1
    for i in range(11):  # sqr_rows<i>
        row_pairs(O, 2 * i, i + 1, (10 - i) // 2 + 1, a, a[i])  # j = i+1, i+3, ...: words 2i+1, ...
        if i < 10:
            row_pairs(E, 2 * i + 2, i + 2, (9 - i) // 2 + 1, a, a[i])  # j = i+2, i+4, ...
    assert O[23] == 0
    run_asm("merge_wide", {"e": E, "o": O})  # E + O * 2^32
    assert E[23] >> 31 == 0
    w = [((E[j] << 1) | (E[j - 1] >> 31 if j else 0)) & M32 for j in range(24)]
    run_asm("add_squares", {"w": w, "a": a})  # + a_j^2 at word 2j
    assert value(w) == x * x
    A, B = w[:12], [0] * 12
    for i in range(12):
        E, O = (A, B) if i % 2 == 0 else (B, A)
        if i == 0:
            mi = E[0] * N0 & M32
            mul_pairs(O, PW, 1, mi)
        else:
            mi = (E[0] + O[1]) * N0 & M32
            rshift_pairs(E, O, PW, mi)
        cmad_pairs(E, PW, 0, mi, top=(O, 11))
        assert E[0] == 0
    merge_shift(A, B)
    add_words(A, w[12:])
    return reduce_once(A)


def _firing_cases():
    """Operands on which the final subtraction fires, and on which it does
    not, found from a fixed seed."""
    rng = random.Random(11)
    found = {}
    while len(found) < 4:
        x, y = rng.randrange(P), rng.randrange(P)
        found.setdefault(("mul", mont_mul(x, y)[1]), (x, y))
        found.setdefault(("sqr", mont_sqr(x)[1]), (x, x))
    return found


# 0, 1, p - 1, R mod p (Montgomery one), R^2 mod p, single full words at
# the bottom and p's top word, half of p, alternating full and empty words
EDGE = [0, 1, 2, P - 1, P - 2, R % P, R * R % P, M32, P >> 352 << 352, P >> 1, sum(M32 << (64 * j) for j in range(6)) % P]


@pytest.mark.parametrize("x", EDGE, ids=range(len(EDGE)))
def test_product_and_square_on_edge_words(x):
    for y in EDGE:
        assert mont_mul(x, y)[0] == x * y * RINV % P
    assert mont_sqr(x)[0] == x * x * RINV % P


def test_the_final_subtraction_fires_and_does_not():
    cases = _firing_cases()
    for (kind, fired), (x, y) in cases.items():
        res, f = mont_mul(x, y) if kind == "mul" else mont_sqr(x)
        assert f == fired
        assert res == x * y * RINV % P


@settings(max_examples=300, deadline=None)
@given(st.integers(0, P - 1), st.integers(0, P - 1))
def test_product_schedule(x, y):
    assert mont_mul(x, y)[0] == x * y * RINV % P


@settings(max_examples=300, deadline=None)
@given(st.integers(0, P - 1))
def test_square_schedule(x):
    assert mont_sqr(x)[0] == x * x * RINV % P


def test_every_asm_statement_is_modelled():
    assert set(BLOCKS) == {"cmad_pairs", "cmad_pairs_top", "rshift_pairs", "merge_shift", "add_words", "merge_wide",
                           "add_squares", "sub_mask", "add_wrap"} | {("row_pairs", n) for n in range(1, 7)}
    assert SRC.count("asm(") == len(BLOCKS)


@settings(max_examples=200, deadline=None)
@given(st.integers(0, P - 1), st.integers(0, P - 1))
def test_addition_chains(x, y):
    assert fq_add(x, y) == (x + y) % P
    assert fq_sub(x, y) == (x - y) % P


@pytest.mark.parametrize("x", EDGE, ids=range(len(EDGE)))
def test_addition_chains_on_edge_words(x):
    for y in EDGE:
        assert fq_add(x, y) == (x + y) % P
        assert fq_sub(x, y) == (x - y) % P
