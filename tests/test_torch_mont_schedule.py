"""The carry schedule of the CUDA Montgomery product (``csrc/field.cuh``,
``fe_mont_mul``), replayed word for word on 32-bit words.

Tier-1 never runs a CUDA kernel, so this holds the header's own text: every
``asm`` statement of the product is parsed out of ``field.cuh`` and
interpreted (``add.cc``, ``addc``, ``mad.lo.cc`` / ``madc.hi`` ...: the
carry flag lives inside one statement, as in PTX), and the C code around
them (the first row, the rows with the even and odd accumulators swapping
roles, ``m_i = e[0] * n0``, the final sum and the conditional subtraction)
is transcribed below, and ``GLUE`` holds that C code's text as it was
transcribed, so an edit to it fails here until the transcription follows.  Each product must equal ``a * b * 2^-256 mod p``
over Fr and Fq on the edge operands and on seeded random pairs, every
carry the asm drops (an instruction without ``.cc`` whose sum passes 32
bits, or a flag left set at the end of a statement) must be 0, and so
must each reduced word.  The replay equals K1's plain version too, which
the card's smoke holds the kernel against."""

import os
import re

import numpy as np
import pytest
import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_field as CF
from halo2_aes_tpu_torch.ops import field as F

HEADER = os.path.join(_build.CSRC, "field.cuh")
MASK = (1 << 32) - 1
SPECS = {"fr": F.FR, "fq": F.FQ}
RANDOM_BATCHES = 4       # a batch a case
RANDOM_PAIRS = 50        # pairs a batch: 200 a field


def _functions(text: str) -> dict:
    """name -> body of each device function."""
    out = {}
    for m in re.finditer(r"__device__ __forceinline__ void (\w+)\([^)]*\)\s*\{",
                         text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = text[m.end():i - 1]
    return out


def _asm(body: str) -> tuple:
    """The one asm statement of a body: (instructions, output operands,
    input operands), each operand (constraint, C expression)."""
    m = re.search(r"asm\((.*?)\);", body, re.S)
    parts = m.group(1).split(":")
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0]))
    insns = [i.strip() for i in template.replace("\\n", "").replace("\\t", "")
             .split(";") if i.strip()]

    def operands(s):
        return re.findall(r'"([=+&r]+)"\(([^)]*)\)', s)

    return insns, operands(parts[1]), operands(parts[2])


_FUNCS = _functions(open(HEADER).read())
ASM = {name: _asm(body) for name, body in _FUNCS.items() if "asm(" in body}

# the C code of the product around its asm statements, as mont_mul_words
# transcribes it (blanks squeezed, each asm statement as "asm;")
GLUE = {
    "fe_row_first": "#pragma unroll for (int j = 0; j < 8; j += 2) { const uint64_t "
                    "ev = (uint64_t)a[j] * b0, od = (uint64_t)a[j + 1] * b0; e[j] = "
                    "(uint32_t)ev; e[j + 1] = (uint32_t)(ev >> 32); o[j] = "
                    "(uint32_t)od; o[j + 1] = (uint32_t)(od >> 32); }",
    "fe_row_reduce": "const uint32_t mi = e[0] * m.n0; fe_mad_pairs_drop(o, m.p + 1, "
                     "mi); fe_mad_pairs(e, o[7], m.p, mi);",
    "fe_row": "fe_row_odd(e, o, a, b); fe_mad_pairs(e, o[7], a, b); "
              "fe_row_reduce(e, o, m);",
    "fe_mont_mul": "uint32_t x[8], y[8]; fe_row_first(x, y, a, b[0]); "
                   "fe_row_reduce(x, y, m); #pragma unroll for (int i = 1; i < 8; "
                   "i += 2) { fe_row(y, x, a, b[i], m); if (i + 1 < 8) fe_row(x, y, "
                   "a, b[i + 1], m); } asm; fe_reduce_once(r, x, 0, m);",
    "fe_reduce_once": "uint32_t d0, d1, d2, d3, d4, d5, d6, d7, borrow; asm; const "
                      "bool take = hi || !borrow; r[0] = take ? d0 : t[0]; r[1] = take "
                      "? d1 : t[1]; r[2] = take ? d2 : t[2]; r[3] = take ? d3 : t[3]; "
                      "r[4] = take ? d4 : t[4]; r[5] = take ? d5 : t[5]; r[6] = take ? "
                      "d6 : t[6]; r[7] = take ? d7 : t[7];",
}


def _glue(body: str) -> str:
    """A body's C code: comments dropped, each asm statement as
    ``asm;``, blanks squeezed."""
    body = re.sub(r"//[^\n]*", "", body)
    body = re.sub(r"asm\(.*?\);", "asm;", body, flags=re.S)
    return " ".join(body.split())


class Replay:
    """Runs the header's asm statements on Python ints; ``dropped`` lists
    every nonzero carry the asm discards, by function."""

    def __init__(self):
        self.dropped = []

    def run(self, name: str, **args) -> None:
        """Run function ``name``'s asm with its C parameters bound to
        ``args``: lists for arrays (a list may be a view: ``(list,
        offset)``), one-element lists for scalars passed by reference,
        ints for values."""
        insns, outs, ins = ASM[name]
        ops = outs + ins

        def ref(expr):
            m = re.fullmatch(r"([\w.]+)(?:\[(\d+)\])?", expr.strip())
            base, idx = args[m.group(1)], int(m.group(2) or 0)
            if isinstance(base, tuple):          # a pointer past the array's start
                base, idx = base[0], idx + base[1]
            return base, idx

        def read(expr):
            base, idx = ref(expr)
            return base if isinstance(base, int) else base[idx]

        # "+r" operands are read in and written back; "=r" are written only
        regs = [read(e) if "=" not in c or "+" in c else 0 for c, e in ops]
        cc = 0
        for insn in insns:
            op, rest = insn.split(None, 1)
            vals = [a.strip() for a in rest.split(",")]
            dst = int(vals[0][1:])
            src = [regs[int(v[1:])] if v.startswith("%") else int(v, 0)
                   for v in vals[1:]]
            fields = op.split(".")
            carry_in = fields[0] in ("addc", "subc", "madc")
            if fields[0] in ("add", "addc"):
                s = src[0] + src[1] + (cc if carry_in else 0)
                out, carry = s & MASK, s >> 32
            elif fields[0] in ("sub", "subc"):
                s = src[0] - src[1] - (cc if carry_in else 0)
                out, carry = s & MASK, int(s < 0)
            elif fields[0] in ("mad", "madc"):
                prod = src[0] * src[1]
                part = prod >> 32 if fields[1] == "hi" else prod & MASK
                s = part + src[2] + (cc if carry_in else 0)
                out, carry = s & MASK, s >> 32
            else:
                raise AssertionError(f"{name}: no model for {op}")
            if ".cc" in op:
                cc = carry
            elif carry and fields[0] not in ("sub", "subc"):
                self.dropped.append((name, insn, carry))
            regs[dst] = out
        if cc and ".cc" in insns[-1]:
            self.dropped.append((name, "flag left set", cc))
        for i, (c, e) in enumerate(outs):
            base, idx = ref(e)
            base[idx] = regs[i]


def words(v: int) -> list:
    return [(v >> (32 * i)) & MASK for i in range(8)]


def value(w) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


def mont_mul_words(a: int, b: int, p: int, rp: Replay) -> int:
    """``fe_mont_mul(r, a, b, m)`` of field.cuh: its C code transcribed,
    its asm statements replayed from the header."""
    aw, bw, pw = words(a), words(b), words(p)
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)

    def row_reduce(e, o):
        mi = (e[0] * n0) & MASK
        rp.run("fe_mad_pairs_drop", acc=o, x=(pw, 1), y=mi)
        top = [o[7]]
        rp.run("fe_mad_pairs", acc=e, top=top, x=pw, y=mi)
        o[7] = top[0]
        if e[0]:
            rp.dropped.append(("fe_row_reduce", "e[0] not reduced", e[0]))

    def row(e, o, bi):
        rp.run("fe_row_odd", e=e, o=o, a=aw, b=bi)
        top = [o[7]]
        rp.run("fe_mad_pairs", acc=e, top=top, x=aw, y=bi)
        o[7] = top[0]
        row_reduce(e, o)

    # fe_row_first: plain products, no carries
    x = [0] * 8
    y = [0] * 8
    for j in range(0, 8, 2):
        ev, od = aw[j] * bw[0], aw[j + 1] * bw[0]
        x[j], x[j + 1] = ev & MASK, ev >> 32
        y[j], y[j + 1] = od & MASK, od >> 32
    row_reduce(x, y)
    for i in range(1, 8, 2):
        row(y, x, bw[i])
        if i + 1 < 8:
            row(x, y, bw[i + 1])
    rp.run("fe_mont_mul", x=x, y=y)
    # fe_reduce_once(r, x, 0, m): t - p where the chain does not borrow
    d = {f"d{i}": [0] for i in range(8)}
    borrow = [0]
    rp.run("fe_reduce_once", t=x, borrow=borrow, **d, **{"m.p": pw})
    return value([d[f"d{i}"][0] for i in range(8)]) if not borrow[0] else value(x)


def _check(spec, pairs, plain: bool = False) -> None:
    """Each replayed product is ``a * b * 2^-256 mod p`` and drops no
    carry; with ``plain``, the products also equal K1's plain version
    (``mont_mul_plain``), the card's reference for the kernel."""
    p, rinv = spec.modulus, pow(1 << 256, -1, spec.modulus)
    got = []
    for a, b in pairs:
        rp = Replay()
        got.append(mont_mul_words(a, b, p, rp))
        assert got[-1] == a * b * rinv % p, (spec.name, a, b)
        assert rp.dropped == [], (spec.name, a, b, rp.dropped)
    if plain:
        a = torch.from_numpy(F.ints_to_limbs_fast([x for x, _ in pairs]).astype(np.int32))
        b = torch.from_numpy(F.ints_to_limbs_fast([y for _, y in pairs]).astype(np.int32))
        assert got == F.limbs_to_ints(CF.mont_mul_plain(spec, a, b).numpy())


def _random_pairs(spec, seed: int) -> list:
    rng = np.random.default_rng(seed)
    p = spec.modulus
    return [tuple(int.from_bytes(rng.bytes(32), "little") % p for _ in range(2))
            for _ in range(RANDOM_PAIRS)]


def test_header_has_the_product_chains():
    """The replay reads the statements it models: the odd chain with the
    shift, the paired chains with and without the carry into the top
    word, the final sum, and the subtraction of p."""
    assert {"fe_row_odd", "fe_mad_pairs", "fe_mad_pairs_drop",
            "fe_mont_mul", "fe_reduce_once"} <= set(ASM)
    # the chains the product runs: the carry enters each pair's hi word
    for name in ("fe_row_odd", "fe_mad_pairs", "fe_mad_pairs_drop"):
        insns = ASM[name][0]
        his = [i for i in insns if i.startswith("madc.hi")]
        assert len(his) == 4, (name, insns)


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("edge", range(9))
def test_edge_operands(field, edge):
    """One edge operand against every edge operand, both ways round."""
    spec = SPECS[field]
    es = CF.edge_operands(spec)
    assert all(0 <= v < spec.modulus for v in es)
    _check(spec, [(es[edge], b) for b in es] + [(b, es[edge]) for b in es])


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("batch", range(RANDOM_BATCHES))
def test_random_pairs(field, batch):
    spec = SPECS[field]
    _check(spec, _random_pairs(spec, 1000 * batch + len(field)))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_replay_equals_k1_plain(field):
    """A further batch of seeded pairs, whose replayed words also equal
    K1's plain version (``mont_mul_plain``), the card's reference for the
    kernel."""
    spec = SPECS[field]
    _check(spec, _random_pairs(spec, 7), plain=True)


@pytest.mark.parametrize("name", sorted(GLUE))
def test_c_glue_is_the_transcribed_one(name):
    """The product's C code around its asm statements is still what
    ``mont_mul_words`` transcribes: the first row, the order of the two
    reduce chains, the rows' role swap, the final sum's operands and the
    conditional subtraction."""
    assert _glue(_FUNCS[name]) == GLUE[name]


def test_dropped_carries_are_seen_without_headroom():
    """The check is live: for the largest 256-bit prime, 2^256 - 189, the
    sum outgrows the odd accumulator and the replay reports the carry the
    asm drops (so the headroom below 2^254 is what keeps BN254 exact)."""
    p = (1 << 256) - 189
    rp = Replay()
    mont_mul_words(p - 1, p - 1, p, rp)
    assert rp.dropped


@pytest.mark.parametrize("modulus", [F.FR.modulus, F.FQ.modulus,
                                     (1 << 254) - 127, 1 << 254,
                                     (1 << 256) - 189])
def test_modulus_args_keeps_the_headroom(modulus):
    """``_build.modulus_args`` (every kernel's p and n0) takes a modulus
    below 2^254 and refuses one from 2^254 on."""
    if modulus < 1 << 254:
        words_, n0 = _build.modulus_args(modulus)
        assert value(list(words_)) == modulus
        assert (n0 * modulus) % (1 << 32) == (1 << 32) - 1
    else:
        with pytest.raises(ValueError):
            _build.modulus_args(modulus)
