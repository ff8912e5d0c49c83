"""Circuit cost estimator.

Role of the reference's cost-estimator feature
(reference src/aes128.rs:458-477: from_circuit_to_model_circuit -> JSON
dump).  Estimates proof size exactly from the protocol layout and prove
work in NTT/MSM op counts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from halo2_aes_tpu_torch.backend import protocol as PROTO
from halo2_aes_tpu_torch.circuit.ir import ADVICE, FIXED, INSTANCE, CompiledCircuit


@dataclass
class CostModel:
    k: int
    ext_k: int
    advice_columns: int
    fixed_columns: int
    instance_columns: int
    gates: int
    lookups: int
    perm_columns: int
    perm_chunks: int
    max_degree: int
    proof_points: int
    proof_scalars: int
    proof_bytes: int
    commit_msms: int          # size-n MSMs per proof
    ntts_base: int            # size-n NTTs per proof
    ntts_extended: int        # size-ext_n NTTs per proof

    def json(self) -> str:
        return json.dumps(self.__dict__, indent=2)


def field_muls(layout: CompiledCircuit, multiopen: str = "shplonk") -> dict:
    """Montgomery-multiply census of one prove, per phase (BASELINE.md's
    required field-muls/sec/chip metric divides these by measured phase
    times).  Counting conventions, stated so the number is auditable:

      * size-m NTT: (m/2)·log2(m) butterfly muls (twiddle scalings of
        the four-step/coset variants are counted as the extra m where
        they occur),
      * curve add (RCB complete formula, ops/curve.py): 12 muls; the
        windowed-table MSM does ~n·ceil(254/c) adds for the digit tree
        plus 2^c·nwin bucket-fold adds,
      * batch inversion of m elements: 3m muls + one ~380-mul Fermat
        exponentiation,
      * per-row constraint-term muls are counted exactly from the
        expression trees (Prod nodes) plus the y-fold and Z_H^-1 muls.

    Host-side scalar math (transcript, SHPLONK r_i interpolation) is
    excluded — it is O(proof size) and runs on CPU."""
    import math

    cs = layout.cs
    k = layout.k
    n = 1 << k
    degree = cs.degree()
    ext_k = k + max(1, (degree - 2).bit_length())
    ratio = (1 << ext_k) // n
    n_lk = len(cs.lookups)
    n_adv = sum(1 for c in cs.columns if c.kind == ADVICE)
    n_inst = sum(1 for c in cs.columns if c.kind == INSTANCE)
    m_perm = len(cs.perm_columns)
    chunk_len = cs.permutation_chunk_len()
    chunks = -(-m_perm // chunk_len) if m_perm else 0

    def ntt(m, count=1):
        return count * (m // 2) * int(math.log2(m))

    def msm(count=1, c=None):
        cw = c or max(8, min(16, k - 3))
        nwin = -(-254 // cw)
        adds = n * nwin + (1 << cw) * nwin * 2
        return count * adds * 12

    def prod_nodes(e):
        from halo2_aes_tpu_torch.circuit.ir import Neg, Prod, Sum

        if isinstance(e, Prod):
            return 1 + prod_nodes(e.a) + prod_nodes(e.b)
        if isinstance(e, Sum):
            return prod_nodes(e.a) + prod_nodes(e.b)
        if isinstance(e, Neg):
            return prod_nodes(e.inner)
        return 0

    phases = {}
    # phase 1: advice INTTs + commits
    phases["advice"] = ntt(n, n_adv + n_inst) + msm(n_adv)
    # phase 2: per lookup, theta-compression of input+table (Prod counts
    # from the pair expressions + theta-fold), 2 INTTs, 2 commits
    comp = 0
    for lk in cs.lookups:
        comp += sum(prod_nodes(e) for e, _ in lk.pairs) * n
        comp += (len(lk.pairs) - 1) * 2 * n      # theta Horner, A and S
    phases["lookup_permuted"] = comp + ntt(n, 2 * n_lk) + msm(2 * n_lk)
    # phase 3: permutation grand products (per column: 2 muls per row
    # for numerator/denominator factors + beta·sigma / beta·delta^i X)
    # + batch_inv + running product scans; lookup products similar
    perm = m_perm * 4 * n + chunks * (3 * n + 2 * n)   # factors + inv + scan
    lkp = n_lk * 6 * n       # (A+β)(S+γ) ratios + batch_inv + scan
    phases["grand_products"] = (perm + lkp + ntt(n, chunks + n_lk)
                                + msm(chunks + n_lk + 1))
    # phase 4: quotient — per sub-coset: shift muls + NTTs for every
    # stacked poly, constraint-term Prods per row, y-fold, Z_H^-1 mul;
    # then ext-size INTT + piece commits
    n_static = (len(cs.referenced_columns())
                - n_adv - n_inst + m_perm + 3)
    n_dyn = n_adv + n_inst + chunks + 3 * n_lk
    stack = n_static + n_dyn
    term_muls = sum(prod_nodes(g) for _, g in cs.gates)
    term_muls += chunks * (2 * m_perm + 4) + 2          # permutation terms
    term_muls += n_lk * 8                               # lookup terms
    n_terms = (len(cs.gates) + (2 + 2 * chunks if chunks else 0)
               + 4 * n_lk)
    quot = ratio * (stack * (n + ntt(n)) + (term_muls + n_terms + 1) * n)
    quot += ntt(1 << ext_k) + (1 << ext_k)              # interleave INTT
    phases["quotient"] = quot + msm(degree - 1)
    # evals: one Horner-style power table + mul-add per opened poly
    plan = PROTO.open_queries(cs)
    phases["evals"] = (degree - 1) * n + len(plan) * 2 * n
    # multiopen
    G = len({key for key, _ in plan})
    if multiopen in ("shplonk", "ipa"):
        K = len(PROTO.rotation_sets(plan))
        mo = G * n                                       # y2 member fold
        mo += K * 4 * n                                  # v-scaled Z_{T\S_k} f accumulate
        mo += ntt(2 * n, 2) + 2 * 2 * n + 3 * (2 * n)    # f/Z_T on 2n coset
        if multiopen == "shplonk":
            mo += ntt(n, 2) + K * n + 3 * n              # L/(X-u) on n coset
            mo += msm(2)
        else:
            mo += K * n + n                              # ipa_l linear combo
            # k rounds: 2 full-basis MSMs each (the original-basis
            # re-expression keeps every round at size n), scalar
            # expansion ~2n muls/round, folds + inner products ~6n total
            mo += msm(2 * k) + 2 * k * n + 6 * n
    else:
        rots = len({rot for _, rot in plan})
        mo = G * 2 * n + rots * (ntt(n, 2) + 5 * n) + msm(rots)
    phases["multiopen"] = mo
    phases["total"] = sum(phases.values())
    return phases


def estimate(layout: CompiledCircuit, multiopen: str = "shplonk") -> CostModel:
    cs = layout.cs
    kinds = [c.kind for c in cs.columns]
    n_adv = kinds.count(ADVICE)
    n_fix = kinds.count(FIXED)
    n_inst = kinds.count(INSTANCE)
    n_lk = len(cs.lookups)
    chunk_len = cs.permutation_chunk_len()
    chunks = -(-len(cs.perm_columns) // chunk_len) if cs.perm_columns else 0
    degree = cs.degree()

    plan = PROTO.open_queries(cs)
    evals = sum(1 for key, _ in plan if key[0] != "h")
    # advice + 2 per lookup (A', S') + perm z + lookup z + random +
    # d-1 h pieces + opening witnesses (SHPLONK: 2; GWC: one per
    # distinct rotation point; IPA: H + 2k round points + final scalar)
    if multiopen == "shplonk":
        n_open, extra_scalars = 2, 0
    elif multiopen == "ipa":
        # H commit + 2k blinded round points + a_fin + the accumulated
        # per-round Pedersen blind f_fin
        n_open, extra_scalars = 1 + 2 * layout.k, 2
    else:
        n_open, extra_scalars = len({rot for _, rot in plan}), 0
    points = n_adv + 2 * n_lk + chunks + n_lk + 1 + (degree - 1) + n_open
    proof_bytes = 32 * (points + evals + extra_scalars)

    # prover work model
    commit_msms = points
    ntts_base = n_adv + 3 * n_lk + chunks + 4  # coeff conversions + multiopen
    ext_polys = (
        len({c for _, g in cs.gates for c, _ in g.columns()}
            | {c for lk in cs.lookups for e, tc in lk.pairs
               for c in [tc] + [cc for cc, _ in e.columns()]}
            | set(cs.perm_columns))
        + len(cs.perm_columns) + chunks + 3 * n_lk + 3 + 1
    )
    return CostModel(
        k=layout.k,
        ext_k=layout.k + max(1, (degree - 2).bit_length()),
        advice_columns=n_adv,
        fixed_columns=n_fix,
        instance_columns=n_inst,
        gates=len(cs.gates),
        lookups=n_lk,
        perm_columns=len(cs.perm_columns),
        perm_chunks=chunks,
        max_degree=degree,
        proof_points=points,
        proof_scalars=evals + extra_scalars,
        proof_bytes=proof_bytes,
        commit_msms=commit_msms,
        ntts_base=ntts_base,
        ntts_extended=ext_polys,
    )
