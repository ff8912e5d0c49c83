"""Protocol definition shared by prover and verifier.

The quotient polynomial's constraint terms and the multiopen query plan
are defined ONCE here, parameterized over an abstract context, and
consumed twice: the prover instantiates the context with extended-domain
limb tensors (device), the verifier with plain python ints at the
challenge point (host).  Structural consistency between the two sides
is therefore by construction.

Canonical constraint-term order (the y-fold order):
  1. every gate, in ConstraintSystem order,
  2. permutation argument: l_0(1 - z_0); l_last(z_last^2 - z_last);
     chunk links l_0(z_t - z_{t-1}(w^u X)); per-chunk product rule,
  3. per lookup: l_0(1 - z); l_last(z^2 - z); product rule;
     l_0(A' - S'); l_active(A' - S')(A' - A'(w^-1 X)).

Mirrors the constraint set of halo2 v0.3.0's permutation and lookup
arguments (SURVEY.md section 2.13), with chunk layout from
ConstraintSystem.permutation_chunk_len.
"""

from __future__ import annotations

from benchmark.reference.frozen.ir import ADVICE, FIXED, INSTANCE, ConstraintSystem, Ref


# --------------------------------------------------------------------------
# evaluation queries: which (column, rotation) evals the proof carries
# --------------------------------------------------------------------------

def column_queries(cs: ConstraintSystem):
    """Ordered (col, rot) query lists per column kind.

    Includes every reference in gates and lookup input expressions, every
    permutation column at rotation 0, and every lookup table column at
    rotation 0."""
    refs = set()
    for _, g in cs.gates:
        refs |= g.columns()
    for lk in cs.lookups:
        for e, tcol in lk.pairs:
            refs |= e.columns()
            refs.add((tcol, 0))
    for c in cs.perm_columns:
        refs.add((c, 0))
    out = {ADVICE: [], FIXED: [], INSTANCE: []}
    for col, rot in sorted(refs):
        out[cs.columns[col].kind].append((col, rot))
    return out


# --------------------------------------------------------------------------
# multiopen query plan
# --------------------------------------------------------------------------

# rotation tags: ints are powers of omega relative to x; "u" = omega^usable
def open_queries(cs: ConstraintSystem):
    """Canonical ordered list of (poly_key, rot_tag) opened at x*w^rot.

    poly_key is a hashable identifier; both sides map it to their own
    commitment/coefficient/eval storage."""
    qs = column_queries(cs)
    plan = []
    for col, rot in qs[ADVICE]:
        plan.append((("advice", col), rot))
    for col, rot in qs[FIXED]:
        plan.append((("fixed", col), rot))
    for i in range(len(cs.perm_columns)):
        plan.append((("sigma", i), 0))
    chunks = -(-len(cs.perm_columns) // cs.permutation_chunk_len())
    for t in range(chunks):
        plan.append((("perm_z", t), 0))
        plan.append((("perm_z", t), 1))
        if t < chunks - 1:
            plan.append((("perm_z", t), "u"))
    for i in range(len(cs.lookups)):
        plan.append((("lookup_z", i), 0))
        plan.append((("lookup_z", i), 1))
        plan.append((("lookup_a", i), 0))
        plan.append((("lookup_a", i), -1))
        plan.append((("lookup_s", i), 0))
    plan.append((("h",), 0))
    plan.append((("random",), 0))
    return plan


def group_queries(plan):
    """Group the plan by poly_key preserving first-appearance order.

    Returns list of (poly_key, [rot_tags])."""
    order = []
    sets = {}
    for key, rot in plan:
        if key not in sets:
            sets[key] = []
            order.append(key)
        if rot not in sets[key]:
            sets[key].append(rot)
    return [(key, sets[key]) for key in order]


def rotation_sets(plan):
    """Cluster polys by identical rotation SET — halo2 v0.3.0 SHPLONK's
    ``construct_intermediate_sets`` grouping (kzg/multiopen/shplonk).

    Returns list of (rot_tags, poly_keys): clusters ordered by the first
    appearance of a member poly in the plan, members in plan order, and
    the cluster's rotation list in its first member's order.  The
    SHPLONK fold is two-level: a first challenge folds members WITHIN a
    cluster, v folds ACROSS clusters (Horner direction — the first
    member/cluster takes the highest power, matching halo2's
    ``acc * challenge + term`` folds)."""
    order = []
    clusters = {}
    for key, rots in group_queries(plan):
        sig = frozenset(rots)
        if sig not in clusters:
            clusters[sig] = (list(rots), [])
            order.append(sig)
        clusters[sig][1].append(key)
    return [clusters[sig] for sig in order]


# --------------------------------------------------------------------------
# constraint terms
# --------------------------------------------------------------------------

class Context:
    """Abstract accessor interface; see ProverContext / VerifierContext.

    Required attributes/methods:
      alg                  -- algebra with const/add/mul/neg
      one                  -- algebra ONE value
      column(col, rot)     -- value of column poly at rotation
      l0, l_last, l_active -- selector polys over the blinding structure
      beta, gamma          -- challenge values (algebra form)
      theta                -- challenge for lookup compression
      perm_z(t, rot_tag), sigma(i), perm_id(i)
      lookup_z(i, rot), lookup_a(i, rot), lookup_s(i)
    """


def _compress(ctx, exprs_or_cols, is_table: bool):
    alg = ctx.alg
    acc = None
    for item in exprs_or_cols:
        v = ctx.column(item, 0) if is_table else item.eval(alg, ctx.column)
        acc = v if acc is None else alg.add(alg.mul(acc, ctx.theta), v)
    return acc


def compressed_input(ctx, lk):
    return _compress(ctx, [e for e, _ in lk.pairs], is_table=False)


def compressed_table(ctx, lk):
    return _compress(ctx, [c for _, c in lk.pairs], is_table=True)


def constraint_terms(cs: ConstraintSystem, ctx: Context):
    """Yield every quotient term in canonical order."""
    alg = ctx.alg
    one = ctx.one

    def sub(a, b):
        return alg.add(a, alg.neg(b))

    for _, gate in cs.gates:
        yield gate.eval(alg, ctx.column)

    m = len(cs.perm_columns)
    if m:
        chunk_len = cs.permutation_chunk_len()
        chunks = -(-m // chunk_len)
        yield alg.mul(ctx.l0, sub(one, ctx.perm_z(0, 0)))
        zl = ctx.perm_z(chunks - 1, 0)
        yield alg.mul(ctx.l_last, sub(alg.mul(zl, zl), zl))
        for t in range(1, chunks):
            yield alg.mul(ctx.l0, sub(ctx.perm_z(t, 0), ctx.perm_z(t - 1, "u")))
        for t in range(chunks):
            left = ctx.perm_z(t, 1)
            right = ctx.perm_z(t, 0)
            for i in range(t * chunk_len, min((t + 1) * chunk_len, m)):
                v = ctx.column(cs.perm_columns[i], 0)
                left = alg.mul(
                    left,
                    alg.add(v, alg.add(alg.mul(ctx.beta, ctx.sigma(i)), ctx.gamma)),
                )
                right = alg.mul(
                    right,
                    alg.add(v, alg.add(alg.mul(ctx.beta, ctx.perm_id(i)), ctx.gamma)),
                )
            yield alg.mul(ctx.l_active, sub(left, right))

    for i, lk in enumerate(cs.lookups):
        z = ctx.lookup_z(i, 0)
        zw = ctx.lookup_z(i, 1)
        ap = ctx.lookup_a(i, 0)
        ap_prev = ctx.lookup_a(i, -1)
        sp = ctx.lookup_s(i)
        a_c = compressed_input(ctx, lk)
        s_c = compressed_table(ctx, lk)
        yield alg.mul(ctx.l0, sub(one, z))
        yield alg.mul(ctx.l_last, sub(alg.mul(z, z), z))
        prod_perm = alg.mul(zw, alg.mul(alg.add(ap, ctx.beta), alg.add(sp, ctx.gamma)))
        prod_orig = alg.mul(z, alg.mul(alg.add(a_c, ctx.beta), alg.add(s_c, ctx.gamma)))
        yield alg.mul(ctx.l_active, sub(prod_perm, prod_orig))
        yield alg.mul(ctx.l0, sub(ap, sp))
        yield alg.mul(ctx.l_active, alg.mul(sub(ap, sp), sub(ap, ap_prev)))
