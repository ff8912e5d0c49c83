"""Proof verifier (host-side python ints + one pairing-product check).

The reference crate never verifies anything (SURVEY.md section 2.11:
"No verifier is ever invoked anywhere in the crate") — this module is a
deliberate capability addition (build plan SURVEY.md section 7 step 7).
It replays the prover's transcript (backend/prover.py docstring),
recomputes the expected quotient value at the challenge point from the
shared protocol terms, reconstructs the SHPLONK linearization
commitment, and checks one pairing product.

Everything here is O(proof size) scalar math; nothing touches the TPU.
"""

from __future__ import annotations

from halo2_aes_tpu_torch.backend import pairing as PR
from halo2_aes_tpu_torch.backend import poly as P
from halo2_aes_tpu_torch.backend import protocol as PROTO
from halo2_aes_tpu_torch.backend.keygen import VerifyingKey
from halo2_aes_tpu_torch.backend.transcript import TranscriptReader
from halo2_aes_tpu_torch.circuit.ir import ADVICE, FIXED, INSTANCE
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops.field import FR
from halo2_aes_tpu_torch.ops.ntt import domain

R = FR.modulus


class HostAlgebra:
    @staticmethod
    def const(v: int):
        return v % R

    add = staticmethod(lambda a, b: (a + b) % R)
    mul = staticmethod(lambda a, b: a * b % R)
    neg = staticmethod(lambda a: -a % R)


class VerifyError(ValueError):
    pass


def verify(vk: VerifyingKey, proof: bytes, instances=None,
           multiopen: str = "shplonk") -> bool:
    """Raises VerifyError on any failure; returns True on success.

    ``multiopen`` selects the opening argument: "shplonk" (default,
    BDFG20) or "gwc" (plonk-style per-point witnesses) — the two
    KZG backends behind the facade (role of the reference's
    compile-time backend switch, src/lib.rs:10-13)."""
    pairs = verify_pairs(vk, proof, instances, multiopen)
    if not PR.pairing_product_is_one(pairs):
        raise VerifyError("pairing check failed")
    return True


def verify_batch(vk: VerifyingKey, proofs, instances=None,
                 multiopen: str = "shplonk") -> bool:
    """Verify many proofs with ONE pairing-product check.

    Each proof's final check has the shape e(A_i, H1) e(B_i, H2) = 1
    with the same (H1, H2) G2 points for every proof, so a random
    linear combination sum r_i A_i / sum r_i B_i (128-bit r_i, r_0=1)
    collapses N proofs into one 2-pairing check plus a size-2N host
    MSM — the serving-side fast path for proof BUNDLES (e.g. the
    multi-proof AES-CTR runner).  Soundness error <= 2^-128 per forged
    proof.  All transcript replays still run per proof; only the
    pairings are shared.  Raises VerifyError naming the first failing
    transcript; a combined-check failure raises without attribution
    (re-run verify() per proof to isolate)."""
    import secrets

    if instances is None:
        instances = [None] * len(proofs)
    assert len(instances) == len(proofs)
    if not proofs:
        return True
    pts_a, pts_b, scs = [], [], []
    g2_a = g2_b = None
    for i, (proof, inst) in enumerate(zip(proofs, instances)):
        try:
            (a, ga), (b, gb) = verify_pairs(vk, proof, inst, multiopen)
        except VerifyError as e:
            raise VerifyError(f"proof {i}: {e}") from e
        g2_a, g2_b = ga, gb
        r = 1 if i == 0 else (secrets.randbits(128) | 1)
        pts_a.append(a)
        pts_b.append(b)
        scs.append(r)
    lhs = CV.host_msm(pts_a, scs)
    rhs = CV.host_msm(pts_b, scs)
    if not PR.pairing_product_is_one([(lhs, g2_a), (rhs, g2_b)]):
        raise VerifyError("batched pairing check failed")
    return True


def verify_pairs(vk: VerifyingKey, proof: bytes, instances=None,
                 multiopen: str = "shplonk"):
    """Transcript replay + all scalar checks; returns the two
    (G1, G2) pairs whose pairing product must be one (deferred so
    verify_batch can fold many proofs into a single product)."""
    tr, plan, comms, evals, rot_point = _replay_common(vk, proof, instances)
    if multiopen == "gwc":
        return _gwc_pairs(vk, tr, plan, comms, evals, rot_point)
    assert multiopen == "shplonk", multiopen

    msm_pts, msm_scs, const_corr, u = _shplonk_lincomb(
        tr, plan, comms, evals, rot_point)
    try:
        w_q = tr.read_point()
        tr.assert_consumed()
    except ValueError as e:
        raise VerifyError(str(e)) from e
    msm_pts = list(msm_pts) + [(CV.G1_X, CV.G1_Y), w_q]
    msm_scs = list(msm_scs) + [-const_corr % R, u]
    lhs = CV.host_msm(msm_pts, msm_scs)
    neg_wq = None if w_q is None else (w_q[0], -w_q[1] % PR.Q)
    return [(lhs, vk.g2), (neg_wq, vk.s_g2)]


def _replay_common(vk: VerifyingKey, proof: bytes, instances=None):
    """PCS-agnostic transcript replay: reads every PLONK-phase
    commitment and evaluation, replays all challenges through the
    quotient check, and returns (tr, plan, comms, evals, rot_point)
    with evals[("h",), 0] set to the expected quotient value — the
    state every multiopen argument (SHPLONK, GWC, IPA) starts from."""
    cs = vk.cs
    k, usable = vk.k, vk.usable
    n = 1 << k
    dom = domain(FR, k)
    omega = dom.omega
    chunks = -(-len(cs.perm_columns) // cs.permutation_chunk_len())
    tr = TranscriptReader(proof)

    tr.common_scalar(vk.digest)
    instances = instances or []
    inst_ids = [c.index for c in cs.columns if c.kind == INSTANCE]
    if len(instances) != len(inst_ids):
        raise VerifyError("instance count mismatch")
    for vals in instances:
        for v in vals:
            tr.common_scalar(int(v))

    advice_ids = [c.index for c in cs.columns if c.kind == ADVICE]
    comms = {}
    try:
        for c in advice_ids:
            comms[("advice", c)] = tr.read_point()
        theta = tr.squeeze_challenge()
        for i in range(len(cs.lookups)):
            comms[("lookup_a", i)] = tr.read_point()
            comms[("lookup_s", i)] = tr.read_point()
        beta = tr.squeeze_challenge()
        gamma = tr.squeeze_challenge()
        for t in range(chunks):
            comms[("perm_z", t)] = tr.read_point()
        for i in range(len(cs.lookups)):
            comms[("lookup_z", i)] = tr.read_point()
        comms[("random",)] = tr.read_point()
        y = tr.squeeze_challenge()
        # d-1 quotient pieces (matches the prover; halo2 commits d-1 too)
        h_pieces = [tr.read_point() for _ in range(cs.degree() - 1)]
        x = tr.squeeze_challenge()

        plan = PROTO.open_queries(cs)
        evals = {}
        for key, rot in plan:
            if key[0] != "h":
                evals[(key, rot)] = tr.read_scalar()
    except ValueError as e:
        raise VerifyError(str(e)) from e

    for i, c in enumerate(vk.fixed_ids):
        comms[("fixed", c)] = vk.fixed_commitments[i]
    for i, pt in enumerate(vk.sigma_commitments):
        comms[("sigma", i)] = pt

    # combined h commitment and its expected evaluation
    xn = pow(x, n, R)
    comms[("h",)] = CV.host_msm(
        h_pieces, [pow(xn, j, R) for j in range(len(h_pieces))])

    def rot_point(rot):
        r = usable if rot == "u" else rot
        return x * pow(omega, r % n, R) % R

    # ---- expected quotient value at x ---------------------------------------
    # Guard before ANY (x - w^j)^-1 inversion (lagrange evals here and in
    # Ctx.column's instance path): a challenge landing in the domain —
    # negligible honestly, but attacker-influenced via transcript
    # grinding — must raise VerifyError, not ValueError.
    zh_x = (pow(x, n, R) - 1) % R
    if zh_x == 0:
        raise VerifyError("challenge x in domain")
    blind_rows = list(range(usable + 1, n))
    lag = P.lagrange_evals_host(k, x, [0, usable] + blind_rows)
    l0x, l_lastx = lag[0], lag[1]
    l_activex = (1 - l_lastx - sum(lag[2:])) % R

    inst_vals = dict(zip(inst_ids, instances))

    class Ctx(PROTO.Context):
        alg = HostAlgebra
        one = 1
        l0, l_last, l_active = l0x, l_lastx, l_activex

        @staticmethod
        def column(col, rot):
            kind = cs.columns[col].kind
            if kind == ADVICE:
                return evals[(("advice", col), rot)]
            if kind == FIXED:
                return evals[(("fixed", col), rot)]
            vals = inst_vals[col]
            ls = P.lagrange_evals_host(k, rot_point(rot), range(len(vals)))
            return sum(int(v) * l for v, l in zip(vals, ls)) % R

        @staticmethod
        def perm_z(t, rot):
            return evals[(("perm_z", t), rot)]

        @staticmethod
        def sigma(i):
            return evals[(("sigma", i), 0)]

        @staticmethod
        def perm_id(i):
            from halo2_aes_tpu_torch.backend.permutation import delta

            return pow(delta(), i, R) * x % R

        @staticmethod
        def lookup_z(i, rot):
            return evals[(("lookup_z", i), rot)]

        @staticmethod
        def lookup_a(i, rot):
            return evals[(("lookup_a", i), rot)]

        @staticmethod
        def lookup_s(i):
            return evals[(("lookup_s", i), 0)]

    Ctx.theta, Ctx.beta, Ctx.gamma = theta, beta, gamma

    acc = None
    try:
        for term in PROTO.constraint_terms(cs, Ctx):
            acc = term if acc is None else (acc * y + term) % R
    except ValueError as e:  # defensive: any stray inversion failure
        raise VerifyError(str(e)) from e
    evals[(("h",), 0)] = acc * pow(zh_x, -1, R) % R
    return tr, plan, comms, evals, rot_point


def _shplonk_lincomb(tr, plan, comms, evals, rot_point):
    """SHPLONK reduction scalars (halo2 rotation-set grouping),
    PCS-agnostic: mirrors the prover — polys cluster by identical
    rotation set, y2 folds members within a cluster, v folds across
    clusters (Horner direction: first member/cluster takes the highest
    power).  Consumes y2 | v | H commit | u from the transcript and
    returns (msm_pts, msm_scs, const_corr, u) such that

        C_L = MSM(msm_pts, msm_scs) - const_corr * [1]

    commits to a polynomial with L(u) = 0.  The KZG caller closes with
    the quotient witness + pairing; the IPA caller (backend/ipa.py)
    opens C_L at u directly."""
    y2 = tr.squeeze_challenge()
    v = tr.squeeze_challenge()
    try:
        w_h = tr.read_point()
    except ValueError as e:
        raise VerifyError(str(e)) from e
    u = tr.squeeze_challenge()

    sets_ = PROTO.rotation_sets(plan)
    K = len(sets_)
    t_rots = []
    for rots, _ in sets_:
        for r_ in rots:
            if r_ not in t_rots:
                t_rots.append(r_)
    t_points = [rot_point(r_) for r_ in t_rots]
    zt_u = P.eval_host(P.vanishing_poly_coeffs(t_points), u)

    msm_pts, msm_scs = [w_h], [-zt_u % R]
    const_corr = 0
    for gi, (rots, keys) in enumerate(sets_):
        vpw = pow(v, K - 1 - gi, R)
        pts = [rot_point(r_) for r_ in rots]
        s = vpw * P.eval_host(
            P.vanishing_poly_coeffs([p for p in t_points if p not in pts]), u
        ) % R
        ev_fold = [0] * len(rots)
        for i, key in enumerate(keys):
            w = pow(y2, len(keys) - 1 - i, R)
            msm_pts.append(comms[key])
            msm_scs.append(s * w % R)
            for j, r_ in enumerate(rots):
                ev_fold[j] = (ev_fold[j] + w * evals[(key, r_)]) % R
        r_u = P.eval_host(P.lagrange_interp_host(pts, ev_fold), u)
        const_corr = (const_corr + s * r_u) % R
    return msm_pts, msm_scs, const_corr, u


def _gwc_pairs(vk, tr, plan, comms, evals, rot_point):
    """GWC batch-opening check: per rotation point z_i the prover sent
    W_i = [(F_i - F_i(z_i))/(X - z_i)]; the verifier checks

        e(sum_i u^i W_i, [s]_2) = e(sum_i u^i (z_i W_i + [F_i] - e_i G), [1]_2)

    with F_i = sum_j v^j p_j, e_i = sum_j v^j evals over the polys
    opened at z_i (v-power order = plan order at that point)."""
    v = tr.squeeze_challenge()
    rot_order, by_rot = [], {}
    for key, rot in plan:
        if rot not in by_rot:
            by_rot[rot] = []
            rot_order.append(rot)
        by_rot[rot].append(key)
    try:
        w_comms = [tr.read_point() for _ in rot_order]
        u = tr.squeeze_challenge()
        tr.assert_consumed()
    except ValueError as e:
        raise VerifyError(str(e)) from e

    lhs_pts, lhs_scs = [], []
    rhs_pts, rhs_scs = [], []
    e_total = 0
    u_pow = 1
    for rot, w in zip(rot_order, w_comms):
        z = rot_point(rot)
        v_pow = 1
        for key in by_rot[rot]:
            rhs_pts.append(comms[key])
            rhs_scs.append(u_pow * v_pow % R)
            e_total = (e_total + u_pow * v_pow * evals[(key, rot)]) % R
            v_pow = v_pow * v % R
        lhs_pts.append(w)
        lhs_scs.append(u_pow)
        rhs_pts.append(w)
        rhs_scs.append(u_pow * z % R)
        u_pow = u_pow * u % R
    rhs_pts.append((CV.G1_X, CV.G1_Y))
    rhs_scs.append(-e_total % R)
    lhs = CV.host_msm(lhs_pts, lhs_scs)
    rhs = CV.host_msm(rhs_pts, rhs_scs)
    neg_rhs = None if rhs is None else (rhs[0], -rhs[1] % PR.Q)
    return [(lhs, vk.s_g2), (neg_rhs, vk.g2)]
