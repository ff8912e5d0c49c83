"""Lookup argument (halo2 v0.3.0 style): permuted pairs + grand product
(port of ``backend/lookup.py``).

Two orders of the permuted pairs:
  * field (the default): by the CANONICAL field value of the
    theta-compressed scalars (halo2's ``permute_expression_pair``
    order): an LSD radix of stable argsorts over the eight 32-bit
    words, then scatter/compaction steps, all batched over the L
    lookups;
  * packed: by a uint32 key packing up to four byte-ranged input
    columns, against the table's host-sorted keys (``permuted_indices``).
"""

from __future__ import annotations

import torch

from halo2_aes_tpu_torch.ops import field as F

FR = F.FR


def _scatter_set(size: int, idx, vals, fill, dtype):
    """out[idx] = vals with indices >= size dropped (JAX mode="drop")."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=idx.device)
    out.scatter_(0, idx.clamp(max=size), vals.to(dtype))
    return out[:size]


def permuted_indices(packed_input, table_sorted, table_order, usable: int):
    """Index-level permuted pair construction over rows [0, usable) on
    packed keys.

    ``packed_input``: int64 tensor of uint32 keys (rows >= usable are
    ignored); ``table_sorted``/``table_order``: the TABLE's keys sorted
    on the host and their argsort (int64 tensors).  Returns
    (input_perm, table_perm) int64[usable]: A' = A[input_perm] is
    grouped, S'[j] = A'[j] at each first occurrence, S' a permutation of
    the table."""
    dev = packed_input.device
    a_order = torch.argsort(packed_input[:usable], stable=True)
    a_sorted = packed_input[a_order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       a_sorted[1:] != a_sorted[:-1]])
    # one table slot per distinct input value
    slots = torch.searchsorted(table_sorted, a_sorted)
    used = _scatter_set(usable, torch.where(first, slots, usable), first,
                        False, torch.bool)
    # unused table rows, compacted in sorted-value order
    rem = table_order[torch.argsort(used.to(torch.int64), stable=True)]
    fill_rank = (torch.cumsum((~first).to(torch.int64), 0) - 1).clamp(min=0)
    table_perm = torch.where(first, table_order[slots.clamp(0, usable - 1)],
                             rem[fill_rank])
    return a_order, table_perm


def apply_permutation(field_col, perm, blinding):
    """Gather field rows by perm and append the blinding tail."""
    return torch.cat([field_col[perm], blinding])


def permuted_indices_field(a_std, s_std, usable: int):
    """``permuted_indices_field_many`` for one lookup: (usable, 16)
    STANDARD-form input and table columns -> (a_order, table_perm), each
    (usable,) int64."""
    a_order, t_perm = permuted_indices_field_many(a_std[:usable], s_std[:usable],
                                                  1, usable)
    return a_order[0], t_perm[0]


def permuted_indices_field_many(a_std, s_std, L: int, usable: int):
    """Batched permuted-pair construction over L lookups.

    ``a_std``/``s_std``: FLAT (L*usable, 16) STANDARD-form limbs (lookup
    l at rows [l*usable, (l+1)*usable)).  Returns (a_order, table_perm)
    as (L, usable) int64 row permutations: A' = A[a_order] is grouped
    by value, S'[j] = A'[j] at each group's first row, S' a permutation
    of the table."""
    u = usable
    M = 2 * u
    dev = a_std.device
    HI = M

    def words(x):
        x = x.to(torch.int64)
        return [(x[:, 2 * j + 1] << 16) | x[:, 2 * j] for j in range(8)]

    comb = [torch.cat([a.reshape(L, u), s.reshape(L, u)], dim=1)
            for a, s in zip(words(a_std), words(s_std))]
    order = torch.argsort(comb[0], dim=1, stable=True)
    for j in range(1, 8):
        order = torch.gather(order, 1, torch.argsort(
            torch.gather(comb[j], 1, order), dim=1, stable=True))
    sk = [torch.gather(c, 1, order) for c in comb]
    is_input = order < u
    neq = sk[0][:, 1:] != sk[0][:, :-1]
    for j in range(1, 8):
        neq = neq | (sk[j][:, 1:] != sk[j][:, :-1])
    group_start = torch.cat([torch.ones((L, 1), dtype=torch.bool, device=dev),
                             neq], dim=1)
    gid = torch.cumsum(group_start.to(torch.int64), dim=1) - 1
    pos = torch.arange(M, device=dev).expand(L, M)

    row2 = (torch.arange(L, device=dev) * M)[:, None]
    rowu = (torch.arange(L, device=dev) * u)[:, None]
    drop_u = L * u

    rank_in = torch.cumsum(is_input.to(torch.int64), dim=1) - 1
    in_slot = torch.where(is_input, rank_in + rowu, drop_u).reshape(-1)
    a_order = _scatter_set(L * u, in_slot, order.reshape(-1), 0,
                           torch.int64).reshape(L, u)

    gid_flat = (gid + row2).reshape(-1)
    rows = torch.arange(L, device=dev)[:, None]
    gcol = gid.clamp(max=M - 1)

    def group_min(vals):
        out = torch.full((L * M,), HI, dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, gid_flat, vals.reshape(-1), reduce="amin",
                            include_self=True)
        return out.reshape(L, M)[rows, gcol]

    first_in_pos = group_min(torch.where(is_input, pos, HI))
    first_tab_pos = group_min(torch.where(is_input, HI, pos))
    first_flag = is_input & (pos == first_in_pos)
    safe_tab_pos = first_tab_pos.clamp(0, M - 1)
    match_row = (torch.gather(order, 1, safe_tab_pos) - u).clamp(0, u - 1)

    firstA = _scatter_set(L * u, in_slot, first_flag.reshape(-1), False,
                          torch.bool).reshape(L, u)
    matchA = _scatter_set(L * u, in_slot, match_row.reshape(-1), 0,
                          torch.int64).reshape(L, u)
    used = _scatter_set(
        L * u, torch.where(first_flag, match_row + rowu, drop_u).reshape(-1),
        torch.ones(L * M, dtype=torch.bool, device=dev), False,
        torch.bool).reshape(L, u)
    rank_tab = torch.cumsum((~is_input).to(torch.int64), dim=1) - 1
    s_order = _scatter_set(
        L * u, torch.where(is_input, drop_u, rank_tab + rowu).reshape(-1),
        (order - u).reshape(-1), 0, torch.int64).reshape(L, u)
    rem = torch.gather(s_order, 1, torch.argsort(
        torch.gather(used, 1, s_order).to(torch.int64), dim=1, stable=True))
    fill_rank = (torch.cumsum((~firstA).to(torch.int64), dim=1) - 1).clamp(min=0)
    table_perm = torch.where(firstA, matchA, torch.gather(rem, 1, fill_rank))
    return a_order, table_perm


def grand_product(a, s, a_perm, s_perm, usable: int, beta_m, gamma_m, blinding):
    """One lookup's z column: z[0] = 1,
    z[j+1] = z[j] (A+beta)(S+gamma) / ((A'+beta)(S'+gamma)).  a, s: the
    compressed input/table columns (n, 16); a_perm, s_perm: the permuted
    columns.  Rows past the blinding boundary take ``blinding`` (the
    value at row ``usable``, 1 on honest witnesses, is kept for the
    l_last constraint).  The k >= 19 product phase streams the lookups
    through this one at a time; it equals the matching rows of
    ``grand_product_many``."""
    n = a.shape[0]
    one = F.const(FR, "one", a.device)
    num = F.mont_mul(FR, F.add(FR, a, beta_m), F.add(FR, s, gamma_m))
    den = F.mont_mul(FR, F.add(FR, a_perm, beta_m), F.add(FR, s_perm, gamma_m))
    ratio = F.mont_mul(FR, num, F.batch_inv(FR, den))
    ratio = F.select(torch.arange(n, device=a.device) < usable, ratio, one)
    cum = F.cumprod(FR, ratio)
    return torch.cat([one[None], cum[:n - 1 - blinding.shape[0]], blinding])


def grand_product_many(a, s, a_perm, s_perm, L: int, usable: int,
                       beta_m, gamma_m, blinding):
    """All L lookups' z columns over FLAT (L*n, 16) tensors (lookup l at
    rows [l*n, (l+1)*n)); blinding (L, blind_rows, 16).  One batched
    inversion and one segmented scan."""
    m = a.shape[0]
    n = m // L
    bf = blinding.shape[1]
    dev = a.device
    one = F.const(FR, "one", dev)
    num = F.mont_mul(FR, F.add(FR, a, beta_m), F.add(FR, s, gamma_m))
    den = F.mont_mul(FR, F.add(FR, a_perm, beta_m), F.add(FR, s_perm, gamma_m))
    ratio = F.mont_mul(FR, num, F.batch_inv(FR, den))
    offs = torch.arange(m, device=dev) % n
    ratio = F.select(offs < usable, ratio, one)
    cum = F.cumprod_segmented(FR, ratio, n)
    z = torch.cat([one[None], cum[:-1]])
    z = F.select(offs == 0, one, z)
    tail = (torch.arange(L, device=dev)[:, None] * n + (n - bf)
            + torch.arange(bf, device=dev)[None, :]).reshape(-1)
    z = z.clone()
    z[tail] = blinding.reshape(L * bf, F.LIMBS)
    return z
