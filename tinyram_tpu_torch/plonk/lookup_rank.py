"""The lookups' sort-and-match on the prover's device, as indices.

The prover holds each plookup's θ-compressed input column A and table
column S, and each LogUp argument's input and table columns, in Montgomery
form on its device.  The plookup argument commits A' (A in ascending order
of value) and S' (S rearranged so that S'[i] = A'[i] wherever A'[i] starts
a run of equal values); the LogUp argument commits, on the first table row
holding each value, how many inputs equal it.  Both depend on the values
only through their order and their equality.  So the values are ranked
here, on the device, and what comes back are indices: the prover gathers
A' and S' from the Montgomery columns it already holds, and only one flag
a call (the missing-value check) comes to the host.

`plookup_sources` gives, element for element, the permutation of the
reference's host rules (`tinyram_tpu/plonk/prover.py`), `permute_lookup`
(Python ints) and `permute_lookup_np` (int64, every value of the lookup
below 2^62): their order is part of the proof's bytes.  A' is the same in
both.  S' places the leftover table entries (those not matched to a run of
A') in A''s remaining slots in `Counter.elements()` order under the first
rule (values by their first occurrence in S, each repeated its remaining
count) and in ascending order under the second; the rule is chosen per
lookup, as the host chose it, by whether every value of A and S is below
2^62.  `logup_counts` ranks the same way: the counts depend only on which
values are equal, so one rule serves every value of the field.
"""

from __future__ import annotations

import torch

from ..field.params import N_LIMBS, limbs_to_int

# values one ranking sorts at once: a lookup's 2u values (A and S) are
# never split, lookups are ranked in groups of at most this many values;
# a LogUp table is ranked with as many of its input columns as fit beside it
RANK_ELEMENTS = 1 << 23
_LAST = 1 << 62  # a sort key above every id and every row


def _word(plain: torch.Tensor, j: int, group: torch.Tensor) -> torch.Tensor:
    """Word j (0 least significant) of the sort key of `plain`'s values:
    three 16-bit limbs a word, the group above the top limb in the last."""
    if 3 * j + 3 > N_LIMBS:
        return _pack(plain, [N_LIMBS - 1]) | (group << 16)
    return _pack(plain, range(3 * j, 3 * j + 3))


def _pack(plain: torch.Tensor, limbs) -> torch.Tensor:
    """The limbs `limbs` (ascending) of (16, ...) plain limbs as one int64,
    built in place (one int64 temporary)."""
    *rest, top = limbs
    out = plain[top].long()
    for i in reversed(rest):
        out <<= 16
        out |= plain[i]
    return out


def _dense_ids(plain: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """The (N,) int64 ids of the N values `plain` (16, N) canonical plain
    limbs, each tagged by `group` (N,) int64 ≥ 0: equal for values of one
    group that are equal, ordered by (group, value), dense from 0.  A
    least-significant-word-first sort: one stable argsort a key word."""
    words = (N_LIMBS + 2) // 3
    order = None
    for j in range(words):
        w = _word(plain, j, group)
        key = w if order is None else w[order]
        step = torch.argsort(key, stable=True)
        order = step if order is None else order[step]
    new = torch.zeros(order.shape, dtype=torch.bool, device=order.device)
    for j in range(words):
        w = _word(plain, j, group)[order]
        new[1:] |= w[1:] != w[:-1]
    return torch.empty_like(order).scatter_(0, order, torch.cumsum(new, 0))


def _below_2_62(plain: torch.Tensor) -> torch.Tensor:
    """Over the last dimension of (16, ..., N) plain limbs: whether every
    value is below 2^62 (`permute_lookup_np`'s domain)."""
    return ((plain[4:] == 0).all(0) & (plain[3] < (1 << 14))).all(-1)


def _runs(ids: torch.Tensor) -> torch.Tensor:
    """Of rows of ascending ids: where a run of equal ids starts."""
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    return first


def _plookup_group(plain: torch.Tensor):
    """`plookup_sources` of g lookups, (16, 2g, u) → (src (g, 2, u), pos):
    `pos` a 0-d tensor, the flat index (lookup · u + row) of an input whose
    value is not in its table, the least such value of the first such
    lookup, or −1."""
    g, u = plain.shape[1] // 2, plain.shape[2]
    dev = plain.device
    group = torch.arange(g, device=dev).repeat_interleave(2 * u)
    ids = _dense_ids(plain.reshape(N_LIMBS, -1), group).view(g, 2, u)
    ga, gs = ids[:, 0], ids[:, 1]
    sa, a_ord = torch.sort(ga, dim=1, stable=True)  # A' and where it is in A
    first = _runs(sa)
    ss, s_ord = torch.sort(gs, dim=1, stable=True)
    s_first = _runs(ss)
    need = torch.zeros(2 * g * u, dtype=torch.bool, device=dev)
    need[ga.reshape(-1)] = True
    has = torch.zeros_like(need)
    has[gs.reshape(-1)] = True
    # one table entry of each value A needs goes to A''s run start; the
    # leftovers, in the host rule's order, fill A''s other slots in order
    rows = torch.arange(u, device=dev).expand(g, u)
    start = torch.cummax(torch.where(s_first, rows, 0), dim=1).values
    small = _below_2_62(plain).view(g, 2).all(1)
    key = torch.where(small[:, None], ss, s_ord.gather(1, start))
    key = key.masked_fill(s_first & need[ss], _LAST)
    left = torch.sort(key, dim=1, stable=True).indices
    slots = torch.sort(first.to(torch.uint8), dim=1, stable=True).indices
    s_src = torch.empty_like(a_ord).scatter_(1, slots,
                                             u + s_ord.gather(1, left))
    s_src = torch.where(first, a_ord, s_src)
    bad = (need & ~has)[ga]
    pos = torch.where(bad, ga, _LAST).reshape(-1).argmin()
    return torch.stack([a_ord, s_src], 1), torch.where(bad.any(), pos, -1)


def plookup_sources(plain: torch.Tensor) -> torch.Tensor:
    """The plookup permutations of L lookups on their usable rows.

    `plain` (16, 2L, u) holds canonical plain limbs (`FP.from_mont`), its
    columns A_0, S_0, A_1, S_1, ….  Returns src (L, 2, u) int64 on the
    same device: A'_l = [A_l | S_l][src[l, 0]] and S'_l = [A_l | S_l][src[l,
    1]], indices into the 2u rows of A_l followed by S_l, equal element
    for element to the host rule `permute_lookup` (or `permute_lookup_np`
    where every value of the lookup is below 2^62).  Raises that rule's
    ValueError where an input is not in its table: one host sync."""
    lookups, u = plain.shape[1] // 2, plain.shape[2]
    per = max(1, RANK_ELEMENTS // (2 * u))
    srcs, poss = [], []
    for lo in range(0, lookups, per):
        src, pos = _plookup_group(plain[:, 2 * lo : 2 * (lo + per)])
        srcs.append(src)
        poss.append(pos)
    for gi, pos in enumerate(torch.stack(poss).tolist()):
        if pos >= 0:
            li, row = gi * per + pos // u, pos % u
            v = limbs_to_int(plain[:, 2 * li, row].tolist())
            raise ValueError(f"lookup input {v} not present in table")
    return srcs[0] if len(srcs) == 1 else torch.cat(srcs)


def logup_counts(in_plain: torch.Tensor, t_plain: torch.Tensor, name: str):
    """The LogUp multiplicities of one argument on its usable rows.

    `in_plain` (16, B, u) and `t_plain` (16, u) hold the B input columns'
    and the table's canonical plain limbs.  Returns (16, u) plain limbs on
    the same device: on the first table row holding each value, the number
    of inputs equal to it, and 0 elsewhere.  Raises the host rule's
    ValueError, naming the first input (column by column) that is not in
    the table.  The inputs are ranked beside the table in groups of
    columns (at most RANK_ELEMENTS values a ranking); one host sync."""
    u = t_plain.shape[-1]
    dev = t_plain.device
    per = max(1, RANK_ELEMENTS // u - 1)
    rows = torch.arange(u, device=dev)
    counts = torch.zeros(u + 1, dtype=torch.int64, device=dev)
    misses = []
    for lo in range(0, in_plain.shape[1], per):
        both = torch.cat([t_plain, in_plain[:, lo : lo + per].reshape(
            N_LIMBS, -1)], dim=1)
        ids = _dense_ids(both, torch.zeros(both.shape[1], dtype=torch.int64,
                                           device=dev))
        # the first table row holding each value, u where none does
        first = torch.full_like(ids, u).scatter_reduce_(0, ids[:u], rows,
                                                        "amin")
        row = first[ids[u:]]
        counts += torch.bincount(row, minlength=u + 1)
        miss = row == u
        misses.append(torch.where(miss.any(), lo * u + miss.to(
            torch.uint8).argmax(), -1))
    for pos in torch.stack(misses).tolist():
        if pos >= 0:
            v = limbs_to_int(in_plain[:, pos // u, pos % u].tolist())
            raise ValueError(f"range_lookup {name}: input {v} not in table")
    limbs = torch.zeros((N_LIMBS, u), dtype=torch.int32, device=dev)
    for i in range(4):
        limbs[i] = ((counts[:u] >> (16 * i)) & 0xFFFF).to(torch.int32)
    return limbs
