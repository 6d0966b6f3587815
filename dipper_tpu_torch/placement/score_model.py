"""A plain model of csrc/score_edges.cu's algorithm, and made-up tree
states that reach its corners. Used by the tests and by chip_smoke.py,
never by a build.

The kernel departs from the plain version (`kclosest._score_edges_plain`)
in two places: it scores only the valid slots below `st.idx`, both sides
of an edge at once, and lets one candidate stand for the unused slots;
and it finds the first minimum by partial minima in an order that the
hardware picks. `score_edges_model` does the same in tensor code, over
any split of the slots into blocks and any order inside a block, so a
machine without a GPU can hold both to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from dipper_tpu_torch.placement.kclosest import (K, SENT_DIS, TreeState,
                                                 _side_vector, nan_minimum)


def _before(a, b) -> bool:
    """(score, slot, frac) a before b in the order of torch.argmin: NaN
    first, then the lower score, the lower slot at equal scores."""
    a_nan, b_nan = a[0] != a[0], b[0] != b[0]
    if a_nan != b_nan:
        return a_nan
    if a_nan or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def score_edges_model(st: TreeState, dist_row, block_of=None, order=None,
                      lo: int = 0, hi: int | None = None):
    """What csrc/score_edges.cu computes, its way, over the slots [lo, hi)
    (default: all). `block_of[s]` is the block that scores slot s <
    st.idx (default: one block); `order` is a permutation of the used
    slots of the range, the order in which candidates meet inside a block
    (default: ascending). Returns what `score_edges` returns."""
    n_used, E = st.idx, st.e.shape[0]
    hi = E if hi is None else hi
    end = max(lo, min(hi, n_used))
    dtype = st.length.dtype
    block_of = (np.zeros(n_used, dtype=np.int64) if block_of is None
                else np.asarray(block_of))
    order = np.arange(lo, end) if order is None else np.asarray(order)
    belong, dst = st.belong[:n_used], st.e[:n_used]
    slots = (belong > dst).nonzero().squeeze(1)       # valid slots only
    rev = st.rev[slots].long()
    L = st.length[slots]
    dis1 = _side_vector(st.cid[slots], st.cdis[slots], dist_row)
    dis2 = _side_vector(st.cid[rev], st.cdis[rev], dist_row)
    addi = ((dis1 + dis2 - L) * 0.5).clamp(min=0.0)
    dis1 = (dis1 - addi).clamp(min=0.0)
    dis2 = (dis2 - addi).clamp(min=0.0)
    addi = addi + (dis1 - L).clamp(min=0.0) + (dis2 - L).clamp(min=0.0)
    dis1 = nan_minimum(dis1, L)
    dis2 = nan_minimum(dis2, L)
    frac = dis1 + (L - dis1 - dis2) * 0.5
    score = torch.full((n_used,), SENT_DIS, dtype=dtype)
    fracs = torch.zeros((n_used,), dtype=dtype)
    score[slots] = addi
    fracs[slots] = frac

    identity = (torch.tensor(float("inf"), dtype=dtype), 2**31 - 1,
                torch.tensor(0.0, dtype=dtype))
    partial = {}
    for s in order.tolist():
        b = int(block_of[s])
        c = (score[s], s, fracs[s])
        if _before(c, partial.get(b, identity)):
            partial[b] = c
    best = identity
    for b in sorted(partial, reverse=True):  # any order gives the same
        if _before(partial[b], best):
            best = partial[b]
    # the range's first unused slot stands for its unused slots
    first_unused = max(lo, n_used)
    if first_unused < hi:
        unused = (torch.tensor(SENT_DIS, dtype=dtype), first_unused,
                  torch.tensor(0.0, dtype=dtype))
        if _before(unused, best):
            best = unused
    eid = best[1]
    return (eid, int(st.belong[eid]), int(st.e[eid]), int(st.rev[eid]),
            best[2], best[0])


def made_up_state(n_pairs: int, n_slots: int, cap: int, dtype: str, rng,
                  bare: bool = True) -> dict:
    """A state of 2 * n_pairs used slots out of n_slots as numpy arrays
    (the reference's field names): slots paired at random through `rev`,
    one direction of each pair valid, slot 0 invalid as in every real tree,
    witness lists with empty entries and, if `bare`, edges with no witness
    at all."""
    n_used = 2 * n_pairs
    assert n_used <= n_slots
    order = np.concatenate([[0], 1 + rng.permutation(n_used - 1)])
    first, second = order[0::2], order[1::2]          # slot 0 is a first
    nodes = rng.permutation(2 * n_pairs)
    lo = np.minimum(nodes[:n_pairs], nodes[n_pairs:])
    hi = np.maximum(nodes[:n_pairs], nodes[n_pairs:])
    belong = np.full(n_slots, -1, np.int32)
    e = np.full(n_slots, -1, np.int32)
    rev = np.full(n_slots, -1, np.int32)
    # the first slot of a pair is invalid (belong < e), the second valid
    belong[first], e[first], rev[first] = lo, hi, second
    belong[second], e[second], rev[second] = hi, lo, first
    cid = np.full((n_slots, K), -1, np.int32)
    cdis = np.full((n_slots, K), SENT_DIS, dtype)
    ids = rng.integers(0, cap, (n_used, K)).astype(np.int32)
    ids[:, 1:][rng.random((n_used, K - 1)) < 0.3] = -1
    if bare:
        ids[::7] = -1
    cid[:n_used] = ids
    cdis[:n_used] = np.sort(rng.random((n_used, K)) * 0.5, axis=1)
    length = np.zeros(n_slots, dtype)
    half = (rng.random(n_pairs) * 0.3).astype(dtype)
    length[first] = half
    length[second] = half
    return {"e": e, "belong": belong, "length": length, "rev": rev,
            "cdis": cdis, "cid": cid, "idx": np.int32(n_used)}


def made_up_cases(dtype: str, seed: int = 0):
    """(name, state arrays, distance row, expected) of the scorer's corner
    cases; `expected` holds the outputs that the case was made to give
    (a subset of eid, x, frac, add; add None for NaN)."""
    rng = np.random.default_rng(seed)
    cap = 97

    def row(shift=0.0):
        return (rng.random(cap) + shift).astype(dtype)

    cases = []
    for name, pairs, slots in (("random_full", 150, 300),
                               ("random_unused_tail", 150, 512),
                               ("one_warp_ragged", 13, 40),
                               ("four_edges", 2, 4),
                               ("four_edges_unused_tail", 2, 8)):
        cases.append((name, made_up_state(pairs, slots, cap, dtype, rng),
                      row(), {}))
    # two valid edges with the same lists and lengths on both sides, whose
    # witnesses alone are near the new taxon: they tie for the minimum, and
    # the lower slot wins
    for name, slots in (("tie", 200), ("tie_unused_tail", 256)):
        d = made_up_state(100, slots, cap, dtype, rng, bare=False)
        a, b = np.flatnonzero(d["belong"] > d["e"])[[5, 60]]
        near = 90 + np.arange(K, dtype=np.int32)
        d["cid"][d["cid"] >= 90] = 0
        for s in (a, b, d["rev"][a], d["rev"][b]):
            d["cid"][s] = near
        for s, t in ((a, b), (d["rev"][a], d["rev"][b])):
            d["cdis"][t] = d["cdis"][s]
            d["length"][t] = d["length"][s]
        r = row(shift=5.0)
        r[near] = 0.75
        cases.append((name, d, r, {"eid": int(a)}))
    # every valid score above 2.0: slot 0 (invalid, score 2.0) wins
    for name, slots in (("all_above_2", 200),
                        ("all_above_2_unused_tail", 333)):
        cases.append((name, made_up_state(100, slots, cap, dtype, rng,
                                          bare=False),
                      row(shift=9.0), {"eid": 0, "frac": 0.0, "add": 2.0}))
    # every used slot valid (a state no tree has) and above 2.0: the
    # candidate that stands for the unused slots wins
    d = made_up_state(40, 100, cap, dtype, rng, bare=False)
    inv = np.flatnonzero(d["belong"][:80] <= d["e"][:80])
    d["belong"][inv] = d["e"][inv] + 1
    cases.append(("unused_candidate_wins", d, row(shift=9.0),
                  {"eid": 80, "x": -1, "frac": 0.0, "add": 2.0}))
    for name, nan_at, inf_at in (("nan_in_row", [3, 50], []),
                                 ("inf_in_row", [], [7, 8, 64]),
                                 ("nan_and_inf_in_row", [11], [5, 70])):
        r = row()
        r[nan_at] = np.nan
        r[inf_at] = np.inf
        cases.append((name, made_up_state(120, 256, cap, dtype, rng), r,
                      {"add": None}))
    return cases


def meets(expected: dict, got) -> bool:
    """Whether score_edges' six values `got` are what a made-up case was
    made to give."""
    eid, x, _, _, frac, add = got
    for key, value in (("eid", eid), ("x", x), ("frac", float(frac)),
                       ("add", float(add))):
        if key in expected:
            want = expected[key]
            if not (value != value if want is None else value == want):
                return False
    return True
