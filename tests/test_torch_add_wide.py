"""Multifurcating --add backbones on the port's wide out-edge table, on the
CPU against dipper_tpu's run_add_queries(use_adj=False) and its dense
witness BFS:
- kclosest.wide_adjacency_from_edges recovers every node's out-edges
  from api.backbone_tree_to_arrays' output, and insert_cuda.check_arrays
  refuses a malformed table;
- placement/insert_model.py's wide plan (csrc/insert_step.cu's wide
  instantiation) seeds a backbone and places queries on it to JAX's
  state bit for bit, in f32 and f64, at the kernel's plan and at a small
  one (cap, threads, narrow) whose spills, hand-overs to the block and
  switches between narrow and wide levels `stats` counts;
- run_add_queries on the card's route, with the model in the kernels'
  place (tests/test_torch_insert.py's model_as_kernel): a wide state
  seeds by one range launch a chunk (closest_bfs_range) and places
  queries by the cursor route, counted as the wide instantiation's
  launches, to JAX's arrays;
- the range kernel's plan (insert_model.range_plan: what of the wide
  table is staged in shared memory, the frontier's and the wide list's
  capacities) fits its budget, and insert_model.bfs_range at capacities
  of 32, 256 and one past the widest level seeds to JAX's state.
Backbones: MULTI (degrees 4 and 5), a star of degree 45, eight clades
of four leaves under one root (levels of seven wide entries), and binary
backbones placed by the JAX package from 3 seeds, collapsed at 2
quantiles by chip_smoke.collapse_backbone (a clade of at least 12 leaves
made one node). Tolerance: none, floats compared by their bits."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import collapse_backbone
from dipper_tpu.placement import kclosest as jk
from dipper_tpu_torch.io.newick import parse_newick
from dipper_tpu_torch.placement import api as tapi
from dipper_tpu_torch.placement import insert_cuda
from dipper_tpu_torch.placement import insert_model as im
from dipper_tpu_torch.placement import kclosest as tk

from test_nj import random_additive_matrix
from test_torch_add import MULTI
from test_torch_insert import model_as_kernel  # noqa: F401  (a fixture)

torch.set_num_threads(2)

N = 56  # taxa: the backbone's, then queries
DTYPES = ["float64", "float32"]
# (cap, threads, narrow) of the model: the kernel's, and one that spills
# the frontier and the wide list and hands narrow levels to the block
PLANS = {"kernel": (im.CAP, im.THREADS, im.NARROW), "small": (2, 4, 3)}
STAR = "(" + ",".join(f"L{i}:{0.01 * (i % 7 + 1):.2f}"
                      for i in range(45)) + ");"
# eight clades of four leaves under a root of degree 8: a BFS level holds
# seven wide entries (the wide list spills at the small plan)
BROOMS = "(" + ",".join(
    "(" + ",".join(f"L{4 * c + j}:{0.02 + 0.01 * j:.2f}" for j in range(4))
    + f"):{0.05 + 0.01 * c:.2f}" for c in range(8)) + ");"


def _matrix(seed):
    D = random_additive_matrix(N, np.random.default_rng(seed))
    return D / (D.max() * 1.05)


def _collapsed(seed, quantile):
    """The JAX package's k-closest tree of the first 40 taxa of seed's
    matrix, collapsed."""
    B = 40
    D = _matrix(seed)
    e, belong, length = jax.device_get(jk.run_placement(
        (jnp.asarray(D[:B, :B]),), num_sequences=B, frontend="matrix",
        dtype_name="float64"))
    nwk = jk.edges_to_newick(e, belong, length, [f"L{i}" for i in range(B)],
                             B)
    return collapse_backbone(nwk, quantile, clade=12)[0]


BACKBONES = {"multi": lambda: MULTI, "star": lambda: STAR,
             "brooms": lambda: BROOMS,
             **{f"collapsed_s{seed}_q{int(q * 100)}":
                (lambda seed=seed, q=q: _collapsed(seed, q))
                for seed in (3, 7, 11) for q in (0.3, 0.7)}}
_cache: dict = {}


def _backbone(name):
    """(Newick, the tree, its [4N] edge arrays, the matrix in the tree's
    leaf order with queries after the backbone)."""
    if name not in _cache:
        nwk = BACKBONES[name]()
        tree = parse_newick(nwk, N)
        order = [int(nm[1:]) for nm in tree.leaf_names_in_idx_order()]
        order += [i for i in range(N) if i not in order]
        D = _matrix(sum(map(ord, name)))
        D = np.ascontiguousarray(D[np.ix_(order, order)])
        _cache[name] = (nwk, tree, tapi.backbone_tree_to_arrays(tree, N), D)
    return _cache[name]


def _state(name, dtype, wide_table=True):
    _, tree, arrays, _ = _backbone(name)
    return tk.add_state(*(torch.from_numpy(a) for a in arrays),
                        num_sequences=N, backbone_size=tree.num_leaves,
                        dtype_name=dtype, use_adj=False,
                        wide_table=wide_table)


def _jax_seeded(name, dtype):
    """JAX's state after the dense BFS from every backbone leaf."""
    _, tree, (e0, b0, l0, r0), _ = _backbone(name)
    B = tree.num_leaves
    js = jk.TreeState(
        e=jnp.asarray(e0), belong=jnp.asarray(b0),
        length=jnp.asarray(l0, jnp.dtype(dtype)), rev=jnp.asarray(r0),
        cdis=jnp.full((4 * N, 5), 2.0, jnp.dtype(dtype)),
        cid=jnp.full((4 * N, 5), -1, jnp.int32), idx=jnp.int32(4 * B - 4),
        adj=None, nfb=None)
    return jax.device_get(jax.jit(lambda s: jax.lax.fori_loop(
        0, B, lambda i, s: jk.update_closest_bfs(s, i, 2 * N), s))(js))


def _jax_add(name, dtype):
    _, tree, (e0, b0, l0, r0), D = _backbone(name)
    return [np.asarray(a) for a in jax.device_get(jk.run_add_queries(
        (jnp.asarray(D.astype(dtype)),), jnp.asarray(e0), jnp.asarray(b0),
        jnp.asarray(l0, jnp.dtype(dtype)), jnp.asarray(r0),
        num_sequences=N, backbone_size=tree.num_leaves, frontend="matrix",
        dtype_name=dtype, use_adj=False))]


@pytest.mark.parametrize("name", BACKBONES)
def test_wide_table_recovers_out_edges(name):
    """Every node's out-edges, ascending, from its row or its wide list;
    the rows of nodes of degree <= 3 are adjacency_from_edges's."""
    _, tree, (e0, belong0, _, _), _ = _backbone(name)
    b = torch.from_numpy(belong0)
    adj, off, eid = tk.wide_adjacency_from_edges(b, 2 * N)
    deg = np.bincount(belong0[belong0 >= 0], minlength=2 * N)
    assert deg.max() > 3 and off.numel() - 1 == int((deg > 3).sum())
    narrow_rows = tk.adjacency_from_edges(b, 2 * N)
    w = 0
    for node in range(2 * N):
        want = np.flatnonzero(belong0 == node).tolist()
        row = adj[node].tolist()
        if deg[node] > 3:
            assert row == [-2 - w, -1, -1]
            assert eid[off[w]:off[w + 1]].tolist() == want
            w += 1
        else:
            assert [x for x in row if x >= 0] == want
            assert row == narrow_rows[node].tolist()
    assert w == off.numel() - 1 and off[-1] == eid.numel()


def test_binary_backbone_takes_the_binary_table():
    """A tree whose degrees are all <= 3 gets adjacency_from_edges's
    table and no wide one."""
    belong = torch.tensor([0, 1, 4, 4, 4, 2, -1, -1], dtype=torch.int32)
    adj, off, eid = tk.wide_adjacency_from_edges(belong, 6)
    assert off is None and eid is None
    assert torch.equal(adj, tk.adjacency_from_edges(belong, 6))


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", BACKBONES)
def test_model_seeding_equals_jax_dense_bfs(name, dtype, plan):
    """The model's wide BFS from every backbone leaf, and the port's
    dense BFS (the plain version), each equal to JAX's dense seeding."""
    cap, threads, narrow = PLANS[plan]
    st = _state(name, dtype)
    plain = _state(name, dtype, wide_table=False)
    s = im.arrays_of(st)
    B = _backbone(name)[1].num_leaves
    for i in range(B):
        im.bfs(s, i, i, cap=cap, threads=threads, narrow=narrow)
        tk.update_closest_bfs(plain, i, 2 * N)
    want = _jax_seeded(name, dtype)
    for f in ("e", "belong", "length", "rev", "cdis", "cid"):
        w = np.asarray(getattr(want, f))
        assert s[f].tobytes() == w.tobytes(), f
        assert getattr(plain, f).numpy().tobytes() == w.tobytes(), f


def test_small_plan_reaches_every_corner():
    """At the small plan the wide plan spills the frontier and the wide
    list, hands levels of few slots but many wide pairs to the block, and
    switches between narrow and wide levels; at the kernel's plan a star
    hands its centre's level to the block."""
    stats, kstats = {}, {}
    for name in ("star", "brooms", "collapsed_s3_q70", "collapsed_s7_q30"):
        B = _backbone(name)[1].num_leaves
        for plan, acc in (("small", stats), ("kernel", kstats)):
            s = im.arrays_of(_state(name, "float64"))
            cap, threads, narrow = PLANS[plan]
            for i in range(B):
                im.bfs(s, i, i, cap=cap, threads=threads, narrow=narrow,
                       stats=acc)
    for key in ("spilled", "wide_listed_spilled", "handed_to_block",
                "switches", "wide_entries", "narrow_levels", "wide_levels"):
        assert stats.get(key, 0) > 0, key
    assert kstats.get("handed_to_block", 0) > 0
    assert kstats["wide_pairs"] == stats["wide_pairs"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", BACKBONES)
def test_model_add_sequence_equals_jax(name, dtype):
    """--add by the model at the small plan: the BFS alone from every
    backbone leaf, then each query's splice and walk (insert_step) on the
    plain scorer's choice; the final (e, belong, length) and the dense
    tensor route's equal JAX's run_add_queries(use_adj=False)."""
    _, tree, arrays, D = _backbone(name)
    B = tree.num_leaves
    cap, threads, narrow = PLANS["small"]
    st = _state(name, dtype)
    s = im.arrays_of(st)
    for i in range(B):
        im.bfs(s, i, i, cap=cap, threads=threads, narrow=narrow)
    Dt = torch.from_numpy(D.astype(dtype))
    for i in range(B, N):
        eid, _, _, _, frac, add = tk._score_edges_plain(st, Dt[i])
        im.insert_step(s, eid, frac.numpy(), add.numpy(), st.idx, i + N - 1,
                       i, i, cap=cap, threads=threads, narrow=narrow)
        st.idx += 4
    plain = tk.run_add_queries(
        (Dt,), *(torch.from_numpy(a) for a in arrays), num_sequences=N,
        backbone_size=B, frontend="matrix",
        dtype_name=dtype, use_adj=False)
    want = _jax_add(name, dtype)
    for f, p, w in zip(("e", "belong", "length"), plain, want):
        assert s[f].tobytes() == w.tobytes(), f
        assert p.numpy().tobytes() == w.tobytes(), f


@pytest.mark.parametrize("G", [5, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["star", "collapsed_s11_q30"])
def test_run_add_queries_routes_wide_states_to_the_kernel(
        model_as_kernel, monkeypatch, name, dtype, G):
    """run_add_queries with the wide table on the card's route: one cursor
    write and one closest_bfs_range launch for the seeding (no BFS-alone
    launch, no graph), the queries by the cursor route ((N - B) // G
    replays), every launch in the wide instantiation's counters and none
    in the binary one's; JAX's arrays."""
    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", G)
    _, tree, arrays, D = _backbone(name)
    B = tree.num_leaves
    route = model_as_kernel
    names = ("INSERT_STEP_LAUNCHES", "CLOSEST_BFS_LAUNCHES",
             "INSERT_STEP_WIDE_LAUNCHES", "CLOSEST_BFS_WIDE_LAUNCHES",
             "CLOSEST_BFS_RANGE_WIDE_LAUNCHES", "GRAPH_REPLAYS")
    monkeypatch.setattr(tk, "add_state",
                        functools.partial(tk.add_state, wide_table=True))
    before = [getattr(insert_cuda, k) for k in names]
    got = tk.run_add_queries(
        (torch.from_numpy(D.astype(dtype)),),
        *(torch.from_numpy(a) for a in arrays), num_sequences=N,
        backbone_size=B, frontend="matrix", dtype_name=dtype, use_adj=False)
    counts = [getattr(insert_cuda, k) - b for k, b in zip(names, before)]
    assert counts == [0, 0, N - B, 0, 1, (N - B) // G]
    assert route.leaves == [] and [r[:2] for r in route.ranges] == [(0, B)]
    assert route.steps == [(i, 4 * i - 4) for i in range(B, N)]
    for g, w in zip(got, _jax_add(name, dtype)):
        assert g.numpy().tobytes() == w.tobytes()


def test_check_arrays_refuses_a_malformed_wide_table():
    import dataclasses

    st = _state("star", "float32")
    insert_cuda.check_arrays(st)
    bad = {"wide_off": st.wide_off + 1,
           "wide_eid": torch.full_like(st.wide_eid, 4 * N),
           "adj": torch.where(st.adj == -2, -3, st.adj)}
    for field, value in bad.items():
        with pytest.raises(ValueError, match="wide table is malformed"):
            insert_cuda.check_arrays(dataclasses.replace(st,
                                                         **{field: value}))
    with pytest.raises(ValueError, match="come together"):
        insert_cuda.check_arrays(dataclasses.replace(st, wide_eid=None))
    with pytest.raises(ValueError, match="wide_off must be a torch.int32"):
        insert_cuda.check_arrays(dataclasses.replace(
            st, wide_off=st.wide_off.long()))


# ---------------------------------------------------------------------------
# The seeding range: insert_model's plan of closest_bfs_range
# ---------------------------------------------------------------------------

RANGE_NAMES = ["multi", "star"] + [n for n in BACKBONES
                                   if n.startswith("collapsed")]
# the frontier's and the wide list's capacities (None: one past the
# widest level)
RANGE_CAPS = {"cap32": 32, "cap256": 256, "past_widest": None}
_seeded: dict = {}


def _jax_seeded_arrays(name, dtype):
    if (name, dtype) not in _seeded:
        want = _jax_seeded(name, dtype)
        _seeded[name, dtype] = {f: np.asarray(getattr(want, f)) for f in
                                ("e", "belong", "length", "rev", "cdis",
                                 "cid")}
    return _seeded[name, dtype]


def _widest(name):
    """The widest level of the wide plan's seeding of the backbone."""
    s = im.arrays_of(_state(name, "float64"))
    levels = []
    for i in range(_backbone(name)[1].num_leaves):
        im.bfs(s, i, i, levels=levels)
    return max(levels)


@pytest.mark.parametrize("caps", RANGE_CAPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", RANGE_NAMES)
def test_model_range_seeding_equals_jax(name, dtype, caps):
    """insert_model.bfs_range, the range kernel's plan, seeds the backbone
    in two launches (the cursor carried from one to the next) at a
    frontier and a wide list of 32 entries, of 256, and of one past the
    widest level (each at most the M nodes), with the table staged as
    range_plan stages it: JAX's dense seeding, bit for bit."""
    cap = RANGE_CAPS[caps]
    cap = _widest(name) + 1 if cap is None else cap
    st = _state(name, dtype)
    plan = im.range_plan(im.SMEM_OPTIN, st.adj.shape[0], st.wide_off.numel(),
                         st.wide_eid.numel(), st.length.element_size(),
                         cap=cap, list_cap=cap)
    cap = min(cap, st.adj.shape[0])  # no level holds more than M entries
    assert (plan["cap"], plan["list_cap"]) == (cap, cap)
    s = im.arrays_of(st)
    B = _backbone(name)[1].num_leaves
    stats = {}
    i = im.bfs_range(s, 0, B // 2, plan, stats=stats)
    assert im.bfs_range(s, i, B - i, plan, stats=stats) == B
    want = _jax_seeded_arrays(name, dtype)
    for f in want:
        assert s[f].tobytes() == want[f].tobytes(), f
    if caps == "cap32" and name == "star":
        assert stats["spilled"] > 0 and stats["wide_listed_spilled"] == 0
    if caps == "past_widest":
        assert stats.get("spilled", 0) == 0


def test_range_plan_divides_the_budget():
    """range_plan stages the offsets, then the out-edges, where each fits
    beside a frontier and a list of CAP entries; gives the rest to the
    frontier and the list alike (at most the nodes); honours forced parts;
    fits its budget to the byte (range_bytes, the kernel's formula) and
    refuses forced parts that do not fit."""
    assert im.range_bytes(4, 3, 5, 7, 9) == 32 + 2 * 32 + 3 * 32 + 32 + 48
    budget, M = 232448 - 200, 60000
    for item in (4, 8):
        for n_eid in (0, 26000, 120000):
            p = im.range_plan(budget, M, 5537, n_eid, item)
            assert p["bytes"] <= budget and p["cap"] == p["list_cap"]
            assert p["n_off"] == 5537
            assert p["n_eid"] == (n_eid if 0 < n_eid < 50000 else 0)
            more = p["cap"] + 1
            assert im.range_bytes(item, more, more, p["n_off"],
                                  p["n_eid"]) > budget - 6 * 16
    p = im.range_plan(budget, 100, 9, 40, 8)
    assert (p["cap"], p["list_cap"], p["n_off"], p["n_eid"]) == (100, 100, 9,
                                                                  40)
    p = im.range_plan(budget, M, 5537, 26000, 4, cap=32, list_cap=32,
                      stage_eid=False)
    assert (p["cap"], p["list_cap"], p["n_eid"]) == (32, 32, 0)
    p = im.range_plan(12000, M, 5537, 26000, 4)
    assert p["n_off"] == 0 and p["n_eid"] == 0 and p["cap"] >= im.CAP
    p = im.range_plan(budget, M, 5537, 26000, 4, cap=1000)
    assert p["cap"] == 1000 and p["bytes"] <= budget
    assert p["list_cap"] > 1000
    with pytest.raises(ValueError, match="bytes of shared memory"):
        im.range_plan(budget, M, 5537, 26000, 4, cap=20000)


@pytest.mark.parametrize("chunk", [7, 1 << 16])
@pytest.mark.parametrize("name", ["star", "collapsed_s3_q70"])
def test_replay_seeding_makes_one_range_launch_a_chunk(
        model_as_kernel, monkeypatch, name, chunk):
    """_replay_seeding of a wide state on the card's route (the model in
    the kernel's place): one closest_bfs_range launch a chunk of
    RANGE_LEAVES leaves, the cursor at hi after it, no graph captured and
    no BFS-alone launch; JAX's seeding. The per-leaf cursor route, kept
    as the yardstick (_seed_by_cursor), gives the same state."""
    monkeypatch.setattr(tk, "RANGE_LEAVES", chunk)
    route = model_as_kernel
    st = _state(name, "float32")
    B = _backbone(name)[1].num_leaves
    names = ("CLOSEST_BFS_RANGE_WIDE_LAUNCHES", "CLOSEST_BFS_WIDE_LAUNCHES",
             "CLOSEST_BFS_LAUNCHES", "GRAPH_CAPTURES")
    before = [getattr(insert_cuda, k) for k in names]
    tk._replay_seeding(st, 0, B)
    counts = [getattr(insert_cuda, k) - b for k, b in zip(names, before)]
    n_chunks = -(-B // chunk)
    assert counts == [n_chunks, 0, 0, 0] and route.captures == 0
    assert [r[:2] for r in route.ranges] == [
        (c, min(chunk, B - c)) for c in range(0, B, chunk)]
    assert route.cursor[id(st)][0] == B
    want = _jax_seeded_arrays(name, "float32")
    yard = _state(name, "float32")
    tk._seed_by_cursor(yard, 0, B)
    assert route.leaves == list(range(B))
    for f in want:
        assert getattr(st, f).numpy().tobytes() == want[f].tobytes(), f
        assert getattr(yard, f).numpy().tobytes() == want[f].tobytes(), f
