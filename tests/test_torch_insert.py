"""The insertion-step kernel's plan on the CPU: placement/insert_model.py
(a numpy model of csrc/insert_step.cu: the warp's splice with its stable
NaN-last rank of ten, the BFS's first level written with it, narrow levels
by one warp's ballot and wide ones in chunks with scan compaction, the
frontier's shared buffers and their spill, the blocked slot) against the
port's tensor code (kclosest.splice + _update_closest_bfs_compact, the
kernel's plain version) and both against the JAX package (splice +
update_closest_bfs, _cluster_build_stream).

Tolerance: none. Every state array is compared bit for bit (floats by
their bits, so NaN payloads and signs count), in f32 and f64.

The tests that drive the routing (`_insert_range`'s cursor route with
its captured graphs, `run_add_queries`, `build_streamed` as they run on
the card) put the model in the kernels' place on CPU tensors: a capture
records the launches without running them, a replay runs them, and each
launch reads the range's cursor when it runs. The kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dipper_tpu.dc.pipeline as jpl
from dipper_tpu.placement import kclosest as jk
from dipper_tpu.utils.params import Param as JaxParam
from dipper_tpu_torch.dc import cluster as tc
from dipper_tpu_torch.dc import cluster_cuda
from dipper_tpu_torch.dc import cluster_model as cm
from dipper_tpu_torch.io.newick import parse_newick
from dipper_tpu_torch.placement import api as tapi
from dipper_tpu_torch.placement import insert_cuda
from dipper_tpu_torch.placement import insert_model as im
from dipper_tpu_torch.placement import kclosest as tk

from test_nj import random_additive_matrix

torch.set_num_threads(2)

SEVEN = im.FIELDS
DTYPES = ["float64", "float32"]
_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_INT[t.dtype]) if t.dtype in _INT else t


def _assert_same(a, b, fields=SEVEN, where=""):
    """Two TreeStates' arrays equal bit for bit, and their idx."""
    assert a.idx == b.idx, where
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, f)
        assert torch.equal(_bits(x), _bits(y)), (where, f)


def _assert_same_as_jax(js, st, fields=SEVEN):
    want = jax.device_get(js)
    assert int(want.idx) == st.idx
    for f in fields:
        a = np.asarray(getattr(want, f))
        b = getattr(st, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def _clone(st):
    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in SEVEN})


def _scale(D):
    return D / (D.max() * 1.05)


def _matrix(kind, n):
    rng = np.random.default_rng(n + 77)
    if kind == "additive":
        return _scale(random_additive_matrix(n, rng))
    if kind == "noisy":
        D = random_additive_matrix(n, rng) + rng.uniform(0, 0.05, (n, n))
        D = _scale((D + D.T) / 2)
        np.fill_diagonal(D, 0)
        return D
    if kind == "caterpillar":
        i = np.arange(n, dtype=np.float64)
        return _scale(np.abs(i[:, None] - i[None, :]))
    if kind == "all_nan":  # -d 3's tree of saturated pairs
        D = np.full((n, n), np.nan)
        np.fill_diagonal(D, 0)
        return D
    if kind == "some_nan":
        D = _scale(random_additive_matrix(n, rng))
        bad = rng.random((n, n)) < 0.15
        D[bad | bad.T] = np.nan
        np.fill_diagonal(D, 0)
        return D
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# placement builds: every insertion, model against tensor code
# ---------------------------------------------------------------------------


def _model_build(D, dtype, threads, check_each=None, stats=None, **plan):
    """The placement of D's taxa with every splice and BFS by the model
    (the scorer's plain version on the model's arrays, shared through
    numpy views). `check_each(i, st)` runs after each insertion; `plan`
    (cap, narrow) goes to the model, which adds up `stats`."""
    n = D.shape[0]
    Dt = torch.from_numpy(D.astype(dtype))
    st = tk.init_state(n, getattr(torch, dtype), torch.device("cpu"))
    tk.build_initial_tree(st, Dt[1, 0], n)
    s = im.arrays_of(st)
    im.closest_bfs(s, 0, threads=threads, stats=stats, **plan)
    im.closest_bfs(s, 1, threads=threads, stats=stats, **plan)
    if check_each:
        check_each(1, st)
    for i in range(2, n):
        eid, _, _, _, frac, add = tk._score_edges_plain(st, Dt[i])
        xy = im.insert_step(s, eid, frac.numpy(), add.numpy(), st.idx,
                            i + n - 1, i, i, threads=threads, stats=stats,
                            **plan)
        assert xy[0] == eid
        st.idx += 4
        if check_each:
            check_each(i, st)
    return st


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind, n, threads", [
    ("additive", 40, 256), ("additive", 40, 2), ("noisy", 33, 256),
    ("noisy", 33, 5), ("caterpillar", 48, 256), ("all_nan", 12, 256),
    ("some_nan", 30, 3)])
def test_model_build_equals_tensor_code_and_jax(kind, n, threads, dtype):
    D = _matrix(kind, n)
    plain = tk.init_placement_state((torch.from_numpy(D.astype(dtype)),),
                                    num_sequences=n, frontend="matrix",
                                    dtype_name=dtype)
    Dt = torch.from_numpy(D.astype(dtype))

    def step_plain_and_compare(i, st):
        if i >= 2:
            tk.insertion_step(plain, Dt[i], i, n)
        _assert_same(st, plain, where=i)

    st = _model_build(D, dtype, threads, step_plain_and_compare)
    js = jk.run_placement_full((jnp.asarray(D.astype(dtype)),),
                               num_sequences=n, frontend="matrix",
                               dtype_name=dtype)
    _assert_same_as_jax(js, st)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind, n, threads, cap, narrow", [
    ("additive", 40, 256, 2, 6), ("noisy", 33, 4, 3, 9),
    ("caterpillar", 48, 256, 1, 3), ("some_nan", 30, 5, 2, 6),
    ("all_nan", 12, 2, 1, 3)])
def test_model_small_capacity_equals_tensor_code_and_jax(
        kind, n, threads, cap, narrow, dtype):
    """The model with frontier buffers of a few entries and narrow levels
    of a few pairs, so that frontiers spill to the scratch and levels
    switch between one warp and the block: every insertion equals the
    tensor code, and the build JAX's."""
    D = _matrix(kind, n)
    Dt = torch.from_numpy(D.astype(dtype))
    plain = tk.init_placement_state((Dt,), num_sequences=n,
                                    frontend="matrix", dtype_name=dtype)

    def step_plain_and_compare(i, st):
        if i >= 2:
            tk.insertion_step(plain, Dt[i], i, n)
        _assert_same(st, plain, where=i)

    stats = {}
    st = _model_build(D, dtype, threads, step_plain_and_compare, stats,
                      cap=cap, narrow=narrow)
    assert stats["spilled"] > 0 and stats["switches"] > 0
    assert stats["narrow_levels"] > 0 and stats["wide_levels"] > 0
    js = jk.run_placement_full((jnp.asarray(D.astype(dtype)),),
                               num_sequences=n, frontend="matrix",
                               dtype_name=dtype)
    _assert_same_as_jax(js, st)


# ---------------------------------------------------------------------------
# the ten-way merge of a splice: ties, sentinels, NaN
# ---------------------------------------------------------------------------


def _splice_state(cd_x, id_x, cd_y, id_y, orig, dtype):
    """Four slots of a two-taxon tree (N = 4, room for one splice) with
    the given lists on edge 0 and its reverse, edge 2."""
    n = 4
    st = tk.init_state(n, getattr(torch, dtype), torch.device("cpu"))
    tk.build_initial_tree(st, torch.tensor(2 * orig, dtype=st.length.dtype),
                          n)
    st.cdis[0] = torch.tensor(cd_x, dtype=st.cdis.dtype)
    st.cid[0] = torch.tensor(id_x, dtype=torch.int32)
    st.cdis[2] = torch.tensor(cd_y, dtype=st.cdis.dtype)
    st.cid[2] = torch.tensor(id_y, dtype=torch.int32)
    return st


def _jax_state(st):
    # copies: on the CPU jnp.asarray may share the numpy buffer, which the
    # model then writes
    return jk.TreeState(**{f: jnp.asarray(getattr(st, f).numpy().copy())
                           for f in SEVEN}, idx=jnp.int32(st.idx),
                        nfb=jnp.int32(0))


SPLICE_CASES = im.SPLICE_CASES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(SPLICE_CASES))
def test_model_splice_merge_equals_tensor_code_and_jax(case, dtype):
    cd_x, id_x, cd_y, id_y, orig, frac = SPLICE_CASES[case]
    st = _splice_state(cd_x, id_x, cd_y, id_y, orig, dtype)
    js = _jax_state(st)
    plain = _clone(st)
    f = torch.tensor(frac, dtype=st.length.dtype)
    a = torch.tensor(im.SPLICE_ADD, dtype=st.length.dtype)
    tk.splice(plain, 0, f, a, 2, 4)
    assert im.splice(im.arrays_of(st), 0, f.numpy(), a.numpy(), st.idx,
                     2 + 4 - 1, 2) == (0, 2)
    st.idx += 4
    _assert_same(st, plain, where=case)
    js = jk.splice(js, jnp.int32(0), jnp.asarray(f.numpy()),
                   jnp.asarray(a.numpy()), 2, 4)
    _assert_same_as_jax(js, st)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_overlapping_splice_equals_tensor_code(dtype):
    """A choice whose writes overlap (insert_model.overlap_state: an
    unused slot, its reverse -1 read as the last slot, the new slots the
    last four): where two of the plain version's statements write one
    address the later one wins, in the model's warp splice as in the
    tensor code; then the BFS over the malformed tree."""
    d, eid, frac, add, middle, outside = im.overlap_state(dtype)
    st = tk.tree_state_from_numpy(d, "cpu")
    plain = _clone(st)
    n = st.adj.shape[0] // 2
    tk.splice(plain, eid, torch.tensor(frac), torch.tensor(add), outside,
              n, middle=middle, outside=outside)
    tk._update_closest_bfs_compact(plain, outside, 2 * n)
    assert im.insert_step(im.arrays_of(st), eid, frac, add, st.idx, middle,
                          outside, outside) == (eid, st.e.shape[0] - 1)
    st.idx += 4
    _assert_same(st, plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_keys_order_as_torch_sorts(dtype):
    """The kernel's sort keys compare as its `before` does on every pair
    of a pool of corner values: signed zeros, infinities, NaN, the
    smallest subnormal, negative values."""
    f = np.finfo(dtype)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0,
                     2.0, 0.25, -0.25, f.tiny, -f.tiny, f.smallest_subnormal,
                     -f.smallest_subnormal, f.max, -f.max], dtype)
    for a in pool:
        for b in pool:
            assert (im.sort_key(a) < im.sort_key(b)) == im._before(a, b), \
                (a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_ranks_with_zeros_and_infinities_equal_stable_argsort(dtype):
    """The ranks from the sort keys against torch's and JAX's stable
    argsort where signed zeros tie and infinities bound the numbers."""
    rng = np.random.default_rng(6)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -0.5, 0.5, 2.0],
                    dtype)
    for _ in range(200):
        v = rng.choice(pool, 10)
        order = np.argsort(im.merge_ranks(list(v)))
        want_t = torch.argsort(torch.from_numpy(v), stable=True).numpy()
        want_j = np.asarray(jnp.argsort(jnp.asarray(v), stable=True))
        assert np.array_equal(order, want_t) and np.array_equal(order, want_j)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_ranks_equal_stable_argsort(dtype):
    """The kernel's rank of ten values against torch's and JAX's stable
    argsort on lists drawn from a few values, NaN and 2.0 among them."""
    rng = np.random.default_rng(5)
    pool = np.array([0.0, 0.25, 0.25, 0.5, 2.0, np.nan], dtype)
    for _ in range(200):
        v = rng.choice(pool, 10)
        ranks = im.merge_ranks(list(v))
        assert sorted(ranks) == list(range(10))
        order = np.argsort(ranks)
        want_t = torch.argsort(torch.from_numpy(v), stable=True).numpy()
        want_j = np.asarray(jnp.argsort(jnp.asarray(v), stable=True))
        assert np.array_equal(order, want_t) and np.array_equal(order, want_j)


# ---------------------------------------------------------------------------
# seeding a backbone (--add): the BFS alone from every leaf
# ---------------------------------------------------------------------------


def _backbone_state(nwk, n, dtype):
    tree = parse_newick(nwk, n)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    B = len(tree.leaf_names_in_idx_order())
    dt = getattr(torch, dtype)
    st = tk.TreeState(
        e=torch.from_numpy(e0), belong=torch.from_numpy(belong0),
        length=torch.from_numpy(length0).to(dt), rev=torch.from_numpy(rev0),
        cdis=torch.full((4 * n, tk.K), tk.SENT_DIS, dtype=dt),
        cid=torch.full((4 * n, tk.K), -1, dtype=torch.int32),
        idx=4 * B - 4,
        adj=tk.adjacency_from_edges(torch.from_numpy(belong0), 2 * n))
    return st, B


def _jax_seed(js, B, n):
    return jax.jit(lambda s: jax.lax.fori_loop(
        0, B, lambda i, s: jk.update_closest_bfs(s, i, 2 * n), s))(js)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_seeding_wide_backbone_equals_tensor_code_and_jax(dtype):
    """A balanced 1,024-leaf backbone: levels of the first BFSs are
    wider than the kernel's 256 threads, so a level takes several chunks
    and the compaction carries its offset across them."""
    n = B = 1024
    st, _ = _backbone_state(im.balanced_newick(B, np.random.default_rng(3)),
                            n, dtype)
    plain = _clone(st)
    js = _jax_state(st)
    s = im.arrays_of(st)
    widest = 0
    stats = {}
    for i in range(B):
        levels = []
        im.bfs(s, i, i, levels=levels, stats=stats)
        widest = max(widest, max(levels))
        tk._update_closest_bfs_compact(plain, i, 2 * n)
    assert 3 * widest > im.THREADS and widest > im.CAP
    assert stats["spilled"] > 0 and stats["switches"] > 0
    _assert_same(st, plain)
    _assert_same_as_jax(_jax_seed(js, B, n), st, SEVEN[:-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_seeding_placement_backbone_equals_tensor_code_and_jax(dtype):
    """--add's seeding of a backbone that the JAX package placed."""
    n, B = 40, 30
    D = _matrix("noisy", n)
    e, belong, length = jax.device_get(jk.run_placement(
        (jnp.asarray(D[:B, :B]),), num_sequences=B, frontend="matrix",
        dtype_name="float64"))
    nwk = jk.edges_to_newick(e, belong, length,
                             [f"L{i}" for i in range(B)], B)
    st, got_B = _backbone_state(nwk, n, dtype)
    assert got_B == B
    plain = _clone(st)
    js = _jax_state(st)
    s = im.arrays_of(st)
    for i in range(B):
        im.closest_bfs(s, i, threads=4)
        tk.update_closest_bfs(plain, i, 2 * n)
    _assert_same(st, plain)
    _assert_same_as_jax(_jax_seed(js, B, n), st, SEVEN[:-1])


# ---------------------------------------------------------------------------
# the routing as it runs on the card, with the model in the kernel's place
# ---------------------------------------------------------------------------


def _fake_insert_step(st, eid, frac, add, *, middle, outside, label,
                      stream=None):
    """insert_cuda.insert_step's contract, computed by the model."""
    for t, want in ((eid, torch.int32), (frac, st.length.dtype),
                    (add, st.length.dtype)):
        assert t.dtype == want and t.numel() == 1
    xy = im.insert_step(im.arrays_of(st), int(eid.reshape(())),
                        frac.reshape(()).numpy(), add.reshape(()).numpy(),
                        st.idx, middle, outside, label)
    st.idx += 4
    return torch.tensor(xy, dtype=torch.int32)


def _fake_closest_bfs(st, leaf, label=None, blocked=None, stream=None):
    im.closest_bfs(im.arrays_of(st), leaf, label,
                   () if blocked is None else blocked.tolist())


def _fake_score_edges_launch(st, row, stream=None, lo=0, hi=None):
    eid, _, _, _, frac, add = tk._score_edges_plain(st, row)
    return types.SimpleNamespace(eid=torch.tensor(eid, dtype=torch.int32),
                                 frac=frac, add=add)


class _CursorRoute:
    """The cursor route's entry points on CPU states, the models and the
    scorer's plain version computing what the kernels would: each state's
    cursor (i, slots in use, rows, lo) and scorer outputs live here; a
    launch runs at once, or, inside a capture, is recorded and runs at
    each replay, reading the cursor then. D&C's streamed clusters take
    dc/cluster_model.py's row-block plan (kernel 8a) in the kernel's
    place, a wide state's seeding ranges insert_model.bfs_range (the range
    kernel's plan at its default budget)."""

    def __init__(self):
        self.cursor, self.out, self.graphs = {}, {}, {}
        self.recording = None
        self.captures = 0
        self.steps = []   # (i, i0) of each insert_step_cursor run
        self.leaves = []  # leaf of each closest_bfs_cursor run
        self.ranges = []  # (first leaf, leaves, plan) of each range launch
        self.blocks = []  # (kq0, members) of each stream_block launch

    def _launch(self, fn):
        if self.recording is None:
            fn()
        else:
            self.recording.append(fn)

    def set_cursor(self, st, i, rows=None, lo=0, stream=None):
        self.cursor[id(st)] = [i, st.idx, rows, lo]

    def score(self, st, stream=None, count=True):
        out = self.out.setdefault(id(st), types.SimpleNamespace(
            out_i=torch.zeros(4, dtype=torch.int32),
            out_f=torch.zeros(2, dtype=st.length.dtype)))

        def run():
            i, _, rows, lo = self.cursor[id(st)]
            eid, x, y, ye, frac, add = tk._score_edges_plain(st, rows[i - lo])
            out.out_i[:] = torch.tensor([eid, x, y, ye], dtype=torch.int32)
            out.out_f[0], out.out_f[1] = frac, add
        self._launch(run)
        if count:
            tk.SCORE_EDGES_LAUNCHES += 1
        return out

    def stream_block(self, st, scoreable, rows, kq0, cmax, ctas=8,
                     stream=None):
        assert st.adj is not None and rows.dim() == 2
        out_i, out_f = cm.stream_block(im.arrays_of(st), scoreable.numpy(),
                                       rows.numpy(), kq0, cmax, ctas)
        self.blocks.append((kq0, rows.shape[0]))
        cluster_cuda.STREAM_BLOCK_LAUNCHES += 1
        return (torch.tensor(out_i, dtype=torch.int32),
                torch.tensor(out_f, dtype=st.length.dtype))

    def step(self, st, sc, *, offsets, block_slot=-1, stream=None,
             count=True):
        def run():
            cur = self.cursor[id(st)]
            i, i0 = cur[0], cur[1]
            im.insert_step_cursor(im.arrays_of(st), cur, sc.out_i.tolist(),
                                  (sc.out_f[0].numpy(), sc.out_f[1].numpy()),
                                  offsets, block_slot)
            self.steps.append((i, i0))
        self._launch(run)
        if count:
            insert_cuda.count_launches(st.wide_off is not None, steps=1)

    def bfs(self, st, stream=None, count=True):
        def run():
            cur = self.cursor[id(st)]
            im.closest_bfs(im.arrays_of(st), cur[0])
            self.leaves.append(cur[0])
            cur[0] += 1
        self._launch(run)
        if count:
            insert_cuda.count_launches(st.wide_off is not None, bfs=1)

    def bfs_range(self, st, n, plan=None, stamps=None, stream=None):
        assert st.wide_off is not None and self.recording is None
        if plan is None:
            plan = im.range_plan(im.SMEM_OPTIN, st.adj.shape[0],
                                 st.wide_off.numel(), st.wide_eid.numel(),
                                 st.length.element_size())
        cur = self.cursor[id(st)]
        self.ranges.append((cur[0], n, plan))
        cur[0] = im.bfs_range(im.arrays_of(st), cur[0], n, plan)
        insert_cuda.count_launches(True, ranges=1)

    def range_graph(self, st, key, launch, steps=0, bfs=0, keep=()):
        k = (id(st), key)
        if k not in self.graphs:
            self.recording = []
            try:
                launch(None)
                runs = self.recording
            finally:
                self.recording = None
            assert len(runs) == 2 * steps + bfs
            graph = types.SimpleNamespace(
                replay=lambda: [fn() for fn in runs])
            # the state is held so that its id is not reused
            self.graphs[k] = (st, types.SimpleNamespace(
                graph=graph, steps=steps, bfs=bfs,
                wide=st.wide_off is not None, keep=keep))
            self.captures += 1
        return self.graphs[k][1]


@pytest.fixture
def model_as_kernel(monkeypatch):
    """CPU states with an adjacency table take the card's route, with the
    model in the kernel's place; returns the cursor route's stand-in."""
    route = _CursorRoute()
    monkeypatch.setattr(tk, "uses_insert_kernel",
                        lambda st: st.adj is not None)
    monkeypatch.setattr(insert_cuda, "insert_step", _fake_insert_step)
    monkeypatch.setattr(insert_cuda, "closest_bfs", _fake_closest_bfs)
    monkeypatch.setattr(tk, "score_edges_launch", _fake_score_edges_launch)
    monkeypatch.setattr(insert_cuda, "set_cursor", route.set_cursor)
    monkeypatch.setattr(tk, "score_edges_cursor_launch", route.score)
    monkeypatch.setattr(insert_cuda, "insert_step_cursor", route.step)
    monkeypatch.setattr(insert_cuda, "closest_bfs_cursor", route.bfs)
    monkeypatch.setattr(insert_cuda, "closest_bfs_range", route.bfs_range)
    monkeypatch.setattr(insert_cuda, "range_graph", route.range_graph)
    monkeypatch.setattr(cluster_cuda, "stream_block", route.stream_block)
    monkeypatch.setattr(cluster_cuda, "upload_sizes",
                        lambda sizes, device: torch.from_numpy(
                            np.asarray(sizes, dtype=np.int32)))
    return route


def _jax_stream_cluster(Dq, cd, cid, lens, sz, cmax, dtype):
    """dipper_tpu's _cluster_build_stream (matrix frontend) of one
    cluster whose member k's row to witness w is Dq[k, w]."""
    W = Dq.shape[1]
    Dm = np.zeros((W + cmax, W + cmax), dtype)
    Dm[W:, :W] = Dq
    payloads = (jnp.asarray(Dm), jnp.arange(W, dtype=jnp.int32),
                jnp.arange(W, W + cmax, dtype=jnp.int32))
    out = jpl._cluster_build_stream(
        "matrix", JaxParam(), dtype, payloads, jnp.asarray(cd),
        jnp.asarray(cid), jnp.asarray(lens), sz, cmax=cmax)
    return [np.asarray(x) for x in jax.device_get(out)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cmax, sz, row_block", [(21, 19, 4), (40, 40, 7)])
def test_streamed_cluster_model_equals_tensor_code_and_jax(
        monkeypatch, cmax, sz, row_block, dtype):
    """D&C's streamed cluster: label 10 + kq, middle 2 + cmax + kq, the
    cluster edge's endpoints (slot 0 after the splice) blocked, scoreable
    set after the splice. The card's route (one kernel-8a launch a row
    block, the last one ragged) with the model as the kernel, the plain
    route, and JAX's streamed build."""
    rng = np.random.default_rng(cmax)
    W = 10 + cmax
    Dq = rng.uniform(0.05, 0.6, (cmax, W)).astype(dtype)
    cd = np.sort(rng.uniform(0, 0.3, (2, 5)), axis=-1).astype(dtype)
    cid = np.arange(10, dtype=np.int32).reshape(2, 5)
    cid[1, 3:], cd[1, 3:] = -1, 2.0
    lens = rng.uniform(0.01, 0.2, 2).astype(dtype)
    lens[1] = lens[0]
    states = {}
    orig_one = tc.one_cluster

    def keep(route):
        def one(*a):
            st, sc = orig_one(*a)
            states[route] = st
            return st, sc
        return one

    D = torch.from_numpy(Dq)
    args = (torch.from_numpy(cd), torch.from_numpy(cid),
            torch.from_numpy(lens), sz, cmax, row_block)
    monkeypatch.setattr(tc, "one_cluster", keep("plain"))
    plain = tc.build_streamed(lambda s: D[s:s + row_block], *args)
    with monkeypatch.context() as m:
        route = _CursorRoute()
        m.setattr(tc, "one_cluster", keep("model"))
        m.setattr(tk, "uses_insert_kernel", lambda st: st.adj is not None)
        m.setattr(cluster_cuda, "stream_block", route.stream_block)
        model = tc.build_streamed(lambda s: D[s:s + row_block], *args)
    assert route.blocks == [(kq0, min(row_block, sz - kq0))
                            for kq0 in range(0, sz, row_block)]
    assert states["model"].idx == 2 + 4 * sz
    _assert_same(states["model"], states["plain"])
    want = _jax_stream_cluster(Dq, cd, cid, lens, sz, cmax, dtype)
    for a, b, w in zip(model, plain, want):
        assert a.numpy().tobytes() == w.tobytes()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_insert_range_routes_to_the_kernel(model_as_kernel, monkeypatch,
                                           dtype):
    """_insert_range and init_placement_state on a state that takes the
    kernel: one cursor score and one cursor insert_step a taxon (28, fewer
    than a graph's insertions: all direct), the BFS alone twice at the
    start; the same state as the plain route and as JAX."""
    n = 30
    D = _matrix("noisy", n).astype(dtype)
    bfs_calls = []

    def bfs_counted(st, leaf, *a, **kw):
        bfs_calls.append(leaf)
        _fake_closest_bfs(st, leaf, *a, **kw)

    monkeypatch.setattr(insert_cuda, "closest_bfs", bfs_counted)
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=n,
                                 frontend="matrix", dtype_name=dtype)
    tk._insert_range(st, 2, n, torch.from_numpy(D)[2:], n)
    route = model_as_kernel
    assert bfs_calls == [0, 1]
    assert route.steps == [(i, 4 * i - 4) for i in range(2, n)]
    assert route.captures == 0 and st.idx == 4 * n - 4
    js = jk.run_placement_full((jnp.asarray(D),), num_sequences=n,
                               frontend="matrix", dtype_name=dtype)
    _assert_same_as_jax(js, st)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G, chunk, cap_min", [
    (5, 7, 8),     # 7 = 5 + 2 a range: a replay and a remainder; 3 caps
    (8, 3, 8),     # G > hi - lo: every range direct, no capture
    (4, 12, 16),   # 12 = 3 x 4: replays only; two caps
    (6, 40, 64)])  # one range, one cap
def test_cursor_route_replays_insert_ranges(model_as_kernel, monkeypatch,
                                            G, chunk, cap_min, dtype):
    """The cursor route of run_placement_chunked with prefix caps: each
    range writes the cursor once, replays a graph of G insertions (hi -
    lo) // G times and runs the rest directly; a graph is captured once
    per state, so again after each cap change. The state equals the plain
    loop's and JAX's, bit for bit."""
    n = 40
    D = torch.from_numpy(_matrix("noisy", n).astype(dtype))
    kw = dict(num_sequences=n, frontend="matrix", dtype_name=dtype,
              chunk=chunk)
    monkeypatch.setattr(tk, "_CAP_MIN", cap_min)
    with monkeypatch.context() as m:
        m.setattr(tk, "uses_insert_kernel", lambda st: False)
        plain = tk.run_placement_chunked((D,), **kw)
    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", G)
    route = model_as_kernel
    counts = (tk.SCORE_EDGES_LAUNCHES, insert_cuda.INSERT_STEP_LAUNCHES,
              insert_cuda.GRAPH_REPLAYS)
    st = tk.run_placement_chunked((D,), **kw)
    ranges = [(lo, min(n, lo + chunk)) for lo in range(2, n, chunk)]
    caps = [tk._cap_for(hi, n) for _, hi in ranges]
    replays = sum((hi - lo) // G for lo, hi in ranges)
    assert route.steps == [(i, 4 * i - 4) for i in range(2, n)]
    assert route.captures == len({c for c, (lo, hi) in zip(caps, ranges)
                                  if hi - lo >= G})
    assert (tk.SCORE_EDGES_LAUNCHES - counts[0],
            insert_cuda.INSERT_STEP_LAUNCHES - counts[1],
            insert_cuda.GRAPH_REPLAYS - counts[2]) == (n - 2, n - 2, replays)
    _assert_same(st, plain)
    js = jk.run_placement_full((jnp.asarray(D.numpy()),), num_sequences=n,
                               frontend="matrix", dtype_name=dtype)
    _assert_same_as_jax(js, st)


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_add_queries_routes_to_the_kernel(model_as_kernel, dtype):
    """--add on the card's route (seeding by the BFS alone, queries by
    score + insert_step) gives the reference's arrays."""
    n, B = 30, 12
    D = _matrix("additive", n)
    e, belong, length = jax.device_get(jk.run_placement(
        (jnp.asarray(D[:B, :B]),), num_sequences=B, frontend="matrix",
        dtype_name="float64"))
    nwk = jk.edges_to_newick(e, belong, length,
                             [f"L{i}" for i in range(B)], B)
    tree = parse_newick(nwk, n)
    order = [int(nm[1:]) for nm in tree.leaf_names_in_idx_order()]
    order += [i for i in range(n) if i not in order]
    D = np.ascontiguousarray(D[np.ix_(order, order)]).astype(dtype)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    kw = dict(num_sequences=n, backbone_size=B, frontend="matrix",
              dtype_name=dtype)
    want = jax.device_get(jk.run_add_queries(
        (jnp.asarray(D),), jnp.asarray(e0), jnp.asarray(belong0),
        jnp.asarray(length0, jnp.dtype(dtype)), jnp.asarray(rev0), **kw))
    got = tk.run_add_queries(
        (torch.from_numpy(D),), torch.from_numpy(e0),
        torch.from_numpy(belong0),
        torch.from_numpy(length0).to(getattr(torch, dtype)),
        torch.from_numpy(rev0), **kw)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("G", [5, 12, 64])
def test_seeding_replays_by_cursor(model_as_kernel, monkeypatch, G):
    """--add's seeding on the card's route: one cursor write, B // G
    replays of a graph of G BFS launches (the cursor's i as the leaf),
    the rest direct; then the queries' range; the reference's arrays."""
    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", G)
    n, B = 30, 12
    D = _matrix("noisy", n)
    e, belong, length = jax.device_get(jk.run_placement(
        (jnp.asarray(D[:B, :B]),), num_sequences=B, frontend="matrix",
        dtype_name="float64"))
    nwk = jk.edges_to_newick(e, belong, length,
                             [f"L{i}" for i in range(B)], B)
    tree = parse_newick(nwk, n)
    order = [int(nm[1:]) for nm in tree.leaf_names_in_idx_order()]
    order += [i for i in range(n) if i not in order]
    D = np.ascontiguousarray(D[np.ix_(order, order)])
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    kw = dict(num_sequences=n, backbone_size=B, frontend="matrix",
              dtype_name="float64")
    want = jax.device_get(jk.run_add_queries(
        (jnp.asarray(D),), jnp.asarray(e0), jnp.asarray(belong0),
        jnp.asarray(length0), jnp.asarray(rev0), **kw))
    route = model_as_kernel
    bfs = (insert_cuda.CLOSEST_BFS_LAUNCHES, insert_cuda.GRAPH_REPLAYS)
    got = tk.run_add_queries(
        (torch.from_numpy(D),), torch.from_numpy(e0),
        torch.from_numpy(belong0), torch.from_numpy(length0),
        torch.from_numpy(rev0), **kw)
    assert route.leaves == list(range(B))
    # the queries' one range replays too
    assert (insert_cuda.CLOSEST_BFS_LAUNCHES - bfs[0],
            insert_cuda.GRAPH_REPLAYS - bfs[1]) == (B, B // G
                                                    + (n - B) // G)
    assert route.captures == (B >= G) + (n - B >= G)
    assert route.steps == [(i, 4 * i - 4) for i in range(B, n)]
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------


def _small_state(dtype="float32"):
    D = torch.from_numpy(_matrix("additive", 10).astype(dtype))
    return tk.init_placement_state((D,), num_sequences=10, frontend="matrix",
                                   dtype_name=dtype)


def test_cpu_state_takes_the_plain_version():
    st = _small_state()
    assert st.inserter is None and not tk.uses_insert_kernel(st)
    before = (insert_cuda.INSERT_STEP_LAUNCHES,
              insert_cuda.CLOSEST_BFS_LAUNCHES)
    D = torch.from_numpy(_matrix("additive", 10).astype("float32"))
    tk._insert_range(st, 2, 10, D[2:], 10)
    tk.update_closest_bfs(st, 3, 20)
    assert (insert_cuda.INSERT_STEP_LAUNCHES,
            insert_cuda.CLOSEST_BFS_LAUNCHES) == before
    assert st.inserter is None


def test_wrapper_rejects_cpu_states_and_bad_arrays():
    st = _small_state()
    one = torch.zeros((1,), dtype=torch.int32)
    f = torch.zeros((1,), dtype=torch.float32)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        insert_cuda.insert_step(st, one, f, f, middle=12, outside=3, label=3)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        insert_cuda.closest_bfs(st, 0)
    bad = dataclasses.replace(st, cdis=st.cdis.double())
    with pytest.raises(ValueError, match="cdis must be torch.float32"):
        insert_cuda.check_arrays(bad)
    bad = dataclasses.replace(st, adj=st.adj.long())
    with pytest.raises(ValueError, match="adj must be torch.int32"):
        insert_cuda.check_arrays(bad)
    bad = dataclasses.replace(st, cid=st.cid.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        insert_cuda.check_arrays(bad)
    with pytest.raises(ValueError, match="eid must be one torch.int32"):
        insert_cuda.check_choice(torch.float32, st.e.device, one.long(), f, f)
    with pytest.raises(ValueError, match="add must be one torch.float32"):
        insert_cuda.check_choice(torch.float32, st.e.device, one, f,
                                 f.double())
    insert_cuda.check_arrays(st)
    insert_cuda.check_choice(torch.float32, st.e.device, one, f, f)
