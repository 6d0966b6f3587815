"""The insertion-step kernel's plan on the CPU: placement/insert_model.py
(a numpy model of csrc/insert_step.cu: the splice's stable NaN-last rank
of ten, the BFS's chunked levels with scan compaction into [2, M]
scratch, the blocked slot) against the port's tensor code (kclosest.splice
+ _update_closest_bfs_compact, the kernel's plain version) and both
against the JAX package (splice + update_closest_bfs, _cluster_build_stream).

Tolerance: none. Every state array is compared bit for bit (floats by
their bits, so NaN payloads and signs count), in f32 and f64.

The tests that drive the routing (`_insert_range`, `run_add_queries`,
`build_streamed` as they run on the card) put the model in the kernel's
place on CPU tensors; the kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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


def _model_build(D, dtype, threads, check_each=None):
    """The placement of D's taxa with every splice and BFS by the model
    (the scorer's plain version on the model's arrays, shared through
    numpy views). `check_each(i, st)` runs after each insertion."""
    n = D.shape[0]
    Dt = torch.from_numpy(D.astype(dtype))
    st = tk.init_state(n, getattr(torch, dtype), torch.device("cpu"))
    tk.build_initial_tree(st, Dt[1, 0], n)
    s = im.arrays_of(st)
    im.closest_bfs(s, 0, threads=threads)
    im.closest_bfs(s, 1, threads=threads)
    if check_each:
        check_each(1, st)
    for i in range(2, n):
        eid, _, _, _, frac, add = tk._score_edges_plain(st, Dt[i])
        xy = im.insert_step(s, eid, frac.numpy(), add.numpy(), st.idx,
                            i + n - 1, i, i, threads=threads)
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
    for i in range(B):
        levels = []
        im.bfs(s, i, i, levels=levels)
        widest = max(widest, max(levels))
        tk._update_closest_bfs_compact(plain, i, 2 * n)
    assert 3 * widest > im.THREADS
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
                      block_slot=-1, stream=None):
    """insert_cuda.insert_step's contract, computed by the model."""
    for t, want in ((eid, torch.int32), (frac, st.length.dtype),
                    (add, st.length.dtype)):
        assert t.dtype == want and t.numel() == 1
    xy = im.insert_step(im.arrays_of(st), int(eid.reshape(())),
                        frac.reshape(()).numpy(), add.reshape(()).numpy(),
                        st.idx, middle, outside, label, block_slot)
    st.idx += 4
    return torch.tensor(xy, dtype=torch.int32)


def _fake_closest_bfs(st, leaf, label=None, blocked=None, stream=None):
    im.closest_bfs(im.arrays_of(st), leaf, label,
                   () if blocked is None else blocked.tolist())


def _fake_score_edges_launch(st, row, stream=None, lo=0, hi=None):
    eid, _, _, _, frac, add = tk._score_edges_plain(st, row)
    return types.SimpleNamespace(eid=torch.tensor(eid, dtype=torch.int32),
                                 frac=frac, add=add)


@pytest.fixture
def model_as_kernel(monkeypatch):
    """CPU states with an adjacency table take the card's route, with the
    model in the kernel's place."""
    monkeypatch.setattr(tk, "uses_insert_kernel",
                        lambda st: st.adj is not None)
    monkeypatch.setattr(insert_cuda, "insert_step", _fake_insert_step)
    monkeypatch.setattr(insert_cuda, "closest_bfs", _fake_closest_bfs)
    monkeypatch.setattr(tk, "score_edges_launch", _fake_score_edges_launch)


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
    cleared from the launch's (xe, ye). The card's route with the model
    as the kernel, the plain route, and JAX's streamed build."""
    rng = np.random.default_rng(cmax)
    W = 10 + cmax
    Dq = rng.uniform(0.05, 0.6, (cmax, W)).astype(dtype)
    cd = np.sort(rng.uniform(0, 0.3, (2, 5)), axis=-1).astype(dtype)
    cid = np.arange(10, dtype=np.int32).reshape(2, 5)
    cid[1, 3:], cd[1, 3:] = -1, 2.0
    lens = rng.uniform(0.01, 0.2, 2).astype(dtype)
    lens[1] = lens[0]
    states = {}
    orig_init = tc.cluster_init_state

    def keep(route):
        def init(*a, **kw):
            st, sc = orig_init(*a, **kw)
            states[route] = st
            return st, sc
        return init

    D = torch.from_numpy(Dq)
    args = (torch.from_numpy(cd), torch.from_numpy(cid),
            torch.from_numpy(lens), sz, cmax, row_block)
    monkeypatch.setattr(tc, "cluster_init_state", keep("plain"))
    plain = tc.build_streamed(lambda s: D[s:s + row_block], *args)
    with monkeypatch.context() as m:
        m.setattr(tc, "cluster_init_state", keep("model"))
        m.setattr(tk, "uses_insert_kernel", lambda st: st.adj is not None)
        m.setattr(insert_cuda, "insert_step", _fake_insert_step)
        model = tc.build_streamed(lambda s: D[s:s + row_block], *args)
    _assert_same(states["model"], states["plain"])
    want = _jax_stream_cluster(Dq, cd, cid, lens, sz, cmax, dtype)
    for a, b, w in zip(model, plain, want):
        assert a.numpy().tobytes() == w.tobytes()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_insert_range_routes_to_the_kernel(model_as_kernel, monkeypatch,
                                           dtype):
    """_insert_range and init_placement_state on a state that takes the
    kernel: one score and one insert_step a taxon, the BFS alone twice
    at the start; the same state as the plain route and as JAX."""
    n = 30
    D = _matrix("noisy", n).astype(dtype)
    calls = []
    step = insert_cuda.insert_step

    def counted(st, *a, **kw):
        calls.append(kw["outside"])
        return step(st, *a, **kw)

    bfs_calls = []

    def bfs_counted(st, leaf, *a, **kw):
        bfs_calls.append(leaf)
        _fake_closest_bfs(st, leaf, *a, **kw)

    monkeypatch.setattr(insert_cuda, "insert_step", counted)
    monkeypatch.setattr(insert_cuda, "closest_bfs", bfs_counted)
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=n,
                                 frontend="matrix", dtype_name=dtype)
    tk._insert_range(st, 2, n, torch.from_numpy(D)[2:], n)
    assert bfs_calls == [0, 1] and calls == list(range(2, n))
    js = jk.run_placement_full((jnp.asarray(D),), num_sequences=n,
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
