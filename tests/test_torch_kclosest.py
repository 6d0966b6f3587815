"""k-closest placement: the PyTorch port vs the JAX package on the CPU.

The same inputs (numpy, from seeds) go through both packages. Integer
arrays (edge ids, witness ids, adjacency) and float arrays (branch
lengths, witness distances) must be bitwise equal: the port runs the
same elementwise float operations in the same order on the same
distance rows, and the JAX default scorer is bitwise equal to the direct
scorer the port runs (tests/test_placement.py::
test_epoch_scorer_bitwise_matches_direct). f32 cases are held bitwise
too, since the operations are the same in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dipper_tpu.distance.mash import pad_ranks as jax_pad_ranks
from dipper_tpu.distance.mash import rank_compress_host as jax_rank_compress
from dipper_tpu.placement import kclosest as jk
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu_torch.placement import kclosest as tk

from datagen import simulate_unaligned
from test_nj import random_additive_matrix

torch.set_num_threads(2)

FIELDS = ("e", "belong", "length", "rev", "cdis", "cid", "idx", "adj", "nfb")
CPU = torch.device("cpu")


def _scale(D):
    return D / (D.max() * 1.05)


def _additive(n):
    return _scale(random_additive_matrix(n, np.random.default_rng(n)))


def _noisy(n):
    rng = np.random.default_rng(n + 1000)
    D = random_additive_matrix(n, rng)
    D += rng.uniform(0, 0.05, D.shape)
    D = _scale((D + D.T) / 2)
    np.fill_diagonal(D, 0)
    return D


def _assert_same_state(jax_state, port_state, fields=FIELDS):
    want = jax.device_get(jax_state)
    got = tk.tree_state_to_numpy(port_state)
    for f in fields:
        a = np.asarray(getattr(want, f))
        b = got[f]
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


def _matrix_builds(D, dtype):
    n = D.shape[0]
    js = jk.run_placement_full((jnp.asarray(D, dtype),), num_sequences=n,
                               frontend="matrix", dtype_name=dtype)
    ts = tk.run_placement_full((torch.from_numpy(D.astype(dtype)),),
                               num_sequences=n, frontend="matrix",
                               dtype_name=dtype)
    return js, ts


@pytest.mark.parametrize("n", [4, 7, 16, 40, 100])
def test_matches_jax_additive(n):
    js, ts = _matrix_builds(_additive(n), "float64")
    _assert_same_state(js, ts)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [25, 60])
def test_matches_jax_noisy(n, dtype):
    js, ts = _matrix_builds(_noisy(n), dtype)
    _assert_same_state(js, ts)


def test_matches_jax_caterpillar():
    """d(i,j) = |i-j|: a caterpillar, the deepest BFS (depth ~ N)."""
    idx = np.arange(64, dtype=np.float64)
    js, ts = _matrix_builds(_scale(np.abs(idx[:, None] - idx[None, :])),
                            "float64")
    _assert_same_state(js, ts)


def _mash_ranks(n, L, seed, k=12, ss=100):
    rng = np.random.default_rng(seed)
    _, seqs = simulate_unaligned(n, L, rng)
    sk = np.asarray(sketch_sequences(seqs, k, ss))
    return jax_pad_ranks(jax_rank_compress(sk)), (k, ss)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mash_frontend_matches_jax(dtype):
    ranks, static = _mash_ranks(64, 600, 5)
    n = ranks.shape[0]
    js = jk.run_placement_full((jnp.asarray(ranks),), num_sequences=n,
                               frontend="mash", frontend_static=static,
                               dtype_name=dtype)
    ts = tk.run_placement_full((torch.from_numpy(ranks),), num_sequences=n,
                               frontend="mash", frontend_static=static,
                               dtype_name=dtype)
    _assert_same_state(js, ts)


def test_chunked_caps_match_oneshot_and_jax(monkeypatch):
    """Prefix caps with a small chunk (several cap buckets, ranges that
    cross bucket edges) == the port's one-shot build == JAX's chunked
    build, with the full [4N] layout at the end."""
    ranks, static = _mash_ranks(90, 500, 21)
    n = ranks.shape[0]
    kw = dict(num_sequences=n, frontend="mash", frontend_static=static,
              dtype_name="float64")
    full = tk.run_placement_full((torch.from_numpy(ranks),), **kw)
    monkeypatch.setattr(tk, "_CAP_MIN", 16)
    monkeypatch.setattr(jk, "_CAP_MIN", 16)
    capped = tk.run_placement_chunked((torch.from_numpy(ranks),), chunk=13,
                                      **kw)
    for f in FIELDS:
        a, b = getattr(full, f), getattr(capped, f)
        assert (a == b if isinstance(a, int) else torch.equal(a, b)), f
    _assert_same_state(
        jk.run_placement_chunked((jnp.asarray(ranks),), chunk=13, **kw),
        capped)


def _balanced_newick(n_leaves, rng):
    """A balanced binary tree over L0..L{n-1} with random lengths."""
    def sub(lo, hi):
        if hi - lo == 1:
            return f"L{lo}"
        mid = (lo + hi) // 2
        return (f"({sub(lo, mid)}:{rng.uniform(0.01, 0.1):.4f},"
                f"{sub(mid, hi)}:{rng.uniform(0.01, 0.1):.4f})")
    return sub(0, n_leaves) + ";"


def _widest_level(belong, e, leaf):
    """Most directed edges at one hop count from `leaf` (what one level
    of a witness BFS over empty lists visits)."""
    out = {}
    for i, b in enumerate(belong):
        if b >= 0:
            out.setdefault(int(b), []).append(int(e[i]))
    front, seen, widest = [leaf], {leaf}, 0
    while front:
        nxt = [v for u in front for v in out.get(u, []) if v not in seen]
        widest = max(widest, len(nxt))
        seen.update(nxt)
        front = nxt
    return widest


def test_compact_bfs_wide_levels_equal_dense_and_jax():
    """Seeding the witness lists of a balanced 1,024-leaf backbone (a
    BFS from every leaf over lists that start empty) crosses levels far
    wider than the JAX package's frontier cap of 256. The compact BFS
    sizes each level with `nonzero` and has no cap: its state is bitwise
    the dense BFS's and the JAX package's (which re-runs those BFS calls
    dense), and nfb stays 0."""
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement import api as tapi

    B = n = 1024
    tree = parse_newick(_balanced_newick(B, np.random.default_rng(3)), n)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    assert _widest_level(belong0, e0, 0) > jk._FRONTIER_CAP
    states = {}
    for use_adj in (True, False):
        st = tk.TreeState(
            e=torch.from_numpy(e0), belong=torch.from_numpy(belong0),
            length=torch.from_numpy(length0), rev=torch.from_numpy(rev0),
            cdis=torch.full((4 * n, tk.K), tk.SENT_DIS, dtype=torch.float64),
            cid=torch.full((4 * n, tk.K), -1, dtype=torch.int32),
            idx=4 * B - 4,
            adj=(tk.adjacency_from_edges(torch.from_numpy(belong0), 2 * n)
                 if use_adj else None))
        for i in range(B):
            tk.update_closest_bfs(st, i, 2 * n)
        states[use_adj] = st
    assert states[True].nfb == 0
    for f in ("cdis", "cid"):
        assert torch.equal(getattr(states[True], f),
                           getattr(states[False], f)), f
    js = jk.TreeState(
        e=jnp.asarray(e0), belong=jnp.asarray(belong0),
        length=jnp.asarray(length0), rev=jnp.asarray(rev0),
        cdis=jnp.full((4 * n, jk.K), jk.SENT_DIS, jnp.float64),
        cid=jnp.full((4 * n, jk.K), -1, jnp.int32),
        idx=jnp.int32(4 * B - 4),
        adj=jk.adjacency_from_edges(jnp.asarray(belong0), 2 * n),
        nfb=jnp.int32(0))
    js = jax.jit(lambda s: jax.lax.fori_loop(
        0, B, lambda i, s: jk.update_closest_bfs(s, i, 2 * n), s))(js)
    assert int(js.nfb) > 0  # the JAX build overflowed and re-ran dense
    _assert_same_state(js, states[True], FIELDS[:-1])


def test_dense_bfs_only_matches():
    """A state without an adjacency table runs the dense BFS throughout
    and still matches the JAX build."""
    D = _noisy(25)
    n = 25
    js = jk.run_placement_full((jnp.asarray(D),), num_sequences=n,
                               frontend="matrix", dtype_name="float64")
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=n,
                                 frontend="matrix", dtype_name="float64")
    st.adj = None
    tk._insert_range(st, 2, n, torch.from_numpy(D)[2:], n)
    _assert_same_state(js, st, FIELDS[:-2])


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint written mid-build by dipper_tpu's save_tree_state
    resumes in the port to the JAX package's final state; a port
    checkpoint loads in dipper_tpu with the same arrays and dtypes."""
    ranks, static = _mash_ranks(23, 700, 9)
    n = ranks.shape[0]
    kw = dict(num_sequences=n, frontend="mash", frontend_static=static,
              dtype_name="float64")
    final = jk.run_placement_full((jnp.asarray(ranks),), **kw)
    ckpt = str(tmp_path / "jax.npz")
    st0 = jk.init_placement_state((jnp.asarray(ranks),), **kw)
    st0 = jk.run_insert_range(st0, jnp.int32(2), jnp.int32(11),
                              (jnp.asarray(ranks),), **kw)
    fp = {"frontend": "mash", "dtype": "float64"}
    jk.save_tree_state(ckpt, st0, 11, n, fp)
    resumed = tk.run_placement_chunked((torch.from_numpy(ranks),), chunk=5,
                                       load_state=ckpt, **kw)
    _assert_same_state(final, resumed)

    with pytest.raises(SystemExit, match="fingerprint"):
        tk.run_placement_chunked((torch.from_numpy(ranks),), chunk=5,
                                 load_state=ckpt,
                                 fingerprint={"names_sha256": "x"}, **kw)

    port_ckpt = str(tmp_path / "port.npz")
    tk.save_tree_state(port_ckpt, resumed, n, n, fp)
    back, next_i = jk.load_tree_state(port_ckpt, n, jnp.float64, fp)
    assert next_i == n
    _assert_same_state(back, resumed)
    a, b = np.load(ckpt), np.load(port_ckpt)
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert a[f].dtype.kind == b[f].dtype.kind, f


def test_pre_adjacency_checkpoint_rebuilds_adj(tmp_path):
    """A checkpoint without `adj` gets the table rebuilt from belong,
    equal to JAX's adjacency_from_edges."""
    D = _noisy(25)
    st = tk.run_placement_full((torch.from_numpy(D),), num_sequences=25,
                               frontend="matrix", dtype_name="float64")
    want = np.asarray(jk.adjacency_from_edges(
        jnp.asarray(st.belong.numpy()), 50))
    assert np.array_equal(tk.adjacency_from_edges(st.belong, 50).numpy(),
                          want)
    assert np.array_equal(st.adj.numpy(), want)
    st.adj = None
    path = str(tmp_path / "noadj.npz")
    tk.save_tree_state(path, st, 25, 25)
    loaded, _ = tk.load_tree_state(path, 25, "float64", device=CPU)
    assert np.array_equal(loaded.adj.numpy(), want)


def test_tree_state_numpy_round_trip():
    D = _noisy(25)
    js = jk.run_placement_full((jnp.asarray(D, "float32"),), num_sequences=25,
                               frontend="matrix", dtype_name="float32")
    host = jax.device_get(js)
    st = tk.tree_state_from_numpy(host._asdict(), CPU)
    assert st.e.dtype == torch.int32 and st.cdis.dtype == torch.float32
    _assert_same_state(js, st)
    back = tk.tree_state_to_numpy(st)
    again = tk.tree_state_from_numpy(back, CPU)
    for f in FIELDS:
        a, b = getattr(st, f), getattr(again, f)
        assert (a == b if isinstance(a, int) else torch.equal(a, b)), f


def test_newick_matches_jax():
    D = _noisy(60)
    js, ts = _matrix_builds(D, "float64")
    names = [f"L{i}" for i in range(60)]
    want = jk.edges_to_newick(*jax.device_get((js.e, js.belong, js.length)),
                              names, 60)
    assert tk.edges_to_newick(ts.e, ts.belong, ts.length, names, 60) == want


def test_rows_past_the_bank_raise():
    D = torch.from_numpy(_noisy(25))
    with pytest.raises(ValueError, match="run past"):
        tk._rows((D[:8, :8],), "matrix", (), "float64", 4, 9)


def _side_inputs(dtype, seed):
    """Witness lists with empty slots, edges with no witness at all, and a
    NaN distance."""
    rng = np.random.default_rng(seed)
    E, cap = 300, 80
    cid = rng.integers(0, cap, (E, tk.K)).astype(np.int32)
    cid[rng.random((E, tk.K)) < 0.3] = -1
    cid[::9] = -1
    cdis = rng.random((E, tk.K)).astype(dtype)
    row = rng.random(cap).astype(dtype)
    row[[5, 41]] = np.nan
    return cid, cdis, row


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_side_vector_matches_jax(dtype):
    """The side-vector kernel's plain version vs the JAX package's, NaN
    included (same NaN positions, same bits elsewhere)."""
    cid, cdis, row = _side_inputs(dtype, 11)
    got = tk._side_vector(*map(torch.from_numpy, (cid, cdis, row))).numpy()
    want = np.asarray(jk._side_vector(jnp.asarray(cid), jnp.asarray(cdis),
                                      jnp.asarray(row)))
    assert got.dtype == want.dtype
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and (got[::9] == 0).all()
    ok = ~np.isnan(got)
    assert np.array_equal(got[ok].view(f"i{got.itemsize}"),
                          want[ok].view(f"i{want.itemsize}"))


def test_side_vector_cpu_takes_the_plain_version():
    cid, cdis, row = map(torch.from_numpy, _side_inputs("float32", 12))
    before = tk.SIDE_VECTOR_LAUNCHES
    got = tk.side_vector(cid, cdis, row)
    assert tk.SIDE_VECTOR_LAUNCHES == before
    want = tk._side_vector(cid, cdis, row)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])


def test_side_vector_kernel_wrapper_rejects_cpu_tensors():
    cid, cdis, row = map(torch.from_numpy, _side_inputs("float32", 13))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.side_vector_cuda(cid, cdis, row)


# ---------------------------------------------------------------------------
# The scorer: plain version vs the JAX package, the kernel's model vs the
# plain version
# ---------------------------------------------------------------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as hst  # noqa: E402

from dipper_tpu_torch.placement import score_model as sm  # noqa: E402

DTYPES = ["float64", "float32"]
CASE_NAMES = [c[0] for c in sm.made_up_cases("float32")]


def _bits(x):
    """A 0-d float (torch, jax or numpy) as (is NaN, its bits)."""
    a = np.asarray(x)
    return bool(np.isnan(a)), (None if np.isnan(a)
                               else a.view(f"i{a.itemsize}").item())


def _same_six(got, want):
    assert tuple(got[:4]) == tuple(want[:4])
    for g, w in zip(got[4:], want[4:]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        assert _bits(g) == _bits(w)


def _jax_score(d, row):
    """dipper_tpu's score_edges on a state given as numpy arrays."""
    st = jk.TreeState(
        e=jnp.asarray(d["e"]), belong=jnp.asarray(d["belong"]),
        length=jnp.asarray(d["length"]), rev=jnp.asarray(d["rev"]),
        cdis=jnp.asarray(d["cdis"]), cid=jnp.asarray(d["cid"]),
        idx=jnp.asarray(d["idx"], jnp.int32), adj=None,
        nfb=jnp.asarray(0, jnp.int32))
    eid, frac, add = jk.score_edges(st, jnp.asarray(row))
    return int(eid), np.asarray(frac), np.asarray(add)


def _assert_plain_matches_jax(d, row):
    """eid equal, frac and add bitwise (tolerance 0; NaN matches NaN)."""
    st = tk.tree_state_from_numpy(d, CPU)
    got = tk.score_edges(st, torch.from_numpy(row))
    eid, frac, add = _jax_score(d, row)
    assert got[0] == eid
    assert got[1:4] == (int(d["belong"][eid]), int(d["e"][eid]),
                        int(d["rev"][eid]))
    for g, w in ((got[4], frac), (got[5], add)):
        assert g.numpy().dtype == w.dtype and _bits(g.numpy()) == _bits(w)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_score_edges_matches_jax_made_up(name, dtype):
    _, d, row, expected = next(c for c in sm.made_up_cases(dtype)
                               if c[0] == name)
    got = _assert_plain_matches_jax(d, row)
    assert sm.meets(expected, got), (expected, got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 300])
def test_score_edges_matches_jax_on_built_states(n, dtype):
    """States taken from a build of n - 20 taxa (full [4n] arrays, so the
    tail is unused), scored with the rows of the 20 taxa not yet placed."""
    D = _noisy(n).astype(dtype)
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=n,
                                 frontend="matrix", dtype_name=dtype)
    tk._insert_range(st, 2, n - 20, torch.from_numpy(D)[2:], n)
    d = {k: v for k, v in tk.tree_state_to_numpy(st).items()
         if v is not None}
    for i in range(n - 20, n):
        got = _assert_plain_matches_jax(d, D[i])
        _same_six(sm.score_edges_model(st, torch.from_numpy(D[i])), got)


def test_score_edges_tie_is_a_tie():
    """The tie case's two edges really score the same: with the lower
    slot made invalid, the higher one wins with the same bits."""
    for dtype in DTYPES:
        _, d, row, expected = next(c for c in sm.made_up_cases(dtype)
                                   if c[0] == "tie")
        first = tk.score_edges(tk.tree_state_from_numpy(d, CPU),
                               torch.from_numpy(row))
        a = expected["eid"]
        d["belong"][a], d["e"][a] = d["e"][a], d["belong"][a]
        second = tk.score_edges(tk.tree_state_from_numpy(d, CPU),
                                torch.from_numpy(row))
        assert first[0] == a and second[0] > a
        assert _bits(first[4]) == _bits(second[4])
        assert _bits(first[5]) == _bits(second[5]) and float(first[5]) < 2.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASE_NAMES)
@settings(max_examples=15, deadline=None)
@given(data=hst.data())
def test_score_model_equals_plain_hypothesis(name, dtype, data):
    """The kernel's algorithm (valid slots only, both sides per slot,
    partial minima over any split into blocks in any order, one candidate
    for the unused slots) gives the plain version's six values."""
    seed = data.draw(hst.integers(0, 2**16))
    _, d, row, _ = next(c for c in sm.made_up_cases(dtype, seed)
                        if c[0] == name)
    st = tk.tree_state_from_numpy(d, CPU)
    n_blocks = data.draw(hst.sampled_from([1, 2, 3, 8, 528]))
    rng = np.random.default_rng(seed)
    block_of = (rng.integers(0, n_blocks, st.idx) if data.draw(hst.booleans())
                else np.arange(st.idx) // 32 % n_blocks)
    order = (rng.permutation(st.idx) if data.draw(hst.booleans())
             else np.arange(st.idx))
    r = torch.from_numpy(row)
    _same_six(sm.score_edges_model(st, r, block_of, order),
              tk._score_edges_plain(st, r))


def test_score_edges_cpu_takes_the_plain_version():
    _, d, row, _ = sm.made_up_cases("float32")[0]
    st = tk.tree_state_from_numpy(d, CPU)
    assert st.scorer is None
    before = tk.SCORE_EDGES_LAUNCHES
    got = tk.score_edges(st, torch.from_numpy(row))
    assert tk.SCORE_EDGES_LAUNCHES == before and st.scorer is None
    _same_six(got, tk._score_edges_plain(st, torch.from_numpy(row)))


def test_score_edges_kernel_wrapper_rejects_cpu_state():
    _, d, row, _ = sm.made_up_cases("float32")[0]
    st = tk.tree_state_from_numpy(d, CPU)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        tk.score_edges_cuda(st, torch.from_numpy(row))
    with pytest.raises(ValueError, match="unsupported device"):
        tk.score_edges(st, torch.from_numpy(row).to("meta"))


def test_resized_state_gets_its_own_scorer_slot():
    """dataclasses.replace must not carry a scorer over to other arrays."""
    _, d, _, _ = sm.made_up_cases("float32")[1]  # 300 of 512 slots used
    st = tk.tree_state_from_numpy(d, CPU)
    st.scorer = object()
    assert tk._resize_state(st, 2 * st.e.shape[0]).scorer is None
    assert tk._resize_state(st, st.idx).scorer is None


def test_splice_with_ends_equals_splice_without():
    D = torch.from_numpy(_noisy(12))
    states = []
    for use_ends in (False, True):
        st = tk.init_placement_state((D,), num_sequences=12,
                                     frontend="matrix", dtype_name="float64")
        for i in range(2, 12):
            eid, x, y, ye, frac, add = tk.score_edges(st, D[i])
            tk.splice(st, eid, frac, add, i, 12,
                      (x, y, ye) if use_ends else None)
            tk.update_closest_bfs(st, i, 24)
        states.append(st)
    for f in FIELDS:
        a, b = getattr(states[0], f), getattr(states[1], f)
        assert (a == b if isinstance(a, int) else torch.equal(a, b)), f
