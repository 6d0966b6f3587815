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


def test_compact_bfs_overflow_equals_dense(monkeypatch):
    """A frontier cap of 1 forces the compact BFS to overflow on most
    insertions: each overflow restores the pre-BFS rows and re-runs the
    dense BFS, giving the same state as without overflows (and as the
    JAX build); nfb counts the fallbacks."""
    D = _noisy(40)
    base = tk.run_placement_full((torch.from_numpy(D),), num_sequences=40,
                                 frontend="matrix", dtype_name="float64")
    monkeypatch.setattr(tk, "_FRONTIER_CAP", 1)
    forced = tk.run_placement_full((torch.from_numpy(D),), num_sequences=40,
                                   frontend="matrix", dtype_name="float64")
    assert forced.nfb > 0 and base.nfb == 0
    for f in FIELDS[:-1]:
        a, b = getattr(base, f), getattr(forced, f)
        assert (a == b if isinstance(a, int) else torch.equal(a, b)), f
    js = jk.run_placement_full((jnp.asarray(D),), num_sequences=40,
                               frontend="matrix", dtype_name="float64")
    _assert_same_state(js, forced, FIELDS[:-1])


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
