"""The numpy model of csrc/exact_step.cu (dipper_tpu_torch/placement/
exact_model.py) against the port's plain exact placement
(placement/exact.py) and dipper_tpu/placement/exact.py, after every
insertion, in f64 and f32: the same seeded matrices through all three,
bit for bit (NaN where NaN), at several block widths, cluster sizes and
split thresholds; the sweeps' values against `_compute_lims`; the node
records the model's splices keep against records rebuilt from the state;
rows with NaN and inf; a first minimum on an invalid slot; splices at the
root; depth shifts that reach the deepest level; the adjacency table and
the records rebuilt from checkpoints of either package; and the card's
cursor route (`exact._replay_exact`) driven on the CPU with the model in
the kernel's place."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipper_tpu.placement import exact as jexact
from dipper_tpu.placement import kclosest as jk
from dipper_tpu_torch.placement import exact as texact
from dipper_tpu_torch.placement import exact_cuda
from dipper_tpu_torch.placement import exact_model as xm
from dipper_tpu_torch.placement import kclosest as tk

from test_torch_exact import CASES, _kw, _matrix

torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = ("e", "belong", "length", "rev", "parent", "dep")
DTYPES = ("float64", "float32")


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    nan = a.dtype.kind == "f"
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=nan)


def _assert_same(got: dict, want, where: str) -> None:
    """Arrays of `got` (numpy) equal those of `want` (a dict of arrays, a
    port ExactState or a JAX one) in the reference's fields."""
    if isinstance(want, texact.ExactState):
        want = tk.tree_state_to_numpy(want)
    elif not isinstance(want, dict):
        want = {f: np.asarray(v) for f, v in
                jax.device_get(want)._asdict().items()}
    for f in FIELDS:
        assert _equal(got[f], want[f]), (f, where)


def _copy(st: texact.ExactState) -> texact.ExactState:
    return texact.ExactState.from_numpy(tk.tree_state_to_numpy(st), CPU)


def _records_equal(rec: dict, s: dict) -> bool:
    """Records kept by splices equal the records rebuilt from state s."""
    want = xm.node_records(s)
    return all(_equal(rec[f], want[f]) for f in xm.REC)


def _three_way(D: np.ndarray, dtype: str, rows=None, threads=xm.THREADS,
               ctas=xm.CLUSTER_CTAS, wide=xm.WIDE, rule=False):
    """Inserts every taxon by the model (on a port state, its node records
    built once and kept by its splices), by the plain version and by the
    JAX package, comparing after each insertion, records included; the
    rows are D's unless `rows` gives insertion i's. Every launch runs at
    `ctas`, or with `rule` on block 0 alone where the launch before found
    fewer than CLUSTER_LEVELS wide levels, as the kernel. Returns the
    model's record of each insertion."""
    n = D.shape[0]
    Dt = torch.from_numpy(D.astype(dtype))
    Dj = jnp.asarray(D.astype(dtype))
    kw = _kw(n, dtype)
    sj = jexact.init_exact_state((Dj,), **kw)
    plain = texact.init_exact_state((Dt,), **kw)
    model = _copy(plain)
    arr = xm.arrays_of(model)
    arr["rec"] = xm.node_records(arr)
    recs = []
    prev = -1
    for i in range(2, n):
        row = Dt[i] if rows is None else torch.from_numpy(
            rows(i).astype(dtype))
        lim = texact._compute_lims(plain, row, n).numpy()
        rec = xm.exact_step(arr, row.numpy(), i, model.idx, n, threads,
                            ctas, wide, prev if rule else None)
        prev = rec["wide_levels"]
        model.idx += 4
        assert _equal(rec["lim"], lim), f"lims, insertion {i}"
        texact.exact_insertion_step(plain, row, i, n)
        if rows is None:
            sj = jexact.run_exact_range(sj, jnp.int32(i), jnp.int32(i + 1),
                                        (Dj,), **kw)
        else:
            sj = _jax_step(sj, jnp.asarray(row.numpy()), i, n)
        where = f"insertion {i}"
        _assert_same(arr, plain, where)
        _assert_same(arr, sj, where)
        assert _equal(arr["adj"], plain.adj.numpy()), where
        assert _equal(arr["adj"], tk.adjacency_from_edges(
            model.belong, 2 * n).numpy()), where
        assert _records_equal(arr["rec"], arr), where
        recs.append(rec)
    return recs


@jax.jit
def _jax_lims_step(st, row):
    n = st.parent.shape[0] // 2
    lim = jexact._compute_lims(st, row, n)
    return jexact._score_exact(st, lim)


def _jax_step(sj, row, i: int, n: int):
    """One insertion of the JAX package on a given row."""
    eid, frac, add = _jax_lims_step(sj, row)
    return jexact._splice_exact(sj, eid, frac, add, i, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, kind", CASES)
def test_model_equals_plain_and_jax_after_every_insertion(n, kind, dtype):
    _three_way(_matrix(n, n + 7, kind), dtype)


# (threads, cluster blocks, split threshold, dtype); the first three, one
# block in f64, keep their ids
_LARGE = 1 << 30
_CHUNKS = [pytest.param(t, c, w, d, id=str(t) if (c, w, d) == (
    1, _LARGE, "float64") else f"{t}-C{c}-W{w}-{d}")
    for c in (1, 2, 16) for w in (_LARGE, 1) for d in DTYPES
    for t in (1, 3, 32)]


@pytest.mark.parametrize("threads, ctas, wide, dtype", _CHUNKS)
def test_model_chunks_do_not_change_bits(threads, ctas, wide, dtype):
    """Levels taken a few entries at a time (wider than the block), and
    wide levels split over a cluster of blocks (W = 1: every level past
    the root's), give the same list, scores and states, records
    included."""
    recs = _three_way(_matrix(45, 52), dtype, threads=threads, ctas=ctas,
                      wide=wide)
    assert max(r["positions"] for r in recs) > threads


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_with_nan_and_inf(dtype):
    """NaN, +inf and -inf in the rows: the top-2 rule makes every child of
    a node that meets a NaN NaN, the NaN edge's own included."""
    n = 24
    D = _matrix(n, 5)
    nan_edge = []

    def rows(i):
        row = D[i].copy()
        if i % 4 == 1:
            row[(i * 7) % i] = np.nan
        if i % 5 == 2:
            row[(i * 3) % i] = np.inf
        if i % 6 == 3:
            row[(i * 5) % i] = -np.inf
        return row

    recs = _three_way(D, dtype, rows=rows)
    for i, rec in zip(range(2, n), recs):
        if i % 4 == 1:
            nan_edge.append(np.isnan(rec["lim"]).any())
    assert nan_edge and all(nan_edge)
    # every level past the root's split over a cluster of 16 blocks of 3
    _three_way(D, dtype, rows=rows, threads=3, ctas=16, wide=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_first_minimum_on_an_invalid_slot(dtype):
    """Rows far above every length: every valid score exceeds SENT_DIS,
    so the first minimum is the lowest upward slot (slot 0, leaf 0's)."""
    n = 12
    D = _matrix(n, 9)
    for ctas, wide in ((xm.CLUSTER_CTAS, xm.WIDE), (16, 1)):
        recs = _three_way(D, dtype, rows=lambda i: D[i] + 50.0, ctas=ctas,
                          wide=wide)
        assert [r["eid"] for r in recs] == [0] * (n - 2)
        assert all(r["ch"] == 0 for r in recs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["tied", "noisy"])
@pytest.mark.parametrize("threads, ctas", [(3, 2), (1, 16), (32, 16)])
def test_model_split_levels_with_ties(kind, dtype, threads, ctas):
    """Tied values (equal top-2 statistics, equal scores) and noisy
    matrices with every level past the root's split over the cluster: the
    bits stay the plain version's and the JAX package's."""
    _three_way(_matrix(30, 41, kind), dtype, threads=threads, ctas=ctas,
               wide=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_takes_the_cluster_after_enough_wide_levels(dtype):
    """The kernel's rule, modelled: a launch takes the whole cluster only
    where the launch before found at least CLUSTER_LEVELS levels wider than
    W (the first launch is block 0's); both kinds of launch occur as the
    tree grows, and the bits stay the plain version's and the JAX
    package's."""
    recs = _three_way(_matrix(45, 52), dtype, threads=3, ctas=2, wide=1,
                      rule=True)
    assert recs[0]["ctas_run"] == 1
    for a, b in zip(recs, recs[1:]):
        assert b["ctas_run"] == (2 if a["wide_levels"] >= xm.CLUSTER_LEVELS
                                 else 1)
    runs = [r["ctas_run"] for r in recs[1:]]
    assert 1 in runs and 2 in runs


def test_splices_at_the_root_and_shifts_to_the_deepest_level():
    """The cases reach a splice onto an edge at the root and a depth shift
    of a subtree that holds the deepest level."""
    at_root = deepest = 0
    for n, kind in CASES:
        for rec in _three_way(_matrix(n, n + 7, kind), "float64", ctas=2,
                              wide=1):
            at_root += rec["pa"] == n
            deepest += (rec["ch_depth"] + rec["subtree_levels"] - 1
                        == rec["maxdep"])
    assert at_root > 0 and deepest > 0


def test_walk_overflow_is_refused():
    """A table whose walk finds more nodes than M (a cycle) raises."""
    n = 6
    D = _matrix(n, 3)
    st = texact.init_exact_state((torch.from_numpy(D),), **_kw(n))
    arr = xm.arrays_of(st)
    arr["adj"][0] = (0, 3, -1)   # leaf 0 also points back down to leaf 1
    arr["e"][3] = 0
    with pytest.raises(ValueError, match="more than"):
        xm.walk(arr, n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adj_rebuilt_from_checkpoints(tmp_path, writer):
    """A checkpoint of either package at insertion 13 holds the
    reference's fields and no adjacency table; loading it rebuilds the
    table the port's own build keeps, and the model resumes from it to the
    JAX package's final state."""
    n = 30
    D = _matrix(n, 19)
    Dj, Dt = jnp.asarray(D), torch.from_numpy(D)
    fp = {"frontend": "matrix", "dtype": "float64", "placement": "exact"}
    path = str(tmp_path / "ck.npz")
    st = texact.init_exact_state((Dt,), **_kw(n))
    texact.run_exact_range(st, 2, 13, Dt[2:13], n)
    if writer == "jax":
        sj = jexact.init_exact_state((Dj,), **_kw(n))
        sj = jexact.run_exact_range(sj, jnp.int32(2), jnp.int32(13), (Dj,),
                                    **_kw(n))
        jk.save_tree_state(path, sj, 13, n, fp)
    else:
        tk.save_tree_state(path, st, 13, n, fp)
    with np.load(path) as d:
        assert set(texact.ExactState.FIELDS) <= set(d.files)
        assert "adj" not in d.files
    got, i0 = tk.load_tree_state(path, n, "float64", fp, device=CPU,
                                 cls=texact.ExactState)
    assert i0 == 13
    assert _equal(got.adj.numpy(), st.adj.numpy())
    _assert_same(tk.tree_state_to_numpy(got), st, "loaded")
    arr = xm.arrays_of(got)
    # the records rebuilt from the checkpoint, kept by the model's splices
    arr["rec"] = xm.node_records(arr)
    mine = xm.arrays_of(st)
    assert _records_equal(arr["rec"], mine)
    for i in range(13, n):
        xm.exact_step(arr, D[i], i, got.idx, n, ctas=2, wide=1)
        got.idx += 4
        assert _records_equal(arr["rec"], arr), f"insertion {i}"
    want = jexact.run_exact_chunked((Dj,), chunk=n, **_kw(n))
    _assert_same(arr, want, "resumed by the model")


def test_checkpoints_keep_fields_and_round_trip(tmp_path):
    """An ExactState checkpoint holds exactly the reference's fields (and
    the file's own keys); port -> JAX -> port gives the same state, and
    each package resumes to the same final state."""
    n = 25
    D = _matrix(n, 23)
    Dj, Dt = jnp.asarray(D), torch.from_numpy(D)
    fp = {"frontend": "matrix", "dtype": "float64", "placement": "exact"}
    st = texact.init_exact_state((Dt,), **_kw(n))
    texact.run_exact_range(st, 2, 11, Dt[2:11], n)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tk.save_tree_state(a, st, 11, n, fp)
    with np.load(a) as d:
        assert set(d.files) == set(texact.ExactState.FIELDS) | {
            "next_i", "num_sequences", "state_kind", "fingerprint"}
    sj, i0 = jk.load_tree_state(a, n, jnp.float64, fp,
                                cls=jexact.ExactState)
    assert i0 == 11
    jk.save_tree_state(b, sj, 11, n, fp)
    back, _ = tk.load_tree_state(b, n, "float64", fp, device=CPU,
                                 cls=texact.ExactState)
    _assert_same(tk.tree_state_to_numpy(back), st, "round trip")
    assert _equal(back.adj.numpy(), st.adj.numpy())
    want = jexact.run_exact_chunked((Dj,), chunk=n, **_kw(n))
    for path in (a, b):
        _assert_same(tk.tree_state_to_numpy(texact.run_exact_chunked(
            (Dt,), chunk=7, load_state=path, fingerprint={}, **_kw(n))),
            want, path)


class _ModelRoute:
    """exact_cuda's entry points on CPU states, the model computing what the
    kernel would: each state's cursor and sticky error live here; a launch
    runs at once, or, inside a capture, is recorded and runs at each
    replay. A launch the model refuses (it raises) sets the error, and a
    launch after that does nothing, as the kernel's do."""

    def __init__(self, n: int):
        self.n, self.cursor, self.graphs = n, {}, {}
        self.recording = None
        self.steps = []
        self.error = {}
        self.wide = {}   # each state's `out` wide_levels (-1: no launch)

    def set_cursor(self, st, i, rows, lo, stream=None):
        # the kernel's cursor write rebuilds the node records
        self.cursor[id(st)] = [i, st.idx, rows.numpy(), lo,
                               xm.node_records(xm.arrays_of(st))]

    def check_done(self, st):
        if id(st) in self.error:
            st.idx = self.cursor[id(st)][1]
            raise RuntimeError(f"exact_step failed at insertion "
                               f"{self.cursor[id(st)][0]}: "
                               f"{self.error[id(st)]}")

    def step(self, st, stream=None, count=True):
        def run():
            if id(st) in self.error:
                return
            cur = self.cursor[id(st)]
            self.steps.append(cur[0])
            try:
                out = xm.exact_step_cursor(xm.arrays_of(st), cur, self.n,
                                           self.wide.get(id(st), -1))
                self.wide[id(st)] = out["wide_levels"]
            except ValueError as err:
                self.error[id(st)] = err
        if self.recording is None:
            run()
        else:
            self.recording.append(run)
        if count:
            exact_cuda.EXACT_STEP_LAUNCHES += 1

    def range_graph(self, st):
        if id(st) not in self.graphs:
            self.recording = []
            for _ in range(exact_cuda.GRAPH_INSERTIONS):
                self.step(st, None, False)
            runs, self.recording = self.recording, None
            self.graphs[id(st)] = (st, types.SimpleNamespace(
                graph=types.SimpleNamespace(
                    replay=lambda: [fn() for fn in runs]),
                steps=0, bfs=0, wide=False))
        return self.graphs[id(st)][1]


@pytest.fixture
def model_route(monkeypatch):
    """exact_cuda's entry points replaced by a _ModelRoute of 40 taxa,
    graphs of 4 insertions, every state taking the card's route."""
    route = _ModelRoute(40)
    monkeypatch.setattr(texact, "uses_exact_kernel", lambda st: True)
    monkeypatch.setattr(exact_cuda, "GRAPH_INSERTIONS", 4)
    monkeypatch.setattr(exact_cuda, "set_cursor", route.set_cursor)
    monkeypatch.setattr(exact_cuda, "exact_step_cursor", route.step)
    monkeypatch.setattr(exact_cuda, "range_graph", route.range_graph)
    monkeypatch.setattr(exact_cuda, "check_done", route.check_done)
    return route


@pytest.mark.parametrize("chunk", [9, 40])
def test_cursor_route_with_the_model_as_kernel(model_route, chunk):
    """run_exact_chunked through the card's route on CPU tensors, the model
    in the kernel's place, graphs of 4 insertions replayed with
    remainders: one launch an insertion, the state the JAX package's."""
    n = 40
    D = _matrix(n, 31, "noisy")
    route = model_route
    before = exact_cuda.EXACT_STEP_LAUNCHES
    st = texact.run_exact_chunked((torch.from_numpy(D),), chunk=chunk,
                                  **_kw(n))
    assert exact_cuda.EXACT_STEP_LAUNCHES - before == n - 2
    assert route.steps == list(range(2, n))
    want = jexact.run_exact_chunked((jnp.asarray(D),), chunk=n, **_kw(n))
    _assert_same(tk.tree_state_to_numpy(st), want, "cursor route")
    plain = texact.run_exact_chunked((torch.from_numpy(D),), chunk=chunk,
                                     plain=True, **_kw(n))
    assert exact_cuda.EXACT_STEP_LAUNCHES - before == n - 2
    _assert_same(tk.tree_state_to_numpy(st), plain, "plain route")


def test_cursor_route_raises_a_failed_insertion(model_route, monkeypatch):
    """A walk that overflows (a cycle in adj) at the first insertion of the
    cursor route, inside a replayed graph: run_exact_chunked raises after
    the range, naming insertion 2, and the state is as it was."""
    n = 40
    D = _matrix(n, 5)
    made = []

    def init_with_cycle(*args, **kw):
        st = init(*args, **kw)
        arr = xm.arrays_of(st)
        arr["adj"][0] = (0, 3, -1)   # as test_walk_overflow_is_refused
        arr["e"][3] = 0
        made.append((st, {f: a.copy() for f, a in arr.items()}, st.idx))
        return st

    init = texact.init_exact_state
    monkeypatch.setattr(texact, "init_exact_state", init_with_cycle)
    with pytest.raises(RuntimeError, match="at insertion 2:.*more than"):
        texact.run_exact_chunked((torch.from_numpy(D),), chunk=n, **_kw(n))
    (st, before, idx), = made
    assert model_route.steps == [2] and st.idx == idx
    for f, a in xm.arrays_of(st).items():
        assert _equal(a, before[f]), f


def test_wrapper_refuses_cpu_states():
    """On the CPU the wrapper launches nothing: it raises, and a CPU state
    takes the plain version."""
    n = 8
    st = texact.init_exact_state((torch.from_numpy(_matrix(n, 1)),),
                                 **_kw(n))
    assert st.stepper is None and not texact.uses_exact_kernel(st)
    with pytest.raises(ValueError, match="CUDA"):
        exact_cuda.exact_step_cursor(st)
