"""Divide-and-conquer in the port (dipper_tpu_torch.dc) against the JAX
package (dipper_tpu.dc) on the CPU, on the inputs of tests/test_dc.py.

Tolerance 0 throughout: f64 Newick bytes are equal, `last_debug`'s edge
arrays (node ids, branch lengths) equal bit for bit, phase 2's
assignment equal (its md5 in the log line of both packages). Forced
paths (several phase-2 blocks, several builds a bucket, streamed
clusters with a ragged last row block) are held to the JAX default
output, so each path is checked against the reference and not only
against the port's other paths."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from dipper_tpu.utils.params import Param as JaxParam
from dipper_tpu_torch.utils.params import Param

import dipper_tpu.dc.pipeline as jpl
import dipper_tpu_torch.dc.pipeline as tpl

import oracle as orc
from datagen import simulate_alignment, simulate_unaligned
from test_nj import random_additive_matrix
from test_torch_insert import model_as_kernel  # noqa: F401  (a fixture)

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _dc_matrix(n, seed):
    rng = np.random.default_rng(seed)
    D = random_additive_matrix(n, rng)
    D += rng.uniform(0, 0.02, D.shape)
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0)
    return D / (D.max() * 1.05)


def _params(b, **kw):
    kw = dict(dtype="float64", backbone_size=b, batch_size=b, **kw)
    return JaxParam(**kw), Param(**kw)


def _jax_run(capsys, fn, *args):
    """A dipper_tpu.dc build and the md5 of its phase-2 assignment."""
    capsys.readouterr()
    nwk = fn(*args)
    err = capsys.readouterr().err
    return nwk, re.search(r"\[assign (\w+)\]", err).group(1)


def _jax_quiet(fn, *args):
    """_jax_run for a module fixture (no capsys): the stderr of the build
    captured by redirection."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        nwk = fn(*args)
    return nwk, re.search(r"\[assign (\w+)\]", err.getvalue()).group(1)


def _port_run(fn, *args, **kw):
    logs = []
    nwk = fn(*args, device=CPU, log=logs.append, **kw)
    text = "\n".join(logs)
    return nwk, re.search(r"\[assign (\w+)\]", text).group(1), text


def _same_debug():
    for k in ("e", "belong", "len"):
        a, b = jpl.last_debug[k], tpl.last_debug[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("n,b", [(40, 10), (60, 12), (90, 14)])
def test_matrix_equals_jax(capsys, n, b):
    D = _dc_matrix(n, n)
    names = [f"L{i}" for i in range(n)]
    jp, tp = _params(b, in_format="d")
    want, want_md5 = _jax_run(capsys, jpl.build_dc_tree_from_matrix, D,
                              names, jp)
    got, got_md5, _ = _port_run(tpl.build_dc_tree_from_matrix, D, names, tp)
    assert got == want
    assert got_md5 == want_md5
    _same_debug()
    # and the tree is the transliterated reference's
    o = orc.DCOracle(b, n)
    o.run_dc(lambda i: D[i])
    from dipper_tpu_torch.utils.treecmp import rf_distance

    assert rf_distance(got, o.to_newick(names))[0] == 0


@pytest.fixture(scope="module")
def matrix320():
    """tests/test_dc.py's multi-chunk input and the JAX default tree."""
    n, b = 320, 64
    D = _dc_matrix(n, 11)
    names = [f"L{i}" for i in range(n)]
    jp, tp = _params(b, in_format="d")
    want, md5 = _jax_quiet(jpl.build_dc_tree_from_matrix, D, names, jp)
    return D, names, tp, want, dict(jpl.last_debug, assign_md5=md5)


@pytest.mark.parametrize("knobs", [
    pytest.param({}, id="default"),
    pytest.param({"PHASE2_CHUNK": 48, "PHASE3_BUDGET": 8}, id="chunks"),
    pytest.param({"PHASE2_BYTES": 1, "PHASE3_BUDGET": 24}, id="one_row"),
    pytest.param({"_STREAM_CLUSTER_MIN": 8, "_STREAM_ROW_BLOCK": 3},
                 id="stream"),
])
def test_matrix_forced_paths_equal_jax_default(matrix320, monkeypatch,
                                               knobs):
    """Several phase-2 blocks (down to one row each), several builds per
    bucket (budgets that are not a multiple of 8 clusters), every cluster
    streamed with a ragged last row block: the JAX default tree and
    arrays, bit for bit."""
    D, names, tp, want, debug = matrix320
    for k, v in knobs.items():
        monkeypatch.setattr(tpl, k, v)
    got, _, log = _port_run(tpl.build_dc_tree_from_matrix, D, names, tp)
    assert got == want
    for k in ("e", "belong", "len"):
        assert np.array_equal(tpl.last_debug[k], debug[k]), k
    nclusters = int(re.search(r"(\d+) clusters, size", log).group(1))
    assert nclusters % 8 != 0
    if "_STREAM_CLUSTER_MIN" in knobs:
        assert "path=stream" in log


@pytest.fixture(scope="module")
def mash150():
    """test_dc_size_buckets_and_big_cluster_path's input and the JAX
    default tree."""
    names, seqs = simulate_unaligned(150, 900, np.random.default_rng(17))
    jp, tp = _params(12, in_format="r", kmer_size=12, sketch_size=100)
    want, md5 = _jax_quiet(jpl.build_dc_tree, seqs, names, jp)
    return names, seqs, tp, want, dict(jpl.last_debug, assign_md5=md5)


@pytest.mark.parametrize("knobs", [
    pytest.param({}, id="default"),
    pytest.param({"PHASE3_BUDGET": 40, "PHASE2_CHUNK": 29}, id="chunks"),
    pytest.param({"_STREAM_CLUSTER_MIN": 8, "_STREAM_ROW_BLOCK": 4},
                 id="stream"),
])
def test_mash_equals_jax(mash150, monkeypatch, knobs):
    """Heavy-tailed clusters from mash distances (several pow2 buckets):
    the per-cluster counts' plain version, the streamed rows and the
    chunked builds give the JAX package's Newick bytes and arrays."""
    names, seqs, tp, want, debug = mash150
    for k, v in knobs.items():
        monkeypatch.setattr(tpl, k, v)
    got, _, log = _port_run(tpl.build_dc_tree, seqs, names, tp)
    assert got == want
    for k in ("e", "belong", "len"):
        assert np.array_equal(tpl.last_debug[k], debug[k]), k
    buckets = re.findall(r"bucket cmax_b=(\d+) clusters=(\d+) path=(\w+)",
                         log)
    assert len(buckets) >= 3
    if knobs.get("_STREAM_CLUSTER_MIN"):
        sizes = [int(s) for s in re.findall(r"max=(\d+)", log)]
        assert ("stream" in {p for _, _, p in buckets}
                and any(s % 4 for s in sizes))


def test_mash_oracle_case_equals_jax(capsys):
    """test_dc_mash_close_to_oracle's case (N = 40, B = 10)."""
    rng = np.random.default_rng(40)
    names, seqs = simulate_unaligned(40, 1500, rng)
    jp, tp = _params(10, in_format="r", kmer_size=12, sketch_size=150)
    want, want_md5 = _jax_run(capsys, jpl.build_dc_tree, seqs, names, jp)
    got, got_md5, _ = _port_run(tpl.build_dc_tree, seqs, names, tp)
    assert got == want and got_md5 == want_md5
    _same_debug()


def test_mash_f32_nrf_zero():
    names, seqs = simulate_unaligned(150, 900, np.random.default_rng(17))
    jp, tp = _params(12, in_format="r", kmer_size=12, sketch_size=100)
    jp.dtype = tp.dtype = "float32"
    from dipper_tpu_torch.utils.treecmp import rf_distance

    want = jpl.build_dc_tree(seqs, names, jp)
    got, _, _ = _port_run(tpl.build_dc_tree, seqs, names, tp)
    assert rf_distance(got, want)[0] == 0


@pytest.mark.parametrize("case", ["oracle50", "stream120"])
def test_msa_equals_jax(monkeypatch, case):
    """test_dc_msa_matches_oracle's case and
    test_dc_streaming_msa_and_matrix's (streamed, ragged row blocks)."""
    if case == "oracle50":
        names, seqs = simulate_alignment(50, 800, np.random.default_rng(5),
                                         gap_frac=0.03, blen_scale=0.5)
    else:
        names, seqs = simulate_alignment(120, 700, np.random.default_rng(29),
                                         gap_frac=0.03, blen_scale=0.5)
    jp, tp = _params(10, in_format="m", distance_type=2)
    want = jpl.build_dc_tree(seqs, names, jp)
    if case == "stream120":
        monkeypatch.setattr(tpl, "_STREAM_CLUSTER_MIN", 8)
        monkeypatch.setattr(tpl, "_STREAM_ROW_BLOCK", 4)
    got, _, log = _port_run(tpl.build_dc_tree, seqs, names, tp)
    assert got == want
    assert ("path=stream" in log) == (case == "stream120")


def test_backbone_too_small():
    with pytest.raises(SystemExit, match="backbone too small"):
        tpl.build_dc_tree_from_matrix(_dc_matrix(20, 1), [f"L{i}" for i in
                                                          range(20)],
                                      Param(in_format="d", backbone_size=3),
                                      device=CPU)


# ---------------------------------------------------------------------------
# Kernel 4's plain version
# ---------------------------------------------------------------------------


def _rank_bank(n, L, seed, k=12, ss=100):
    from dipper_tpu_torch.distance.mash import pad_ranks, rank_compress_host
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    _, seqs = simulate_unaligned(n, L, np.random.default_rng(seed))
    return pad_ranks(rank_compress_host(sketch_sequences_native(seqs, k, ss)))


def _cluster_lists(n_rows, c, cmax, seed):
    """c clusters of ragged sizes 1..cmax, members padded by repeating the
    last, witnesses 10 heads then the members, as phase 3 builds them."""
    rng = np.random.default_rng(seed)
    sz = rng.integers(1, cmax + 1, c)
    sz[0], sz[-1] = 1, cmax
    mem = np.empty((c, cmax), np.int32)
    for i in range(c):
        ids = rng.choice(n_rows, sz[i], replace=False)
        mem[i] = ids[np.minimum(np.arange(cmax), sz[i] - 1)]
    wit = np.concatenate([rng.integers(0, n_rows, (c, 10)), mem],
                         axis=1).astype(np.int32)
    return wit, mem, sz


def test_cluster_inter_ref_equals_jax_vmap():
    """cluster_inter_ref against dipper_tpu's CPU counts
    (mash_pairwise_inter, impl="vmap", per cluster, the path of its
    phase 3 on the CPU) on ragged clusters, c = 13 (not a multiple of the
    TPU version's group of 8)."""
    import jax.numpy as jnp
    from dipper_tpu.distance.mash import mash_pairwise_inter
    from dipper_tpu_torch.distance import mash as tm

    ranks = _rank_bank(80, 800, 4)
    wit, mem, _ = _cluster_lists(80, 13, 9, 5)
    got = tm.cluster_inter_ref(torch.from_numpy(ranks), torch.from_numpy(wit),
                               torch.from_numpy(mem), sketch_size=100)
    assert got.shape == (13, 9, 19) and got.dtype == torch.int32
    R = jnp.asarray(ranks)
    for c in range(13):
        want = np.asarray(mash_pairwise_inter(R[wit[c]], R[mem[c]],
                                              sketch_size=100, impl="vmap"))
        assert np.array_equal(got[c].numpy(), want), c
    # the dispatcher takes the plain version for CPU tensors, no launch
    from dipper_tpu_torch.distance import mash_cuda

    before = mash_cuda.CLUSTER_LAUNCHES
    again = tm.mash_cluster_inter(torch.from_numpy(ranks),
                                  torch.from_numpy(wit),
                                  torch.from_numpy(mem), sketch_size=100)
    assert torch.equal(again, got) and mash_cuda.CLUSTER_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        mash_cuda.mash_cluster_inter_cuda(
            torch.from_numpy(ranks), torch.from_numpy(wit),
            torch.from_numpy(mem), sketch_size=100)


def test_pair_distances_pass_members_as_witness_tail(monkeypatch):
    """Phase 3's mash distances hand kernel 4 the members as a view of
    the witness lists' tail (the lists end with them as phase 3 builds
    them; the kernel then stages those rows once); the distances are
    those of the counts on the lists as given."""
    from dipper_tpu_torch.distance import mash as tm

    ranks = torch.from_numpy(_rank_bank(80, 800, 4))
    wit, mem, _ = _cluster_lists(80, 13, 9, 5)
    seen = []
    plain = tm.mash_cluster_inter

    def spy(r, w, m, *, sketch_size):
        seen.append((w, m))
        return plain(r, w, m, sketch_size=sketch_size)

    monkeypatch.setattr(tm, "mash_cluster_inter", spy)
    p = Param(in_format="r", kmer_size=12, sketch_size=100, dtype="float64")
    got = tpl._pair_distances("mash", ranks, p, wit, mem, CPU)
    ((w, m),) = seen
    assert m.data_ptr() == w.data_ptr() + 4 * 10 and m.stride() == (19, 1)
    assert torch.equal(m, torch.from_numpy(mem))
    want = tm.inter_to_dist(
        tm.cluster_inter_ref(ranks, torch.from_numpy(wit),
                             torch.from_numpy(mem), sketch_size=100),
        12, 100, "float64")
    assert got.shape == (13, 9, 19) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# The batched phase-2 scorer and the cluster step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_score_edges_rows_equals_score_edges(dtype):
    """score_edges_rows (on a CPU state, its plain version) and
    score_edges_rows_plain == a loop of score_edges, on the scorer's
    made-up states (ties between two valid edges, NaN and inf in rows,
    unused tails) and on a state built from a matrix."""
    from dipper_tpu_torch.placement import kclosest as tk
    from dipper_tpu_torch.placement import score_model as sm

    rng = np.random.default_rng(7)
    cases = [(name, d, row) for name, d, row, _ in sm.made_up_cases(dtype)]
    D = _dc_matrix(64, 3).astype(dtype)
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=64,
                                 frontend="matrix", dtype_name=dtype)
    tk._insert_range(st, 2, 44, torch.from_numpy(D)[2:], 64)
    cases.append(("built", tk.tree_state_to_numpy(st), D[44]))
    assert {"tie", "tie_unused_tail"} <= {c[0] for c in cases}
    for name, d, row in cases:
        st = tk.tree_state_from_numpy(
            {k: v for k, v in d.items() if v is not None}, CPU)
        # the case's row (a tie, NaN or inf where the case has them),
        # permutations of it, and a constant row
        rows = np.stack([row] + [rng.permutation(row) for _ in range(6)]
                        + [np.full_like(row, row[0])])
        want = [tk.score_edges(st, torch.from_numpy(r))[0] for r in rows]
        for fn in (tk.score_edges_rows, tk.score_edges_rows_plain):
            got = fn(st, torch.from_numpy(rows))
            assert got.tolist() == want, (fn.__name__, name)


def _jax_cluster_inputs(C, cmax, W, dtype, seed):
    rng = np.random.default_rng(seed)
    Dq = rng.uniform(0.05, 0.6, (C, cmax, W)).astype(dtype)
    cd = np.sort(rng.uniform(0, 0.3, (C, 2, 5)), axis=-1).astype(dtype)
    cid = np.tile(np.arange(10, dtype=np.int32).reshape(2, 5), (C, 1, 1))
    cid[0, 1, 3:] = -1
    cd[0, 1, 3:] = 2.0
    lens = rng.uniform(0.01, 0.2, (C, 2)).astype(dtype)
    lens[:, 1] = lens[:, 0]
    return Dq, cd, cid, lens


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jax_cluster_state_steps_in_the_port(dtype):
    """A JAX cluster state (vmapped _cluster_init_state/_cluster_step, a
    leading cluster axis) converted with tree_state_from_numpy and stepped
    by the port's cluster_step equals the JAX state stepped as far, array
    for array."""
    import jax
    import jax.numpy as jnp
    from dipper_tpu.placement import kclosest as jk
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.placement import kclosest as tk

    C, cmax = 5, 8
    W = 10 + cmax
    Dq, cd, cid, lens = _jax_cluster_inputs(C, cmax, W, dtype, 1)
    jdt = jnp.dtype(dtype)
    perm = jnp.asarray(jpl._mask_order_perm(cmax))
    pos_group = jnp.concatenate([jnp.array([-1, -1], jnp.int32),
                                 jnp.repeat(jnp.arange(cmax, dtype=jnp.int32),
                                            4)])
    grp = jnp.asarray(jpl._new_group_scoreable())
    init = jax.vmap(lambda a, b, c: jpl._cluster_init_state(
        a, b, c, cmax, jdt, with_adj=False))
    step = jax.jit(jax.vmap(
        lambda kq, row, st, sc: jpl._cluster_step(
            kq, row, st, sc, perm, pos_group, grp, cmax, jdt),
        in_axes=(None, 0, 0, 0)))
    jst = init(jnp.asarray(cd), jnp.asarray(cid), jnp.asarray(lens))
    jsc = jnp.zeros((C, 2 + 4 * cmax), jnp.bool_).at[:, 0].set(True)
    for kq in range(3):
        jst, jsc = step(kq, jnp.asarray(Dq[:, kq]), jst, jsc)
    host = jax.device_get(jst)._asdict()
    st = tk.tree_state_from_numpy(host, CPU)
    sc = torch.from_numpy(np.array(jsc))
    assert st.e.shape == (C, 2 + 4 * cmax) and st.idx == 2 + 4 * 3
    for kq in range(3, cmax):
        jst, jsc = step(kq, jnp.asarray(Dq[:, kq]), jst, jsc)
        tc.cluster_step(st, sc, kq, torch.from_numpy(Dq[:, kq]), cmax)
        want = jax.device_get(jst)
        for f in ("e", "belong", "length", "rev", "cdis", "cid"):
            a, b = np.asarray(getattr(want, f)), getattr(st, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (kq, f)
        assert np.array_equal(np.asarray(jsc), sc.numpy()), kq


@pytest.mark.parametrize("bfs", ["compact", "dense"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hooks_equal_jax_on_a_streamed_cluster(dtype, bfs, monkeypatch):
    """kclosest.splice(middle=, outside=) and update_closest_bfs(label=,
    blocked_nodes=), through the compact BFS or (forced) the dense one:
    the port's streamed build of one cluster (a ragged last row block)
    equals the JAX package's _cluster_build, as does the batched
    build."""
    import jax.numpy as jnp
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.placement import kclosest as tk

    if bfs == "dense":
        monkeypatch.setattr(tk, "_update_closest_bfs_compact",
                            tk._update_closest_bfs_dense)

    cmax = 21
    W = 10 + cmax
    Dq, cd, cid, lens = _jax_cluster_inputs(1, cmax, W, dtype, 2)
    sz = cmax - 2
    le, lb, ll = (np.asarray(x) for x in jpl._cluster_build(
        jnp.asarray(Dq[0]), jnp.asarray(cd[0]), jnp.asarray(cid[0]),
        jnp.asarray(lens[0]), jnp.int32(sz), cmax=cmax, dtype_name=dtype))
    D = torch.from_numpy(Dq[0])
    got = tc.build_streamed(lambda s: D[s:s + 4], torch.from_numpy(cd[0]),
                            torch.from_numpy(cid[0]),
                            torch.from_numpy(lens[0]), sz, cmax, 4)
    for a, b in zip((le, lb, ll), got):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    batched = tc.build_clusters(torch.from_numpy(Dq), torch.from_numpy(cd),
                                torch.from_numpy(cid),
                                torch.from_numpy(lens), [sz], cmax)
    for a, b in zip((le, lb, ll), batched):
        assert np.array_equal(a, b[0].numpy())


# ---------------------------------------------------------------------------
# Phase 3's kernels' plans (dc/cluster_model.py): kernel 8a
# (csrc/dc_stream_block.cu) and kernel 8b (csrc/dc_cluster_build.cu)
# ---------------------------------------------------------------------------


def _same_bytes(a, b, where=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where


def _jax_batched(Dq, cd, cid, lens, sizes, cmax, dtype):
    import jax.numpy as jnp

    out = jpl._cluster_build_vmapped(cmax, dtype)(
        jnp.asarray(Dq), jnp.asarray(cd), jnp.asarray(cid),
        jnp.asarray(lens), jnp.asarray(sizes, jnp.int32))
    return [np.asarray(x) for x in out]


def _jax_streamed(Dq, cd, cid, lens, sz, cmax, dtype):
    """dipper_tpu's _cluster_build_stream (matrix frontend, so
    _stream_range_run) of one cluster whose member k's row to witness w is
    Dq[k, w]."""
    import jax.numpy as jnp

    W = Dq.shape[1]
    Dm = np.zeros((W + cmax, W + cmax), dtype)
    Dm[W:, :W] = Dq
    payloads = (jnp.asarray(Dm), jnp.arange(W, dtype=jnp.int32),
                jnp.arange(W, W + cmax, dtype=jnp.int32))
    out = jpl._cluster_build_stream(
        "matrix", JaxParam(), dtype, payloads, jnp.asarray(cd),
        jnp.asarray(cid), jnp.asarray(lens), sz, cmax=cmax)
    return [np.asarray(x) for x in out]


def _keep_states(monkeypatch, tc):
    """cluster_init_state, recording each state it makes."""
    made = []
    orig = tc.cluster_init_state

    def keep(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(tc, "cluster_init_state", keep)
    return made


@pytest.mark.parametrize("case", ["random", "ties", "nan_row", "over_two"])
@pytest.mark.parametrize("cmax", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cluster_build_model_equals_tensor_route_and_jax(
        monkeypatch, case, cmax, dtype):
    """Kernel 8b's plan (cluster_model.build_chunk: at buckets up to 32 a
    warp a cluster, four clusters of ragged sizes, 1 among them, staged into
    their slices of one block's shared memory; at 64 a block a cluster over
    one slice; the masked score, the warp's splice, the warp's walk over
    the adjacency table, the row staged a member ahead) on a chunk of
    ragged sizes, against the port's tensor route (build_clusters on the
    CPU: the dense BFS, no adjacency table) and the JAX package's
    _cluster_build_vmapped: e, belong and length bit for bit; the model's
    whole state and flags equal the tensor route's, and its adjacency
    tables are the ones its edges give."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_model as cm
    from dipper_tpu_torch.placement import insert_model as im
    from dipper_tpu_torch.placement import kclosest as tk

    Dq, cd, cid, lens, sizes = cm.made_up_chunk(case, 6, cmax, dtype,
                                                seed=cmax)
    T = torch.from_numpy
    made = _keep_states(monkeypatch, tc)
    plain = tc.build_clusters(T(Dq), T(cd), T(cid), T(lens), sizes, cmax)
    (pst, pflags), = made
    want = _jax_batched(Dq, cd, cid, lens, sizes, cmax, dtype)
    for f, a, w in zip(("e", "belong", "length"), plain, want):
        _same_bytes(a.numpy(), w, f"{case}: tensor route vs JAX, {f}")
    st, flags = tc.cluster_init_state(T(cd), T(cid), T(lens), cmax,
                                      with_adj=True)
    assert st.adj.shape == (6, 2 + 2 * cmax, 3)
    plan = cm.kernel_config(cmax, np.dtype(dtype).itemsize)
    assert plan.kind == ("warp" if cmax <= 32 else "block")
    stats = {}
    cm.build_chunk(im.arrays_of(st), flags.numpy(), Dq, sizes, cmax, stats)
    for f in ("e", "belong", "length", "rev", "cdis", "cid"):
        _same_bytes(getattr(st, f).numpy(), getattr(pst, f).numpy(),
                    f"{case}: model vs tensor route, {f}")
    _same_bytes(flags.numpy(), pflags.numpy(), f"{case}: flags")
    for c in range(6):
        _same_bytes(st.adj[c].numpy(), tk.adjacency_from_edges(
            st.belong[c], 2 + 2 * cmax).numpy(), f"{case}: adj {c}")
    assert stats["levels"] > 0


@pytest.mark.parametrize("case", ["random", "ties", "nan_row", "over_two"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ctas, threads", [(16, 256), (3, 8)])
def test_stream_model_equals_tensor_route_and_jax(case, dtype, ctas,
                                                   threads):
    """Kernel 8a's plan (cluster_model.stream_block: a row block's members
    in one launch, each member's used slots scored by the cluster's blocks
    in tiles of `threads`, the partials met in block 0, block 0's splice
    and walk at a streamed cluster's offsets with slot 0 blocked, the
    flags from the splice) over row blocks of 4, blocks at kq0 > 0 and a
    ragged last one, against the port's streamed tensor route and the JAX
    package's _stream_range_run: e, belong and length bit for bit, the
    model's whole state equals the tensor route's."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_model as cm
    from dipper_tpu_torch.placement import insert_model as im

    cmax, rb = 21, 4
    Dq, cd, cid, lens, _ = cm.made_up_chunk(case, 2, cmax, dtype, seed=3)
    Dq, cd, cid, lens = Dq[0], cd[0], cid[0], lens[0]
    sz = cmax - 2
    T = torch.from_numpy
    D = T(Dq)
    init = (T(cd), T(cid), T(lens))
    made = []
    orig = tc.one_cluster

    def keep(*a):
        made.append(orig(*a))
        return made[-1]

    tc.one_cluster = keep
    try:
        plain = tc.build_streamed(lambda s: D[s:s + rb], *init, sz, cmax, rb)
    finally:
        tc.one_cluster = orig
    want = _jax_streamed(Dq, cd, cid, lens, sz, cmax, dtype)
    for f, a, w in zip(("e", "belong", "length"), plain, want):
        _same_bytes(a.numpy(), w, f"{case}: tensor route vs JAX, {f}")
    st, flags = tc.one_cluster(*tc.cluster_init_state(
        *(x[None] for x in init), cmax, with_adj=True))
    s, fl = im.arrays_of(st), flags.numpy()
    for kq0 in range(0, sz, rb):
        cm.stream_block(s, fl, Dq[kq0:kq0 + min(rb, sz - kq0)], kq0, cmax,
                        ctas, threads)
    pst = made[0][0]
    for f in ("e", "belong", "length", "rev", "cdis", "cid"):
        _same_bytes(s[f], getattr(pst, f).numpy(),
                    f"{case}: model vs tensor route, {f}")
    # the tensor route's flags, replayed from its edges: every used slot
    # was cleared or set by the same members
    assert fl[:2 + 4 * sz].sum() > 0 and not fl[2 + 4 * sz:].any()


@pytest.mark.parametrize("cmax", [8, 24, 40])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cluster_build_plans_give_the_same_state(cmax, dtype):
    """Kernel 8b's three plans (a warp a cluster in a slice of shared
    memory, a block a cluster in one slice, a block a cluster over device
    memory with frontier buffers that spill) build the same states, flags
    and adjacency tables from one chunk, bit for bit."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_model as cm
    from dipper_tpu_torch.placement import insert_model as im

    Dq, cd, cid, lens, sizes = cm.made_up_chunk("ties", 5, cmax, dtype,
                                                seed=cmax + 1)
    T = torch.from_numpy
    item = np.dtype(dtype).itemsize
    _, one = cm.slice_layout(cmax, item)
    plans = [cm.Plan("warp", 128, 2 + 2 * cmax, 4, 4 * one),
             cm.Plan("block", 128, 2 + 2 * cmax, 1, one),
             cm.Plan("global", 64, 32, 1, 0)]
    got = []
    for plan in plans:
        st, flags = tc.cluster_init_state(T(cd), T(cid), T(lens), cmax,
                                          with_adj=True)
        arrays, fl = im.arrays_of(st), flags.numpy()
        for c, size in enumerate(sizes.tolist()):
            cm.build_cluster({f: a[c] for f, a in arrays.items()}, fl[c],
                             Dq[c], size, cmax, plan=plan)
        got.append((arrays, fl))
    for arrays, fl in got[1:]:
        for f in im.FIELDS:
            _same_bytes(arrays[f], got[0][0][f], f)
        _same_bytes(fl, got[0][1], "flags")


def test_cluster_build_plan_by_bucket():
    """kernel_config's choice, as csrc/dc_cluster_build.cu's
    launch_by_bucket makes it: a warp a cluster up to bucket 32, a block a
    cluster in shared memory to 512 (the widest slice, f64 at 512, fits a
    block's 227 KB), device memory above; a slice's regions do not
    overlap and follow each other in slice_layout's order."""
    from dipper_tpu_torch.dc import cluster_model as cm

    for item in (4, 8):
        for cmax, kind in ((8, "warp"), (32, "warp"), (33, "block"),
                           (128, "block"), (512, "block"), (513, "global"),
                           (1023, "global")):
            plan = cm.kernel_config(cmax, item)
            assert plan.kind == kind, (cmax, item)
            assert plan.smem <= cm.SMEM_LIMIT
        layout, total = cm.slice_layout(512, item)
        size = {"f": item, "i": 4, "b": 1}
        ends = [off + n * size[c] for off, n, c in layout.values()]
        starts = [off for off, _, _ in layout.values()]
        assert starts == sorted(starts) and starts[1:] == ends[:-1]
        assert ends[-1] <= total <= cm.SMEM_LIMIT and total % 16 == 0
    assert cm.kernel_config(512, 8).smem == 215376


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cursor_offsets_give_the_old_launches(dtype):
    """insert_model.insert_step_cursor with placement's offsets (0, N - 1,
    0) and no blocked slot makes the launch the cursor entry made before
    its offsets (middle i + N - 1, outside and label i): a placement build
    by each is the same state insertion by insertion. With a streamed
    cluster's offsets (2, 2 + cmax, 10) and slot 0 blocked it makes
    insert_step's launch at member kq's nodes and label."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_model as cm
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im
    from dipper_tpu_torch.placement import kclosest as tk

    n = 40
    D = torch.from_numpy(_dc_matrix(n, 5).astype(dtype))
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name=dtype)
    old = im.arrays_of(st)
    new = {f: a.copy() for f, a in old.items()}
    cursor = [2, st.idx, None, 2]
    assert insert_cuda.cursor_offsets(n) == (0, n - 1, 0)
    for i in range(2, n):
        eid, x, y, ye, frac, add = tk._score_edges_plain(st, D[i])
        xy_old = im.insert_step(old, eid, frac.numpy(), add.numpy(), st.idx,
                                i + n - 1, i, i)
        xy_new = im.insert_step_cursor(new, cursor, (eid, x, y, ye),
                                       (frac.numpy(), add.numpy()),
                                       insert_cuda.cursor_offsets(n))
        st.idx += 4
        assert xy_old == xy_new and cursor[:2] == [i + 1, st.idx]
        for f in im.FIELDS:
            _same_bytes(new[f], old[f], f"insertion {i}, {f}")
    cmax = 12
    Dq, cd, cid, lens, _ = cm.made_up_chunk("random", 1, cmax, dtype, 9)
    T = torch.from_numpy
    st, flags = tc.one_cluster(*tc.cluster_init_state(
        T(cd), T(cid), T(lens), cmax, with_adj=True))
    old, fl = im.arrays_of(st), flags.numpy()
    new = {f: a.copy() for f, a in old.items()}
    cursor = [0, 2, None, 0]
    for kq in range(cmax):
        (eid, x, y, ye), (frac, add) = cm.score_masked(old, fl, Dq[0, kq],
                                                       2 + 4 * kq)
        xy_old = im.insert_step(old, eid, frac, add, 2 + 4 * kq,
                                2 + cmax + kq, 2 + kq, 10 + kq, block_slot=0)
        xy_new = im.insert_step_cursor(new, cursor, (eid, x, y, ye),
                                       (frac, add), tc.stream_offsets(cmax),
                                       block_slot=0)
        assert xy_old == xy_new
        for f in im.FIELDS:
            _same_bytes(new[f], old[f], f"member {kq}, {f}")


def _model_build_chunk(st, scoreable, Dq, sizes, cmax, stream=None):
    """cluster_cuda.build_chunk's contract, computed by the model."""
    from dipper_tpu_torch.dc import cluster_cuda
    from dipper_tpu_torch.dc import cluster_model as cm
    from dipper_tpu_torch.placement import insert_model as im

    assert sizes.dtype == torch.int32 and st.adj.dim() == 3
    cluster_cuda.CLUSTER_BUILD_LAUNCHES += 1
    cm.build_chunk(im.arrays_of(st), scoreable.numpy(), Dq.numpy(),
                   sizes.numpy(), cmax)


@pytest.mark.parametrize("knobs", [
    pytest.param({"PHASE3_BUDGET": 24}, id="chunks"),
    pytest.param({"_STREAM_CLUSTER_MIN": 8, "_STREAM_ROW_BLOCK": 5},
                 id="stream"),
])
def test_card_routes_with_models_as_kernels_equal_jax(
        matrix320, model_as_kernel, monkeypatch, knobs):
    """Phase 3 as it runs on the card, on CPU tensors with the models in
    the kernels' place: a batched chunk is one build launch with no host
    sync (BFS levels 0) whatever its steps; a streamed cluster's row block
    is one launch of kernel 8a. The bucket lines count the launches; the
    tree and arrays are the JAX package's default, bit for bit."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda

    D, names, tp, want, debug = matrix320
    for k, v in knobs.items():
        monkeypatch.setattr(tpl, k, v)
    monkeypatch.setattr(tc, "uses_cluster_kernel", lambda Dq: True)
    monkeypatch.setattr(cluster_cuda, "build_chunk", _model_build_chunk)
    before = (cluster_cuda.CLUSTER_BUILD_LAUNCHES,
              cluster_cuda.STREAM_BLOCK_LAUNCHES)
    got, _, log = _port_run(tpl.build_dc_tree_from_matrix, D, names, tp)
    assert got == want
    for k in ("e", "belong", "len"):
        assert np.array_equal(tpl.last_debug[k], debug[k]), k
    lines = re.findall(r"path=(\w+) members=(\d+) launches=(\d+) steps=\d+ "
                       r"bfs_levels=(\d+) kernel_launches=(\d+)", log)
    assert lines
    builds = blocks = members_streamed = 0
    for path, members, launches, levels, kernels in lines:
        assert int(levels) == 0
        # one build a chunk, one kernel-8a launch a row block
        assert int(kernels) == int(launches)
        if path == "batch":
            builds += int(launches)
        else:
            blocks += int(launches)
            members_streamed += int(members)
    assert (cluster_cuda.CLUSTER_BUILD_LAUNCHES - before[0],
            cluster_cuda.STREAM_BLOCK_LAUNCHES - before[1]) == (builds,
                                                                blocks)
    if "_STREAM_CLUSTER_MIN" in knobs:
        assert members_streamed > blocks > 0
        assert model_as_kernel.blocks
        assert all(n <= knobs["_STREAM_ROW_BLOCK"]
                   for _, n in model_as_kernel.blocks)
    else:
        assert builds > 1 and blocks == 0


def test_phase3_wrappers_reject_cpu_states():
    """The kernels' wrappers raise for a CPU state (their callers take the
    plain version there), and build_clusters on CPU tensors never reaches
    kernel 8b."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda
    from dipper_tpu_torch.dc import cluster_model as cm

    Dq, cd, cid, lens, sizes = cm.made_up_chunk("random", 3, 8, "float32")
    T = torch.from_numpy
    st, flags = tc.cluster_init_state(T(cd), T(cid), T(lens), 8,
                                      with_adj=True)
    with pytest.raises(ValueError, match="CUDA state"):
        cluster_cuda.build_chunk(st, flags, T(Dq), T(sizes.astype(np.int32)),
                                 8)
    st1, flags1 = tc.one_cluster(*tc.cluster_init_state(
        T(cd[:1]), T(cid[:1]), T(lens[:1]), 8, with_adj=True))
    with pytest.raises(ValueError, match="CUDA state"):
        cluster_cuda.stream_block(st1, flags1, T(Dq[0, :2]), 0, 8)
    before = cluster_cuda.CLUSTER_BUILD_LAUNCHES
    assert not tc.uses_cluster_kernel(T(Dq))
    tc.build_clusters(T(Dq), T(cd), T(cid), T(lens), sizes, 8)
    assert cluster_cuda.CLUSTER_BUILD_LAUNCHES == before


# ---------------------------------------------------------------------------
# Phase 2's kernel 10 (csrc/dc_assign.cu) as the card runs it
# ---------------------------------------------------------------------------


def _model_pack(st, width):
    """assign_cuda.pack's contract, computed by dc/assign_model.py."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am

    assign_cuda.PACK_LAUNCHES += 1
    arrays = {f: getattr(st, f).numpy()
              for f in ("e", "belong", "length", "rev", "cdis", "cid")}
    rec, first = am.pack(arrays, width)
    E = st.e.shape[0]
    data = torch.zeros((E, rec.shape[1]), dtype=torch.uint8)
    data[:rec.shape[0]] = torch.from_numpy(rec)
    meta = torch.tensor([rec.shape[0], first], dtype=torch.int32)
    return assign_cuda.Records(data, meta, am.id_bytes_of(width),
                               st.length.dtype, E)


def _model_assign(st, rows, out=None, *, records=None, **kw):
    """assign_cuda.assign's contract over the pack's records, computed by
    dc/assign_model.py."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am

    assert rows.device == st.e.device and rows.stride(-1) == 1
    assert records is not None and records.n_edges == st.e.shape[0]
    assert records.id_bytes == am.id_bytes_of(rows.shape[1])
    assign_cuda.ASSIGN_LAUNCHES += 1
    n, first = records.meta.tolist()
    got = torch.from_numpy(am.assign_records(records.data[:n].numpy(), first,
                                             rows.numpy()))
    if out is None:
        return got
    assert out.dtype == torch.int64 and out.shape == got.shape
    out.copy_(got)
    return out


def _phase2_line(log: str) -> tuple:
    m = re.search(r"DC phase 2: chunks=(\d+) rows_per_chunk=(\d+) "
                  r"kernel_launches=(\d+) host_syncs=(\d+) route=(\w+)", log)
    return int(m[1]), int(m[2]), int(m[3]), int(m[4]), m[5]


def _pack_launches(log: str) -> int:
    return int(re.search(r"DC phase 2: .* pack_launches=(\d+)", log)[1])


@pytest.mark.parametrize("case, knobs", [
    pytest.param("matrix", {"PHASE2_CHUNK": 48}, id="matrix-chunks"),
    pytest.param("matrix", {"PHASE2_BYTES": 1}, id="matrix-one_row"),
    pytest.param("mash", {"PHASE2_CHUNK": 29}, id="mash-chunks"),
    pytest.param("msa", {"PHASE2_CHUNK": 7}, id="msa-chunks"),
])
def test_phase2_card_route_with_model_as_kernel_equals_jax(
        request, capsys, monkeypatch, case, knobs):
    """Phase 2 as it runs on the card, on CPU tensors with the models of
    kernel 10 and its pack in their place: the state packed once, chunks
    sized from the [Q, B] rows' bytes (forced small here), one launch a
    chunk into one buffer; the log's phase-2 line counts them. The
    assignment md5 and the Newick are the JAX package's default, bit for
    bit (the matrix rows as strided views)."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.placement import kclosest as tk

    if case == "matrix":
        D, names, tp, want, debug = request.getfixturevalue("matrix320")
        run = (tpl.build_dc_tree_from_matrix, D, names, tp)
        want_md5, n, b = debug["assign_md5"], 320, 64
    elif case == "mash":
        names, seqs, tp, want, debug = request.getfixturevalue("mash150")
        run = (tpl.build_dc_tree, seqs, names, tp)
        want_md5, n, b = debug["assign_md5"], 150, 12
    else:
        names, seqs = simulate_alignment(50, 800, np.random.default_rng(5),
                                         gap_frac=0.03, blen_scale=0.5)
        jp, tp = _params(10, in_format="m", distance_type=2)
        want, want_md5 = _jax_run(capsys, jpl.build_dc_tree, seqs, names, jp)
        run = (tpl.build_dc_tree, seqs, names, tp)
        n, b = 50, 10
    for k, v in knobs.items():
        monkeypatch.setattr(tpl, k, v)
    monkeypatch.setattr(tk, "uses_assign_kernel", lambda st: True)
    monkeypatch.setattr(assign_cuda, "assign", _model_assign)
    monkeypatch.setattr(assign_cuda, "pack", _model_pack)
    before = assign_cuda.ASSIGN_LAUNCHES
    packs = assign_cuda.PACK_LAUNCHES
    got, got_md5, log = _port_run(*run)
    assert got == want and got_md5 == want_md5
    chunks, per, launches, syncs, route = _phase2_line(log)
    want_per = knobs.get("PHASE2_CHUNK", 1)
    assert per == want_per and chunks == -(-(n - b) // per) > 1
    assert launches == chunks == assign_cuda.ASSIGN_LAUNCHES - before
    assert _pack_launches(log) == 1 == assign_cuda.PACK_LAUNCHES - packs
    assert route == "kernel" and syncs == 0   # no card: no copy to sync


def test_phase2_cpu_route_line():
    """On the CPU phase 2 scores by the plain version, chunks sized from
    its [Q, E, K] gather, and launches no kernel."""
    D = _dc_matrix(90, 90)
    names = [f"L{i}" for i in range(90)]
    _, tp = _params(14, in_format="d")
    _, _, log = _port_run(tpl.build_dc_tree_from_matrix, D, names, tp)
    assert _phase2_line(log) == (1, tpl.PHASE2_CHUNK, 0, 0, "plain")
    assert _pack_launches(log) == 0
