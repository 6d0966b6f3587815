"""Divide-and-conquer in the port (dipper_tpu_torch.dc) against the JAX
package (dipper_tpu.dc) on the CPU, on the inputs of tests/test_dc.py.

Tolerance 0 throughout: f64 Newick bytes are equal, `last_debug`'s edge
arrays (node ids, branch lengths) equal bit for bit, phase 2's
assignment equal (its md5 in the log line of both packages). Forced
paths (several phase-2 blocks, several builds a bucket, streamed
clusters with a ragged last row block) are held to the JAX default
output, so each path is checked against the reference and not only
against the port's other paths."""

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
    want = jpl.build_dc_tree_from_matrix(D, names, jp)
    return D, names, tp, want, dict(jpl.last_debug)


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
    want = jpl.build_dc_tree(seqs, names, jp)
    return names, seqs, tp, want, dict(jpl.last_debug)


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
    """score_edges_rows == a loop of score_edges, on the scorer's made-up
    states (ties between two valid edges, NaN and inf in rows, unused
    tails) and on a state built from a matrix."""
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
        got = tk.score_edges_rows(st, torch.from_numpy(rows))
        want = [tk.score_edges(st, torch.from_numpy(r))[0] for r in rows]
        assert got.tolist() == want, name


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
