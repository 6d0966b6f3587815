"""The port's exact placement (dipper_tpu_torch/placement/exact.py) on the
CPU against dipper_tpu/placement/exact.py: the same seeded matrices through
both, the state compared after every insertion, bit for bit in f64 (the
rows are the same numbers and the arithmetic is add, subtract, max and
x 0.5); `_compute_lims` alone on the reference's intermediate states, also
on rows with NaN and inf; the numpy oracle; chunking and checkpoints, which
either package resumes from the other."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipper_tpu.placement import exact as jexact
from dipper_tpu.placement import kclosest as jk
from dipper_tpu.utils.treecmp import rf_distance
from dipper_tpu_torch.placement import exact as texact
from dipper_tpu_torch.placement import kclosest as tk

from oracle import ExactPlacementOracle
from test_nj import random_additive_matrix

torch.set_num_threads(2)

CPU = torch.device("cpu")
INT_FIELDS = ("e", "belong", "rev", "parent", "dep", "idx")


def _matrix(n, seed, kind="additive"):
    rng = np.random.default_rng(seed)
    if kind == "tied":
        # few distinct values: equal candidates at the sweeps' top-2
        # statistics and equal scores at the argmin
        D = rng.integers(1, 5, (n, n)).astype(np.float64)
        D = np.triu(D, 1)
        D = (D + D.T) / 8.0
        return D
    D = random_additive_matrix(n, rng)
    if kind == "noisy":
        D += rng.uniform(0, 0.03, D.shape)
        D = (D + D.T) / 2
        np.fill_diagonal(D, 0)
    return D / (D.max() * 1.05)


def _kw(n, dtype="float64"):
    return dict(num_sequences=n, frontend="matrix", dtype_name=dtype)


def _assert_state_equal(got: texact.ExactState, want, where=""):
    host = tk.tree_state_to_numpy(got)
    want = jax.device_get(want)
    for f in INT_FIELDS + ("length",):
        w = np.asarray(getattr(want, f))
        assert host[f].dtype == w.dtype, (f, where)
        assert np.array_equal(host[f], w), (f, where)


CASES = [(4, "additive"), (8, "additive"), (20, "additive"),
         (45, "additive"), (20, "tied"), (20, "noisy")]


@pytest.mark.parametrize("n, kind", CASES)
def test_state_equal_after_every_insertion(n, kind):
    D = _matrix(n, n + 7, kind)
    Dj = jnp.asarray(D, jnp.float64)
    Dt = torch.from_numpy(D)
    sj = jexact.init_exact_state((Dj,), **_kw(n))
    st = texact.init_exact_state((Dt,), **_kw(n))
    _assert_state_equal(st, sj, "initial")
    for i in range(2, n):
        sj = jexact.run_exact_range(sj, jnp.int32(i), jnp.int32(i + 1),
                                    (Dj,), **_kw(n))
        texact.exact_insertion_step(st, Dt[i], i, n)
        _assert_state_equal(st, sj, f"insertion {i}")


@functools.partial(jax.jit, static_argnames=("N",))
def _jax_lims(st, row, N):
    return jexact._compute_lims(st, row, N)


@pytest.mark.parametrize("kind", ["additive", "tied", "specials"])
def test_compute_lims_on_reference_states(kind):
    """lim of the used slots equals the reference's, whose unused slots
    hold 0; rows with NaN, +inf and -inf give them in the same slots."""
    n = 20
    D = _matrix(n, 3, "tied" if kind == "tied" else "additive")
    Dj = jnp.asarray(D, jnp.float64)
    sj = jexact.init_exact_state((Dj,), **_kw(n))
    specials = False
    for i in range(2, n):
        row = D[i].copy()
        if kind == "specials":
            row[i % 3] = np.nan
            row[(i + 1) % 5] = np.inf
            row[(i + 2) % 7] = -np.inf
        want = np.asarray(_jax_lims(sj, jnp.asarray(row), n))
        st = texact.ExactState.from_numpy(jax.device_get(sj)._asdict(), CPU)
        got = texact._compute_lims(st, torch.from_numpy(row), n).numpy()
        assert got.shape == (st.idx,)
        assert np.array_equal(got, want[:st.idx], equal_nan=True), i
        assert not want[st.idx:].any()
        specials |= bool(np.isnan(got).any() and np.isinf(got).any())
        sj = jexact.run_exact_range(sj, jnp.int32(i), jnp.int32(i + 1),
                                    (Dj,), **_kw(n))
    assert specials == (kind == "specials")


def _port_edges(D, dtype="float64", **kw):
    n = D.shape[0]
    Dt = torch.from_numpy(D.astype(dtype))
    return [x.numpy() for x in texact.run_exact_placement(
        (Dt,), **_kw(n, dtype), **kw)]


@pytest.mark.parametrize("n", [4, 8, 20, 45])
def test_matches_oracle(n):
    """tests/test_exact_placement.py's comparison with the numpy oracle."""
    D = _matrix(n, n + 7)
    o = ExactPlacementOracle(n)
    o.run(lambda i: D[i])
    e, belong, length = _port_edges(D)
    used = belong >= 0
    m = used.sum()
    assert (np.asarray(o.e[:m]) == e[used]).all()
    assert (np.asarray(o.belong[:m]) == belong[used]).all()
    assert np.allclose(np.asarray(o.len[:m]), length[used], atol=1e-9)


def test_noisy_topology_matches_oracle():
    n = 20
    D = _matrix(n, 27, "noisy")
    o = ExactPlacementOracle(n)
    o.run(lambda i: D[i])
    names = [f"L{i}" for i in range(n)]
    got = tk.edges_to_newick(*_port_edges(D), names, n)
    assert rf_distance(got, o.to_newick(names))[0] == 0


def test_f32_tree_matches_reference():
    n = 45
    D = _matrix(n, 52)
    e, belong, length = jax.device_get(jexact.run_exact_placement(
        (jnp.asarray(D, jnp.float32),), **_kw(n, "float32")))
    names = [f"L{i}" for i in range(n)]
    want = jk.edges_to_newick(e, belong, length, names, n)
    got = tk.edges_to_newick(*_port_edges(D, "float32"), names, n)
    assert rf_distance(got, want)[0] == 0


def test_chunked_equals_one_shot_and_checkpoints_cross(tmp_path):
    """Chunked == one shot; a checkpoint written by either package resumes
    in the other to the same final state; mismatched fingerprints and
    k-closest checkpoints are refused."""
    n = 45
    D = _matrix(n, 17)
    Dj, Dt = jnp.asarray(D, jnp.float64), torch.from_numpy(D)
    want = jexact.run_exact_chunked((Dj,), chunk=n, **_kw(n))
    one = texact.run_exact_chunked((Dt,), chunk=n, **_kw(n))
    _assert_state_equal(one, want, "one shot")
    ck_p, ck_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    logs = []
    st = texact.run_exact_chunked((Dt,), chunk=7, save_state=ck_p,
                                  log=logs.append, **_kw(n))
    _assert_state_equal(st, want, "chunked")
    assert sum("Checkpointed" in ln for ln in logs) == len(range(7, n, 7)) + 1

    fp = {"frontend": "matrix", "dtype": "float64", "placement": "exact"}
    # the port's state at insertion 13 resumes in the reference ...
    st0 = texact.init_exact_state((Dt,), **_kw(n))
    texact.run_exact_range(st0, 2, 13, Dt[2:13], n)
    tk.save_tree_state(ck_p, st0, 13, n, fp)
    with np.load(ck_p) as d:
        assert str(d["state_kind"]) == "ExactState"
        assert d["idx"].dtype == np.int32 and d["idx"].shape == ()
    resumed_j = jexact.run_exact_chunked((Dj,), chunk=9, load_state=ck_p,
                                         **_kw(n))
    _assert_state_equal(one, resumed_j, "reference resumed the port's file")
    # ... and the reference's at insertion 13 in the port
    sj = jexact.init_exact_state((Dj,), **_kw(n))
    sj = jexact.run_exact_range(sj, jnp.int32(2), jnp.int32(13), (Dj,),
                                **_kw(n))
    jk.save_tree_state(ck_j, sj, 13, n, fp)
    logs = []
    resumed_p = texact.run_exact_chunked((Dt,), chunk=9, load_state=ck_j,
                                         log=logs.append, **_kw(n))
    _assert_state_equal(resumed_p, want, "the port resumed the reference's")
    assert any("Resumed exact placement at insertion 13/45" in ln
               for ln in logs)

    with pytest.raises(SystemExit, match="fingerprint"):
        texact.run_exact_chunked((Dt,), chunk=9, load_state=ck_j,
                                 fingerprint={"names_sha256": "deadbeef"},
                                 **_kw(n))
    # a k-closest TreeState checkpoint must be refused by the exact loader,
    # and an exact one by the k-closest loader
    kck = str(tmp_path / "kclosest.npz")
    tk.save_tree_state(kck, tk.init_placement_state((Dt,), **_kw(n)), 2, n,
                       fp)
    with pytest.raises(SystemExit, match="ExactState"):
        texact.run_exact_chunked((Dt,), chunk=9, load_state=kck, **_kw(n))
    with pytest.raises(SystemExit, match="TreeState"):
        tk.run_placement_chunked((Dt,), chunk=9, load_state=ck_j, **_kw(n))


@pytest.mark.parametrize("frontend", ["matrix", "mash", "msa"])
def test_api_exact_three_frontends(frontend, tmp_path):
    """build_placement_tree_from_*(exact=True) against the reference's, in
    f64: identical Newick from the matrix and from mash (the same rows
    bit for bit); from -i m the same tree with branch lengths to rtol
    1e-9 (the rows come from each package's own log)."""
    from dipper_tpu.placement import api as japi
    from dipper_tpu.utils.params import Param as JaxParam
    from dipper_tpu_torch.placement import api as tapi
    from dipper_tpu_torch.utils.params import Param
    from datagen import simulate_alignment, simulate_unaligned
    from test_torch_cli import assert_newick_close

    n = 20
    rng = np.random.default_rng(61)
    kw = dict(dtype="float64", kmer_size=12, sketch_size=150,
              distance_type=2)
    if frontend == "matrix":
        D = _matrix(n, 61)
        names = [f"L{i}" for i in range(n)]
        want = japi.build_placement_tree_from_matrix(
            D, names, JaxParam(in_format="d", **kw), exact=True)
        got = tapi.build_placement_tree_from_matrix(
            D, names, Param(in_format="d", **kw), device=CPU, exact=True)
    else:
        fmt = "r" if frontend == "mash" else "m"
        names, seqs = (simulate_unaligned(n, 1500, rng) if fmt == "r"
                       else simulate_alignment(n, 300, rng))
        want = japi.build_placement_tree_from_seqs(
            seqs, names, JaxParam(in_format=fmt, **kw), exact=True)
        got = tapi.build_placement_tree_from_seqs(
            seqs, names, Param(in_format=fmt, **kw), device=CPU, exact=True)
    if frontend == "msa":
        assert_newick_close(got, want)
    else:
        assert got == want
