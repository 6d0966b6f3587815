"""The port's sharded builds (dipper_tpu_torch.parallel, and NJ's and
D&C's mesh paths) on gloo groups of 2 and 3 CPU processes
(tests/torch_ranks.py), against the port's single-process builds and the
JAX package's sharded builds on the 8 virtual CPU devices that
tests/conftest.py sets, on tests/test_sharded.py's inputs and sizes.

Tolerance 0 throughout: the sharded mash matrix, the placement arrays,
NJ's joins and branch lengths and D&C's Newick bytes equal the port's
single-process results bit for bit, on every rank. Against the JAX
package: the placement arrays bit for bit, the matrix where the walk is
symmetric (JAX's sharded matrix is unmirrored), NJ's join sequence (JAX
promises its lengths to ULPs only), D&C's bytes. Kernel
3's plain version scored by slot ranges and merged in the kernel's order
equals the full call, with ties and NaN across range borders."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dipper_tpu.dc import build_dc_tree_from_matrix as jax_dc
from dipper_tpu.nj import neighbor_joining_device
from dipper_tpu.parallel import make_mesh as jax_mesh
from dipper_tpu.parallel import sharded_mash_matrix as jax_matrix
from dipper_tpu.parallel import sharded_placement_build as jax_placement
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu.utils.params import Param as JaxParam
from dipper_tpu_torch.dc import pipeline as tpl
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.nj import neighbor_joining
from dipper_tpu_torch.parallel.sharded import merge_choices
from dipper_tpu_torch.placement import kclosest as tk
from dipper_tpu_torch.placement import score_model as sm
from dipper_tpu_torch.utils.params import Param

from datagen import simulate_unaligned
from test_nj import random_additive_matrix
from torch_ranks import run_group

torch.set_num_threads(2)

CPU = torch.device("cpu")
WORLDS = [2, 3]
# placement sizes: 32 splits evenly over 2 ranks, 27 over 3, neither over
# the other
PLACEMENT = {"p32": (32, 1200, 1, 12, 120), "p27": (27, 900, 2, 12, 100)}
DC_KNOBS = {"PHASE2_CHUNK": 48, "PHASE3_BUDGET": 24,
            "_STREAM_CLUSTER_MIN": 9, "_STREAM_ROW_BLOCK": 5}


def _sketches(n, L, seed, k, ss):
    _, seqs = simulate_unaligned(n, L, np.random.default_rng(seed))
    return np.asarray(sketch_sequences(seqs, k, ss))


def _dc_matrix_60():
    """tests/test_sharded.py::test_sharded_dc_matches_single's matrix."""
    rng = np.random.default_rng(7)
    D = np.abs(rng.normal(0.3, 0.1, size=(60, 60)))
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0.0)
    return D


def _dc_matrix_320():
    """tests/test_torch_dc.py's multi-chunk input."""
    rng = np.random.default_rng(11)
    D = random_additive_matrix(320, rng)
    D += rng.uniform(0, 0.02, D.shape)
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0)
    return D / (D.max() * 1.05)


def _nj_matrices():
    ties = np.ones((40, 40)) - np.eye(40)              # every Q ties
    nan = random_additive_matrix(60, np.random.default_rng(3))
    for i, j in ((5, 17), (30, 2), (44, 59)):
        nan[i, j] = nan[j, i] = np.nan
    return {"nj150": random_additive_matrix(150, np.random.default_rng(5)),
            "nj_ties": ties, "nj_nan": nan}


@pytest.fixture(scope="module")
def inputs():
    cases = {"host": {"kind": "to_host"}}
    sk = _sketches(24, 800, 0, 12, 100)
    cases["matrix"] = {"kind": "matrix", "sketches": sk, "k": 12, "ss": 100,
                       "ranks": tm.pad_ranks(tm.rank_compress_host(sk))}
    # duplicate-heavy rank rows, on which the walk counts some pairs
    # differently in the two orientations
    adv = np.sort(np.random.default_rng(8).integers(0, 60, (21, 64)), axis=1)
    cases["matrix_asym"] = {"kind": "matrix", "k": 12, "ss": 64,
                            "ranks": adv.astype(np.int32)}
    for name, (n, L, seed, k, ss) in PLACEMENT.items():
        cases[name] = {"kind": "placement", "k": k, "ss": ss,
                       "sketches": _sketches(n, L, seed, k, ss),
                       "dtype": "float64"}
    for name, D in _nj_matrices().items():
        cases[name] = {"kind": "nj", "D": D, "dtype": "float64"}
    cases["dc60"] = {"kind": "dc", "D": _dc_matrix_60(), "b": 12}
    cases["dc320"] = {"kind": "dc", "D": _dc_matrix_320(), "b": 64,
                      **DC_KNOBS}
    return cases


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each world size's results: a list of per-rank dicts."""
    return {w: run_group(w, inputs, tmp_path_factory.mktemp(f"w{w}"))
            for w in WORLDS}


def _every_rank(results, case, key):
    """The one value that every rank returned for case.key."""
    first = results[0][case][key]
    for r in results[1:]:
        assert np.array_equal(r[case][key], first, equal_nan=first.dtype.kind
                              == "f"), (case, key)
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_to_host_brings_one_ranks_tensors_to_every_rank(ranks, world):
    for r in ranks[world]:
        np.testing.assert_array_equal(r["host"]["a"], np.full(3, world - 1.0))
        np.testing.assert_array_equal(r["host"]["b"], np.arange(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["matrix", "matrix_asym"])
def test_sharded_matrix_equals_single_and_jax(inputs, ranks, name, world):
    """The single-process matrix's bytes. JAX's sharded matrix leaves the
    walk's orientation unmirrored, so it is the same matrix where the
    walk is symmetric, as on tests/test_sharded.py's sketches."""
    c = inputs[name]
    got = _every_rank(ranks[world], name, "D")
    single = tm.mash_distance_matrix(c["ranks"], c["k"], c["ss"], "float64",
                                     CPU).numpy()
    assert got.dtype == np.float64 and np.array_equal(got, single)
    r = torch.from_numpy(c["ranks"])
    inter = tm.merged_inter_count_ref(r, r, sketch_size=c["ss"])
    if name == "matrix_asym":
        assert not torch.equal(inter, inter.T)
    else:
        assert torch.equal(inter, inter.T)
        want = np.asarray(jax_matrix(jnp.asarray(c["ranks"]), c["k"],
                                     c["ss"], jax_mesh(), dtype="float64"))
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def jax_placements(inputs):
    return {name: jax_placement(inputs[name]["sketches"], inputs[name]["k"],
                                inputs[name]["ss"], jax_mesh(),
                                dtype="float64")
            for name in PLACEMENT}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(PLACEMENT))
def test_sharded_placement_equals_single_and_jax(inputs, ranks,
                                                 jax_placements, name, world):
    c = inputs[name]
    n = c["sketches"].shape[0]
    got = [_every_rank(ranks[world], name, f)
           for f in ("e", "belong", "length")]
    ranks_t = torch.from_numpy(tm.pad_ranks(tm.rank_compress_host(
        c["sketches"])))
    single = tk.run_placement((ranks_t,), num_sequences=n, frontend="mash",
                              frontend_static=(c["k"], c["ss"]),
                              dtype_name="float64")
    for g, s, j in zip(got, single, jax_placements[name]):
        assert g.dtype == s.numpy().dtype and np.array_equal(g, s.numpy())
        assert np.array_equal(g, np.asarray(j))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(_nj_matrices()))
def test_sharded_nj_equals_single(inputs, ranks, name, world):
    D = inputs[name]["D"]
    N = D.shape[0]
    ids = _every_rank(ranks[world], name, "ids")
    bl = _every_rank(ranks[world], name, "bl")
    ch, root = neighbor_joining(D, dtype_name="float64", device="cpu")
    assert int(_every_rank(ranks[world], name, "root")) == root
    assert ids.tolist() == [[c for c, _ in v] for v in ch[N:2 * N - 1]]
    want = np.array([[b for _, b in v] for v in ch[N:2 * N - 1]])
    assert np.array_equal(bl, want, equal_nan=True)
    assert np.array_equal(np.signbit(bl), np.signbit(want))
    if name == "nj150":
        jch, jroot = neighbor_joining_device(D, dtype="float64",
                                             mesh=jax_mesh())
        assert jroot == root
        assert ids.tolist() == [[c for c, _ in v] for v in jch[N:2 * N - 1]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["dc60", "dc320"])
def test_sharded_dc_equals_single_and_jax(inputs, ranks, monkeypatch, name,
                                          world):
    c = inputs[name]
    D, b = c["D"], c["b"]
    names = [f"L{i}" for i in range(D.shape[0])]
    got = str(_every_rank(ranks[world], name, "newick"))
    for knob in DC_KNOBS:
        if knob in c:
            monkeypatch.setattr(tpl, knob, c[knob])
    single = tpl.build_dc_tree_from_matrix(
        D, names, Param(in_format="d", dtype="float64", backbone_size=b,
                        batch_size=b), device=CPU, log=lambda m: None)
    assert got == single
    jp = JaxParam(in_format="d", dtype="float64", backbone_size=b,
                  batch_size=b)
    assert got == jax_dc(D, names, jp, mesh=jax_mesh())
    if name == "dc320":
        log = str(ranks[world][0][name]["log"])
        assert "path=stream" in log and "path=batch" in log


# ---------------------------------------------------------------------------
# Kernel 3's plain version by slot ranges (one process)
# ---------------------------------------------------------------------------


def _bits(x):
    a = np.asarray(x)
    return bool(np.isnan(a)), a.view(f"i{a.itemsize}").item()


def _same_six(got, want):
    assert tuple(got[:4]) == tuple(want[:4])
    for g, w in zip(got[4:], want[4:]):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert _bits(g) == _bits(w)


def _merged(st, row, bounds):
    """score_edges over each range of `bounds`, merged as the sharded
    build merges the ranks' choices."""
    outs = [tk.score_edges(st, row, lo=lo, hi=hi)
            for lo, hi in zip(bounds[:-1], bounds[1:])]
    trios = np.array([[float(o[5]), o[0]] for o in outs])
    return outs[merge_choices(trios)], outs


def _borders(st, extra=()):
    """Splits of [0, E) into 2 and 3 even ranges, and ranges with borders
    on the given slots, on n_used and inside the unused tail."""
    E, n_used = st.e.shape[0], st.idx
    out = [{0, -(-E // 2), E}, {0, -(-E // 3), 2 * -(-E // 3), E}]
    out += [{0, s, s + 1, E} for s in extra]
    if n_used < E:
        out += [{0, n_used, E}, {0, max(1, n_used - 1), n_used + 1, E},
                {0, n_used, (n_used + E) // 2, E}]
    return [sorted(b - {E + 1}) for b in out]


CASES = [c[0] for c in sm.made_up_cases("float32")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", CASES)
def test_score_ranges_merge_to_the_full_call(name, dtype):
    _, d, row, expected = next(c for c in sm.made_up_cases(dtype)
                               if c[0] == name)
    st = tk.tree_state_from_numpy(d, CPU)
    r = torch.from_numpy(row)
    full = tk.score_edges(st, r)
    # borders at the winner (the first NaN in the NaN cases) and just
    # before it, and between the two tied edges of the tie cases
    extra = [full[0], max(0, full[0] - 1)]
    if name.startswith("tie"):
        extra.append(int(np.flatnonzero(d["belong"] > d["e"])[60]))
    for bounds in _borders(st, extra):
        merged, outs = _merged(st, r, bounds)
        _same_six(merged, full)
        for (lo, hi), out in zip(zip(bounds[:-1], bounds[1:]), outs):
            assert lo <= out[0] < hi
            _same_six(sm.score_edges_model(st, r, lo=lo, hi=hi), out)


def test_score_ranges_on_a_built_state():
    """A state with an unused tail from a build of 280 of 300 taxa: every
    split merges to the full call, for the rows of the 20 taxa left."""
    n = 300
    D = random_additive_matrix(n, np.random.default_rng(n))
    D = D / (D.max() * 1.05)
    Dt = torch.from_numpy(D)
    st = tk.init_placement_state((Dt,), num_sequences=n, frontend="matrix",
                                 dtype_name="float64")
    tk._insert_range(st, 2, n - 20, Dt[2:], n)
    for i in range(n - 20, n):
        full = tk.score_edges(st, Dt[i])
        for bounds in _borders(st, [full[0]]):
            _same_six(_merged(st, Dt[i], bounds)[0], full)


def test_score_range_rejects_an_empty_or_outside_range():
    _, d, row, _ = sm.made_up_cases("float32")[0]
    st = tk.tree_state_from_numpy(d, CPU)
    E = st.e.shape[0]
    for lo, hi in ((5, 5), (-1, 4), (0, E + 1), (9, 3)):
        with pytest.raises(ValueError, match="slot range"):
            tk.score_edges(st, torch.from_numpy(row), lo=lo, hi=hi)


def test_backend_is_nccl_only_for_distinct_cards():
    from dipper_tpu_torch.parallel.distributed import backend_for

    assert backend_for(["GPU-a", "GPU-b", "GPU-c"]) == "nccl"
    assert backend_for(["GPU-a", "GPU-a"]) == "gloo"   # two ranks, one card
    assert backend_for(["GPU-a", "GPU-b", "GPU-a"]) == "gloo"
    assert backend_for(["cpu", "cpu"]) == "gloo"
