"""Mash intersection counts, distances and the NJ distance matrix: the
port vs the JAX package and the serial-walk oracle. Counts are integers
and must be bitwise equal; distances come from the same host table, so
they are bitwise equal given equal counts, and so is the matrix. The
kernel-vs-plain checks are in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dipper_tpu.distance import mash as jm
from dipper_tpu.distance.mash_pallas import (mash_inter_pallas,
                                             mash_rows_vs_bank_pallas)
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.distance import mash_cuda

import oracle
from datagen import simulate_unaligned
from test_mash import _walk_inter
from test_torch_cuda import _adversarial

torch.set_num_threads(2)


def _ranks(n, L, seed, k, ss):
    _, seqs = simulate_unaligned(n, L, np.random.default_rng(seed))
    sk = np.asarray(sketch_sequences(seqs, k, ss))
    return tm.pad_ranks(tm.rank_compress_host(sk))


# pow2 sketch (no pad columns) and non-pow2 sketch (pad columns + cutoff)
SKETCHES = [pytest.param(12, 128, id="pow2_s128"),
            pytest.param(11, 100, id="nonpow2_s100")]


@pytest.mark.parametrize("k, ss", SKETCHES)
def test_counts_match_jax_vmap(k, ss):
    r = _ranks(40, 900, 3, k, ss)
    got = tm.mash_pairwise_inter(torch.from_numpy(r), torch.from_numpy(r),
                                 sketch_size=ss)
    want = np.asarray(jm.mash_pairwise_inter(
        jnp.asarray(r), jnp.asarray(r), sketch_size=ss, impl="vmap"))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k, ss", SKETCHES)
def test_counts_match_pallas_interpret(k, ss):
    r = _ranks(24, 700, 4, k, ss)
    bank, qry = r, r[[0, 5, 23, 7, 11, 2, 19, 13, 1]]  # 9: not a multiple of 8
    got = tm.mash_pairwise_inter(torch.from_numpy(bank), torch.from_numpy(qry),
                                 sketch_size=ss)
    want = np.asarray(mash_inter_pallas(
        jnp.asarray(bank * 2 + 1), jnp.asarray(qry * 2), sketch_size=ss,
        block_rows=8, interpret=True))
    assert np.array_equal(got.numpy(), want)


def _adversarial_pair(seed, S=100, M=128):
    rng = np.random.default_rng(seed)
    # small value universe: many duplicates and cross-duplicates
    a = np.sort(rng.integers(0, 60, S))
    b = np.sort(rng.integers(0, 60, S))
    if seed % 2:  # sentinel-heavy tails
        a[-30:] = 59
        b[-45:] = 59
    pad = np.full(M - S, (tm._PAD_KEY - 1) // 2)
    return (a, b, np.concatenate([a, pad]).astype(np.int32),
            np.concatenate([b, pad]).astype(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_counts_match_serial_walk(seed):
    a, b, a_pad, b_pad = _adversarial_pair(seed)
    got = tm.merged_inter_count_ref(torch.from_numpy(a_pad[None]),
                                    torch.from_numpy(b_pad[None]),
                                    sketch_size=100)
    assert int(got[0, 0]) == _walk_inter(a, b, 100)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_distances_bitwise_through_table(dtype):
    r = _ranks(30, 800, 5, 12, 100)
    got = tm.mash_pairwise(torch.from_numpy(r), torch.from_numpy(r[3:17]),
                           k=12, sketch_size=100, dtype_name=dtype)
    want = np.asarray(jm.mash_pairwise(
        jnp.asarray(r), jnp.asarray(r[3:17]), k=12, sketch_size=100,
        dtype_name=dtype, impl="vmap"))
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def test_query_chunking_is_exact(monkeypatch):
    """The plain version's query chunks (bounding its [Q, N, 2M]
    transient) do not change counts."""
    r = torch.from_numpy(_ranks(20, 600, 6, 11, 100))
    whole = tm.merged_inter_count_ref(r, r, sketch_size=100)
    monkeypatch.setattr(tm, "_REF_CHUNK_BYTES", 1)
    assert torch.equal(tm.merged_inter_count_ref(r, r, sketch_size=100),
                       whole)


def test_cpu_tensors_take_the_plain_version():
    r = torch.from_numpy(_ranks(10, 500, 7, 11, 100))
    before = mash_cuda.LAUNCHES
    tm.mash_pairwise_inter(r, r, sketch_size=100)
    assert mash_cuda.LAUNCHES == before


def test_kernel_wrapper_rejects_bad_inputs():
    """The wrapper validates before any build or launch."""
    r = torch.from_numpy(_ranks(10, 500, 7, 11, 100))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mash_cuda.mash_inter_cuda(r, r, sketch_size=100)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k, ss", SKETCHES)
def test_rows_vs_bank_match_pallas_interpret(k, ss, dtype):
    """The distance kernel's plain version against the TPU kernel it
    ports, run in interpret mode: [Q, M] queries and a single [M] row."""
    r = _ranks(24, 700, 8, k, ss)
    bank, qry = r, r[[3, 0, 22, 9, 14, 6, 17, 1, 20]]  # 9: not a multiple of 8
    for q in (qry, qry[4]):
        got = tm.mash_rows_vs_bank(torch.from_numpy(bank), torch.from_numpy(q),
                                   k=k, sketch_size=ss, dtype_name=dtype)
        want = np.asarray(mash_rows_vs_bank_pallas(
            jnp.asarray(bank), jnp.asarray(q), k=k, sketch_size=ss,
            dtype_name=dtype, interpret=True))
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k, ss", SKETCHES)
def test_distance_matrix_matches_jax_device(k, ss, dtype):
    """The port ranks on the host (rank_compress_host), the JAX NJ path on
    the device (rank_compress): the matrices are bitwise equal."""
    _, seqs = simulate_unaligned(45, 900, np.random.default_rng(9))
    sk = np.asarray(sketch_sequences(seqs, k, ss))
    want = np.asarray(jm.mash_distance_matrix_device(sk, k, ss, dtype=dtype))
    ranks = tm.pad_ranks(tm.rank_compress_host(sk))
    got = tm.mash_distance_matrix(ranks, k, ss, dtype, "cpu")
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.diag(want), np.zeros(45))


def test_distance_matrix_row_blocks_are_exact(monkeypatch):
    """Filling the matrix in blocks of query rows changes nothing."""
    r = _ranks(30, 600, 10, 11, 100)
    whole = tm.mash_distance_matrix(r, 11, 100, "float32", "cpu")
    monkeypatch.setattr(tm, "MATRIX_ROW_BLOCK", 7)
    assert torch.equal(tm.mash_distance_matrix(r, 11, 100, "float32", "cpu"),
                       whole)


def test_cpu_distances_take_the_plain_version():
    r = torch.from_numpy(_ranks(10, 500, 7, 11, 100))
    before = mash_cuda.ROWS_DIST_LAUNCHES
    out = torch.full((10, 10), -1.0)
    got = tm.mash_pairwise(r, r, k=11, sketch_size=100, dtype_name="float32",
                           out=out)
    assert got is out and mash_cuda.ROWS_DIST_LAUNCHES == before
    assert torch.equal(out, tm.mash_rows_vs_bank(r, r, k=11, sketch_size=100,
                                                 dtype_name="float32"))


def test_distance_kernel_wrapper_rejects_cpu_tensors():
    r = torch.from_numpy(_ranks(10, 500, 7, 11, 100))
    table = torch.from_numpy(tm._dist_table(11, 100, "float32"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mash_cuda.mash_rows_dist_cuda(r, r, table, sketch_size=100)


@pytest.mark.parametrize("dtype, limit", [(None, 19367), ("float32", 14523),
                                          ("float64", 11619)])
def test_kernel_sketch_size_limits(dtype, limit):
    """The distance table, one query row and two bank rows of s + 1 ranks
    and one result in a block's 232,448 bytes of shared memory."""
    assert mash_cuda.max_sketch_size(dtype) == limit
    item = None if dtype is None else np.dtype(dtype).itemsize
    assert mash_cuda._smem_bytes(limit, item) <= 232448
    assert mash_cuda._smem_bytes(limit + 1, item) > 232448
    table = 0 if item is None else 16 * -(-item * (limit + 1) // 16)
    assert mash_cuda._smem_bytes(limit, item) == (
        table + 3 * 16 * -(-(limit + 1) // 4) + (item or 4))


# The kernels' algorithm (csrc/mash_walk.cuh: the walk split over the lanes
# of a warp by merge path, rounds of steps that are certain to run, the stop
# found from the lanes' step bits) as tm.partitioned_walk_inter, against
# the serial walk. Exact equality everywhere.

LANES = [1, 2, 32]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("seed", range(6))
def test_partitioned_walk_matches_serial_walk(seed, lanes):
    a, b, _, _ = _adversarial_pair(seed)
    assert (tm.partitioned_walk_inter(a, b, 100, lanes)
            == _walk_inter(a, b, 100))


@pytest.mark.parametrize("k, ss", SKETCHES + [pytest.param(15, 1000,
                                                           id="s1000")])
def test_partitioned_walk_on_real_sketches(k, ss):
    """Real sketches: the model, the serial-walk oracle and the plain
    PyTorch version agree on every pair, and the oracle's distance is the
    table entry of the model's count."""
    n = 6 if ss == 1000 else 12
    r = _ranks(n, 3000 if ss == 1000 else 900, 11, k, ss)
    plain = tm.merged_inter_count_ref(torch.from_numpy(r), torch.from_numpy(r),
                                      sketch_size=ss).numpy()
    table = tm._dist_table(k, ss, "float64")
    for q in range(n):
        for a in range(n):
            got = tm.partitioned_walk_inter(r[a], r[q], ss)
            assert got == _walk_inter(r[a], r[q], ss) == plain[q, a]
            assert np.isclose(table[got],
                              oracle.mash_distance(r[a], r[q], k, ss),
                              rtol=1e-12, atol=0)
    assert plain.max() == ss and plain.min() < ss


@pytest.mark.parametrize("lanes", LANES)
def test_partitioned_walk_adversarial_rows(lanes):
    """The card tests' duplicate- and sentinel-heavy rows, pads included."""
    rng = np.random.default_rng(1)
    bank = _adversarial(9, 100, 128, rng)
    qry = _adversarial(5, 100, 128, rng)
    plain = tm.merged_inter_count_ref(torch.from_numpy(bank),
                                      torch.from_numpy(qry),
                                      sketch_size=100).numpy()
    for q in range(5):
        for a in range(9):
            assert (tm.partitioned_walk_inter(bank[a], qry[q], 100, lanes)
                    == plain[q, a] == _walk_inter(bank[a], qry[q], 100))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("ss", [1, 31, 32, 33, 100, 1000])
def test_partitioned_walk_equal_runs_straddle_splits(ss, lanes):
    """Runs of one value on both sides, longer than a lane's steps, so that
    lanes' splits fall inside them; B all equal to A's head (every B copy
    matches and uni stays 0 for sketch_size steps); identical rows."""
    run = max(1, ss // 3)
    a = np.sort(np.concatenate([np.arange(ss - run), np.full(run, ss // 2)]))
    b = np.sort(np.concatenate([np.arange(0, 2 * (ss - run), 2),
                                np.full(run, ss // 2)]))
    pad = (tm._PAD_KEY - 1) // 2
    for x, y in ((a, b), (b, a), (a, a), (a, np.full(ss, a[0])),
                 (np.full(ss, 7), np.full(ss, 7)),
                 (np.full(ss, pad), np.full(ss, pad)),
                 (a, np.full(ss, pad)), (np.full(ss, pad), b)):
        assert (tm.partitioned_walk_inter(x, y, ss, lanes)
                == _walk_inter(x, y, ss))


def _rows(draw, ss):
    """Two ascending rows of ss ranks from a universe small enough for
    duplicates and cross-duplicates, each with a tail of pad ranks."""
    hi = draw(st.sampled_from([2, 7, max(2, ss // 2), 4 * ss + 5, 2**30 - 1]))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, hi, (2, ss)), axis=1)
    for row in rows:
        pads = draw(st.integers(0, ss)) if draw(st.booleans()) else 0
        row[ss - pads:] = (tm._PAD_KEY - 1) // 2
    if draw(st.booleans()):  # a shared run of one value
        v, n = int(rows[0, ss // 2]), draw(st.integers(1, ss))
        rows[1, :n] = v
        rows[1].sort()
    return rows[0], rows[1]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("ss", [1, 31, 32, 33, 100, 1000])
@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_partitioned_walk_hypothesis(ss, lanes, data):
    a, b = data.draw(st.composite(_rows)(ss))
    max_steps = data.draw(st.sampled_from([26, 32, 1, 5]))
    assert (tm.partitioned_walk_inter(a, b, ss, lanes, max_steps)
            == _walk_inter(a, b, ss))
