"""Mash intersection counts, distances and the NJ distance matrix: the
port vs the JAX package and the serial-walk oracle. Counts are integers
and must be bitwise equal; distances come from the same host table, so
they are bitwise equal given equal counts, and so is the matrix. The
kernel-vs-plain checks are in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dipper_tpu.distance import mash as jm
from dipper_tpu.distance.mash_pallas import (mash_inter_pallas,
                                             mash_rows_vs_bank_pallas)
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.distance import mash_cuda

from datagen import simulate_unaligned
from test_mash import _walk_inter

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


@pytest.mark.parametrize("dtype, limit", [(None, 12288), ("float32", 6143),
                                          ("float64", 4095)])
def test_kernel_sketch_size_limits(dtype, limit):
    """One query row (and the distance table) in 48 KB of shared memory."""
    assert mash_cuda.max_sketch_size(dtype) == limit
    item = 0 if dtype is None else np.dtype(dtype).itemsize
    assert 4 * limit + item * (limit + 1) <= 48 * 1024
    assert 4 * (limit + 1) + item * (limit + 2) > 48 * 1024
