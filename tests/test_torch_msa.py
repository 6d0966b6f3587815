"""The port's MSA distances (dipper_tpu_torch/distance/msa.py) on the CPU
against dipper_tpu/distance/msa.py and the numpy oracle, on seeded
alignments: the 5 x 5 pair counts bitwise against an int64 numpy count;
the six models in f64 (rtol 1e-12) and f32 (rtol 2e-6: the packages' log
and sqrt may differ in the last place, every other operation is the same
in the same order), NaN and +-inf in the same places."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipper_tpu.distance import msa as jmsa
from dipper_tpu.io.encode import batch_codes, encode_4bit_codes
from dipper_tpu_torch.distance import msa as tmsa

from datagen import simulate_alignment
from oracle import msa_distance_matrix as oracle_matrix

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL = {"float64": 1e-12, "float32": 2e-6}


def _codes(n, L, seed, gap_frac):
    _, seqs = simulate_alignment(n, L, np.random.default_rng(seed),
                                 gap_frac=gap_frac)
    return batch_codes(seqs, encode_4bit_codes, pad_value=4)[0]


def _hard_codes(seed=5):
    """An alignment with unrelated sequences (log of a negative: NaN), an
    all-gap sequence (0/0, x/0) and two identical ones."""
    rng = np.random.default_rng(seed)
    codes = _codes(10, 203, seed, 0.08)
    rand = rng.integers(0, 4, (6, 203)).astype(np.uint8)
    rand[3] = rand[2] ^ 1          # every column a transversion or A<->C
    allgap = np.full((1, 203), 4, np.uint8)
    return np.concatenate([codes, rand, allgap, codes[:1]], axis=0)


def _same_specials(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))


# The divergent pairs of _hard_codes sit beside the formulas' poles: the
# log's argument 1 - pp/c - qq cancels down to 3e-3 there, which amplifies
# a last-place difference of the packages' arithmetic some 300 times. In
# f32 those pairs are held to this; f64 and every simulated alignment keep
# RTOL.
RTOL_NEAR_POLE_F32 = 2e-5


def _close(got, want, dtype, rtol=None):
    _same_specials(got, want)
    assert got.dtype == want.dtype == np.dtype(dtype)
    with np.errstate(invalid="ignore"):
        assert np.allclose(got, want, rtol=rtol or RTOL[dtype], atol=0,
                           equal_nan=True), np.nanmax(np.abs(got - want))


@pytest.mark.parametrize("gap_frac", [0.0, 0.08])
def test_pair_counts_equal_int64_count(gap_frac):
    codes = _codes(13, 301, 3, gap_frac)
    phi = jmsa.build_channels(codes).astype(np.int64)
    want = np.einsum("ial,jbl->iajb", phi[:7], phi)
    got = tmsa.pair_counts(
        tmsa.one_hot_channels(torch.from_numpy(codes[:7])),
        tmsa.one_hot_channels(torch.from_numpy(codes)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_channels_equal_reference():
    codes = _hard_codes()
    want = jmsa.build_channels(codes)
    assert np.array_equal(tmsa.build_channels(codes), want)
    got = tmsa.one_hot_channels(torch.from_numpy(codes))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(
        np.asarray(jmsa.one_hot_channels(jnp.asarray(codes))), want)


def test_too_long_alignment_is_refused():
    phi = torch.zeros((1, 5, 1), dtype=torch.int8).expand(
        1, 5, tmsa.MAX_COLUMNS + 1)  # a view: 5 bytes
    with pytest.raises(ValueError, match="longer than"):
        tmsa.pair_counts(phi, phi)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("gap_frac", [0.0, 0.08])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
def test_matrix_matches_reference(dt, gap_frac, dtype):
    codes = _codes(21, 400, 10 + dt, gap_frac)
    want = np.asarray(jmsa.msa_distance_matrix_device(codes, dt, dtype=dtype,
                                                      row_block=8))
    got = tmsa.msa_distance_matrix(codes, dt, dtype, CPU, row_block=8).numpy()
    _close(got, want, dtype)
    assert np.array_equal(np.diag(got), np.zeros(21, dtype))


@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
def test_matrix_matches_oracle(dt):
    """tests/test_msa_distance.py's comparison, at its tolerance."""
    codes = _codes(12, 400, dt, 0.08)
    got = tmsa.msa_distance_matrix(codes, dt, "float64", CPU).numpy()
    assert np.allclose(got, oracle_matrix(codes, dt), rtol=1e-12, atol=1e-12,
                       equal_nan=True)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
def test_hard_pairs_keep_nan_and_inf(dt, dtype):
    """Divergent, all-gap and identical pairs: NaN, +inf and -inf where
    the reference has them, in the matrix and in placement's rows."""
    codes = _hard_codes()
    rtol = RTOL_NEAR_POLE_F32 if dtype == "float32" else None
    want = np.asarray(jmsa.msa_distance_matrix_device(codes, dt, dtype=dtype))
    got = tmsa.msa_distance_matrix(codes, dt, dtype, CPU).numpy()
    _close(got, want, dtype, rtol)
    if dt != 1:
        assert np.isnan(got).any() or np.isinf(got).any()

    ct = torch.from_numpy(codes)
    ng = tmsa.nongap_counts(ct, dtype)
    rows = tmsa.msa_tiled_block(ct[9:], ng[9:], ct, ng, distance_type=dt,
                                dtype_name=dtype, bank_tile=7, row_block=4)
    cj = jnp.asarray(codes)
    ngj = jnp.asarray((codes < 4).sum(axis=1), jnp.dtype(dtype))
    want_rows = np.asarray(jmsa.msa_tiled_block(
        cj[9:], ngj[9:], cj, ngj, distance_type=dt, dtype_name=dtype,
        bank_tile=7))
    _close(rows.numpy(), want_rows, dtype, rtol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [2, 3, 5])
def test_block_sizes_change_no_bit(dt, dtype):
    codes = _hard_codes(seed=8)
    base = tmsa.msa_distance_matrix(codes, dt, dtype, CPU)
    for rb in (1, 5, 64):
        assert torch.equal(
            tmsa.msa_distance_matrix(codes, dt, dtype, CPU, row_block=rb)
            .nan_to_num(nan=-7.0), base.nan_to_num(nan=-7.0))
    ct = torch.from_numpy(codes)
    ng = tmsa.nongap_counts(ct, dtype)
    kw = dict(distance_type=dt, dtype_name=dtype)
    rows = tmsa.msa_tiled_block(ct[3:14], ng[3:14], ct, ng, **kw)
    for tile, rb in ((1, 1), (4, 3), (5, None), (4096, 2)):
        got = tmsa.msa_tiled_block(ct[3:14], ng[3:14], ct, ng, bank_tile=tile,
                                   row_block=rb, **kw)
        assert torch.equal(got.nan_to_num(nan=-7.0),
                           rows.nan_to_num(nan=-7.0))
    # placement's rows are the matrix's, but for its zeroed diagonal
    off = ~torch.eye(len(codes), dtype=torch.bool)[3:14]
    assert torch.equal(rows.nan_to_num(nan=-7.0)[off],
                       base[3:14].nan_to_num(nan=-7.0)[off])
