"""The port's device sketcher (sketch/minhash.py, its plain PyTorch
version on the CPU), the numpy model of its kernel's select path
(sketch/select_model.py) and device rank compression (distance/mash.py::
rank_compress, rank_compress_dense) against dipper_tpu's and the host's,
and how the port routes sketching: every -i r path takes the device
sketcher (the NJ matrix and -o d with first-of-run ranks, placement, D&C
and --add with dense ranks), --save-sketches and --load-sketches the
host route. Every comparison here is bitwise. Inputs are made with numpy
from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from datagen import simulate_unaligned, write_fasta
from dipper_tpu.distance.mash import (mash_distance_matrix_device,
                                      rank_compress as jax_rank_compress,
                                      rank_compress_host as jax_rank_host)
from dipper_tpu.sketch.minhash import (sketch_batch_device as jax_batch,
                                       sketch_sequences as jax_sketch)
from dipper_tpu_torch.cli import main as port_main
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.driver import _distance_matrix
from dipper_tpu_torch.sketch import bank as port_bank
from dipper_tpu_torch.sketch import minhash, minhash_cuda, native
from dipper_tpu_torch.sketch import select_model
from dipper_tpu_torch.sketch.native import sketch_sequences_native
from dipper_tpu_torch.utils.params import Param

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _u64_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


@pytest.mark.parametrize("klen", range(2, 16))
def test_murmur_bit_exact(klen):
    """The plain murmur tail against the oracle, as tests/test_mash.py
    holds dipper_tpu's."""
    rng = np.random.default_rng(klen)
    keys = [bytes(rng.integers(65, 90, klen).astype(np.uint8))
            for _ in range(64)]
    want = np.array([oracle.murmur3_x64_128_low64(kb) for kb in keys],
                    dtype=np.uint64)
    k1 = np.array([int.from_bytes(kb[:8].ljust(8, b"\0"), "little")
                   for kb in keys], dtype=np.uint64)
    k2 = np.array([int.from_bytes(kb[8:].ljust(8, b"\0"), "little")
                   for kb in keys], dtype=np.uint64)
    got = minhash.murmur3_low64_tail(_u64_tensor(k1), _u64_tensor(k2), klen)
    assert np.array_equal(got.numpy().view(np.uint64), want)


def _adversarial_seqs(k: int, seed: int):
    """Lengths 0, k-1, k, k+1, 37, 1,500 and 9,000 (several tiles of the
    plain version), N, lowercase and U bytes, a repeat-heavy row whose
    bottom-k is all duplicates, in a ragged order."""
    rng = np.random.default_rng(seed)
    seqs = [bytes(rng.choice(list(b"ACGTNacgtU"), L).astype(np.uint8))
            for L in (0, k - 1, k, k + 1, 37, 1500, 9000)]
    seqs.append(b"ACGT" * 2500)
    return [seqs[i] for i in rng.permutation(len(seqs))]


@pytest.mark.parametrize("ss", [1, 100, 1000])
@pytest.mark.parametrize("k", [2, 4, 11, 15])
def test_sketch_sequences_equal_jax_and_native(k, ss):
    seqs = _adversarial_seqs(k, 10 * k + ss)
    got = minhash.sketch_sequences(seqs, k, ss, device=CPU)
    want = np.asarray(jax_sketch(seqs, k, ss))
    assert got.dtype == np.uint64 and got.shape == (len(seqs), ss)
    assert np.array_equal(got, want)
    assert np.array_equal(got, sketch_sequences_native(seqs, k, ss))
    dev = minhash.sketch_sequences(seqs, k, ss, device=CPU, as_device=True)
    assert dev.dtype == torch.int64
    assert np.array_equal(dev.numpy().view(np.uint64), want)


def test_sketch_sequences_across_batches(monkeypatch):
    """Rows split over several batches come back in input order."""
    monkeypatch.setattr(minhash, "_BATCH_BYTES", 200_000)
    _, seqs = simulate_unaligned(12, 700, np.random.default_rng(3))
    seqs = [s[:len(s) - 37 * i] for i, s in enumerate(seqs)]
    got = minhash.sketch_sequences(seqs, 12, 100, device=CPU)
    assert np.array_equal(got, np.asarray(jax_sketch(seqs, 12, 100)))


@pytest.mark.parametrize("k, ss", [(4, 50), (15, 300)])
def test_sketch_batch_device_equals_jax(k, ss):
    """The codes entry point (packed on the device) on padded rows."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (5, 700)).astype(np.uint8)
    lengths = np.array([0, k - 1, k, 333, 700], dtype=np.int32)
    got = minhash.sketch_batch_device(torch.from_numpy(codes),
                                      torch.from_numpy(lengths), k=k,
                                      sketch_size=ss)
    want = np.asarray(jax_batch(jnp.asarray(codes), jnp.asarray(lengths),
                                k=k, sketch_size=ss))
    assert np.array_equal(got.numpy().view(np.uint64), want)


def _heavy_bank():
    """tests/test_mash.py's duplicate- and sentinel-heavy bank."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 50, (16, 64)).astype(np.uint64) * np.uint64(2**40)
    vals.sort(axis=1)
    vals[3, 40:] = minhash.SENTINEL
    return vals


def _real_bank():
    _, seqs = simulate_unaligned(40, 1200, np.random.default_rng(11))
    return np.asarray(jax_sketch(seqs, 12, 150))


@pytest.mark.parametrize("which", ["heavy", "real"])
def test_rank_compress_equals_jax(which):
    bank = _heavy_bank() if which == "heavy" else _real_bank()
    got = tm.rank_compress(_u64_tensor(bank))
    want = np.asarray(jax_rank_compress(jnp.asarray(bank)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # distances through device ranks equal those through host ranks
    S = bank.shape[1]
    dev = tm.pad_ranks(got)
    host = torch.from_numpy(tm.pad_ranks(tm.rank_compress_host(bank)))
    for dtype in ("float32", "float64"):
        a = tm.mash_rows_vs_bank(dev, dev[:5], k=12, sketch_size=S,
                                 dtype_name=dtype)
        b = tm.mash_rows_vs_bank(host, host[:5], k=12, sketch_size=S,
                                 dtype_name=dtype)
        assert torch.equal(a, b)


def test_rank_compress_refuses_2_to_the_30():
    """N*S >= 2^30 is refused from the shape, before any work (an
    expanded view: 8 GB is never allocated)."""
    bank = torch.zeros((1, 1), dtype=torch.int64).expand(2**15, 2**15)
    with pytest.raises(ValueError, match="fewer than 2\\^30"):
        tm.rank_compress(bank)


def _dense_bank(case: str) -> np.ndarray:
    """Banks for the dense rank: values shared across rows, rows of
    sentinels, one value throughout, N*S not a power of two, and the
    duplicate-heavy and real banks."""
    rng = np.random.default_rng(17)
    if case == "ties_across_rows":
        vals = rng.integers(0, 9, (12, 40)).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        return np.sort(vals, axis=1)
    if case == "all_sentinel_rows":
        bank = _real_bank()[:10].copy()
        bank[[0, 4, 9]] = minhash.SENTINEL
        return bank
    if case == "one_value":
        return np.full((5, 33), np.uint64(2**63 + 5), dtype=np.uint64)
    if case == "not_pow2":
        return _real_bank()[:7, :37]
    return _heavy_bank() if case == "heavy" else _real_bank()


@pytest.mark.parametrize("case", ["ties_across_rows", "all_sentinel_rows",
                                  "one_value", "not_pow2", "heavy", "real"])
def test_rank_compress_dense_equals_host(case):
    """rank_compress_dense equals np.unique's inverse, the port's
    rank_compress_host and dipper_tpu's, bitwise."""
    bank = _dense_bank(case)
    got = tm.rank_compress_dense(_u64_tensor(bank))
    assert got.dtype == torch.int32 and got.shape == bank.shape
    _, inv = np.unique(bank.reshape(-1), return_inverse=True)
    assert np.array_equal(got.numpy().reshape(-1), inv)
    assert np.array_equal(got.numpy(), tm.rank_compress_host(bank))
    assert np.array_equal(got.numpy(), jax_rank_host(bank))


def test_rank_compress_dense_refuses_u_at_the_limit(monkeypatch):
    """The host route's rule: U distinct values must stay below the
    limit (2^30; here made small). N*S alone is no limit."""
    bank = _real_bank()[:4]
    U = len(np.unique(bank))
    monkeypatch.setattr(tm, "_RANK_LIMIT", U + 1)
    tm.rank_compress_dense(_u64_tensor(bank))
    monkeypatch.setattr(tm, "_RANK_LIMIT", U)
    with pytest.raises(ValueError, match=f"holds {U} distinct values"):
        tm.rank_compress_dense(_u64_tensor(bank))


def _keys_of_rows(seqs, k: int):
    """(packed words, lengths, each row's valid windows' hashes as u64) of
    `seqs` as one batch, from the plain version's window hashes."""
    from dipper_tpu_torch.io.encode import encode_pack_2bit_matrix

    L = -(-max(max(map(len, seqs)), k) // 16) * 16
    ascii_mat = np.zeros((len(seqs), L), dtype=np.uint8)
    for r, s in enumerate(seqs):
        ascii_mat[r, :len(s)] = np.frombuffer(s, np.uint8)
    words = torch.from_numpy(encode_pack_2bit_matrix(ascii_mat))
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    P = 16 * words.shape[1] - k + 1
    keys = minhash.window_keys(minhash.unpack_codes(words), lens, k, 0, P)
    keys = (keys ^ -2**63).numpy().view(np.uint64)
    return words, lens, [keys[r, :max(0, len(s) - k + 1)]
                         for r, s in enumerate(seqs)]


def _select_rows(case: str, k: int):
    rng = np.random.default_rng(k)

    def acgt(L):
        return bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))

    if case == "ragged":  # shorter than k, the tile edge, several tiles
        return [acgt(L) for L in (0, k - 1, k, k + 1, 4095 + k, 4096 + k,
                                  10000, 21000)]
    if case == "repeats":  # poly-A (every window one hash), a 4-periodic
        return [b"A" * 9000, b"ACGT" * 3000, acgt(6000)]
    return [acgt(200_000)]  # one row: split into segments


@pytest.mark.parametrize("ss", [1, 1000, 1024])
@pytest.mark.parametrize("case, k", [("ragged", 4), ("ragged", 15),
                                     ("repeats", 15), ("long_row", 15)])
def test_select_model_equals_plain(case, k, ss):
    """The select path's arithmetic (threshold, histogram cut, ties at
    tau, segments and their merge) equals the plain version bitwise."""
    seqs = _select_rows(case, k)
    words, lens, rows = _keys_of_rows(seqs, k)
    stats = {}
    got = select_model.sketch_rows_model(rows, words.shape[1], k, ss, stats)
    want = minhash.sketch_batch_plain(words, lens, k=k, sketch_size=ss)
    assert np.array_equal(got, want.numpy().view(np.uint64))
    if case == "long_row":
        assert minhash_cuda.plan(1, words.shape[1], k, ss)[1] == 24
    # the buffer was cut on the way; poly-A's duplicates needed the exact
    # cut and, but at s = 1, the end's sort, as k = 4's crowded bins do
    assert stats["cuts"] > 0 and stats.get("by_bins", 0) > 0
    assert (stats.get("exact_cuts", 0) > 0) == (case == "repeats")
    assert (stats.get("end_sorts", 0) > 0) == (
        (case == "repeats" and ss > 1) or k == 4)


@pytest.mark.parametrize("ss", [1, 7])
@pytest.mark.parametrize("bits", [11, 20, 63])
def test_select_model_bins_a_power_of_two_tau(bits, ss):
    """A segment of one repeated value 2^bits: the buffer's cuts cannot
    make room, the exact cut sets tau to that value, and the end's
    histogram must still bin it (the bin shift covers [0, tau])."""
    v = np.uint64(1) << np.uint64(bits)
    keys = np.full(3 * minhash_cuda.TILE, v, dtype=np.uint64)
    stats = {}
    got = select_model.select_segment(keys, ss, 0, 3, stats)
    assert stats["exact_cuts"] > 0
    assert np.array_equal(got, np.full(ss, v))


@pytest.mark.parametrize("rows", [1, 7, 263, 264, 5000])
def test_row_bytes_bound_the_kernels_scratch(rows):
    """sketch_sequences' batch budget (_row_bytes) bounds the kernel's
    scratch and output for every batch size, on both paths."""
    for L in (10, 4096, 10_000, 200_000, 2_000_000):
        W = (max(L, 15) + 15) // 16
        for ss in (1, 1000, minhash_cuda.SELECT_MAX_SKETCH,
                   minhash_cuda.SELECT_MAX_SKETCH + 1,
                   minhash_cuda.MAX_SKETCH_SIZE):
            need = (minhash_cuda.scratch_elems(rows, W, 15, ss)
                    + rows * ss) * 8 + rows * 4 * W
            assert need <= rows * int(minhash._row_bytes(np.array([L]), 15,
                                                         ss)[0])


@pytest.mark.parametrize("ss", [100, 128])
def test_pad_ranks_tensor_equals_host(ss):
    ranks = tm.rank_compress_host(_real_bank()[:, :ss])
    got = tm.pad_ranks(torch.from_numpy(ranks))
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), tm.pad_ranks(ranks))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_distance_matrix_equals_jax_device(dtype):
    """driver.py's -i r matrix (device sketches, device ranks, kernel
    2's plain version) against dipper_tpu's
    mash_distance_matrix_device."""
    _, seqs = simulate_unaligned(24, 900, np.random.default_rng(5))
    params = Param(in_format="r", kmer_size=11, sketch_size=120,
                   dtype=dtype)
    got = _distance_matrix(params, seqs, CPU)
    want = np.asarray(mash_distance_matrix_device(
        jax_sketch(seqs, 11, 120), 11, 120, dtype=dtype))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.numpy(), want)


def test_get_sketch_bank_as_device():
    _, seqs = simulate_unaligned(6, 500, np.random.default_rng(2))
    params = Param(kmer_size=12, sketch_size=64)
    dev = port_bank.get_sketch_bank(seqs, params, as_device=True,
                                    device=CPU)
    host = port_bank.get_sketch_bank(seqs, params, device=CPU)
    assert isinstance(dev, torch.Tensor) and isinstance(host, np.ndarray)
    assert np.array_equal(dev.numpy().view(np.uint64), host)


# --- routing ---------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """100 sequences (D&C takes B = N // 20 = 5), and a backbone tree of
    the first 16 for --add."""
    tmp = tmp_path_factory.mktemp("sketch_route")
    names, seqs = simulate_unaligned(100, 1000, np.random.default_rng(9))
    fa, back_fa = tmp / "all.fa", tmp / "back.fa"
    write_fasta(str(fa), names, seqs)
    write_fasta(str(back_fa), names[:16], seqs[:16])
    back = tmp / "back.nwk"
    assert port_main(["-i", "r", "-I", str(back_fa), "-O", str(back), "-m",
                      "1", "-k", "12", "-s", "100", "--seed", "-1",
                      "--device", "cpu"]) == 0
    return {"fa": str(fa), "back": str(back), "tmp": tmp}


def _refuse(monkeypatch, module, name):
    def refuse(*a, **kw):
        raise AssertionError(f"{module.__name__}.{name} was called")

    monkeypatch.setattr(module, name, refuse)


def _run(tmp_path, args, name="out"):
    out = tmp_path / name
    assert port_main(args + ["-O", str(out), "-k", "12", "-s", "100",
                             "--device", "cpu"]) == 0
    return out.read_text()


@pytest.mark.parametrize("mode", [["-m", "2"], ["-o", "d"]])
def test_nj_and_matrix_take_the_device_sketcher(tmp_path, inputs, mode,
                                                 monkeypatch):
    want = _run(tmp_path, ["-i", "r", "-I", inputs["fa"]] + mode, "want")
    _refuse(monkeypatch, native, "sketch_sequences_native")
    assert _run(tmp_path, ["-i", "r", "-I", inputs["fa"]] + mode) == want


def _mode_args(inputs, mode):
    return {"placement": ["-i", "r", "-I", inputs["fa"], "-m", "1"],
            "dc": ["-i", "r", "-I", inputs["fa"], "-m", "3"],
            "add": ["-i", "r", "-I", inputs["fa"], "--add", "-t",
                    inputs["back"], "--seed", "-1"]}[mode]


@pytest.mark.parametrize("mode", ["placement", "dc", "add"])
def test_placement_dc_add_take_the_device_sketcher(tmp_path, inputs, mode,
                                                   capsys, monkeypatch):
    """Placement, D&C and --add sketch on the device and rank densely
    there, and write the host route's Newick bytes (the host route forced
    by --save-sketches: native sketcher, np.unique)."""
    args = _mode_args(inputs, mode)
    want = _run(tmp_path, args + ["--save-sketches",
                                  str(tmp_path / "sk.npz")], "want")
    assert "Rank bank route: host" in capsys.readouterr().err
    _refuse(monkeypatch, native, "sketch_sequences_native")
    got = _run(tmp_path, args)
    assert "Rank bank route: device" in capsys.readouterr().err
    assert got == want and got.count(",") == 99


@pytest.mark.parametrize("spare, route", [(0, "device"), (-1, "host")])
def test_rank_bank_takes_the_host_route_where_the_card_is_short(
        spare, route, monkeypatch):
    """ingest_route's size rule, forced on the CPU through _device_room:
    the device route where N x S x _DEVICE_ROUTE_BYTES plus a sketch
    batch fits the room, the host route (native sketcher, np.unique) one
    byte short of it; both logged with their reason, and the same
    padded rank bank either way."""
    _, seqs = simulate_unaligned(40, 700, np.random.default_rng(4))
    params = Param(kmer_size=12, sketch_size=100)
    want = tm.mash_rank_bank(seqs, params, CPU)
    need = (len(seqs) * params.sketch_size * tm._DEVICE_ROUTE_BYTES
            + minhash._BATCH_BYTES)
    monkeypatch.setattr(tm, "_device_room", lambda device: need + spare)
    if route == "host":
        _refuse(monkeypatch, minhash, "sketch_sequences")
    lines = []
    got = tm.mash_rank_bank(seqs, params, CPU, log=lines.append)
    assert lines[0].startswith(f"Rank bank route: {route} (")
    assert (f"needs ~{need} bytes" in lines[0]) == (route == "host")
    assert torch.equal(got, want)


def test_sketch_checkpoints_take_the_host_route(tmp_path, inputs,
                                                monkeypatch):
    """--save-sketches and --load-sketches make NJ sketch on the host (or
    load), as dipper_tpu/sketch/bank.py does; the tree is the device
    route's."""
    want = _run(tmp_path, ["-i", "r", "-I", inputs["fa"], "-m", "2"], "want")
    _refuse(monkeypatch, minhash, "sketch_sequences")
    npz = str(tmp_path / "sk.npz")
    for flag in ("--save-sketches", "--load-sketches"):
        assert _run(tmp_path, ["-i", "r", "-I", inputs["fa"], "-m", "2",
                               flag, npz]) == want


def test_placement_without_native_falls_back(tmp_path, inputs, capsys,
                                             monkeypatch):
    """Where the native library cannot be loaded, the host route
    (--save-sketches) sketches with the device sketcher on the caller's
    device, logs so, and writes the native route's Newick bytes."""
    args = ["-i", "r", "-I", inputs["fa"], "-m", "1", "--save-sketches",
            str(tmp_path / "sk.npz")]
    want = _run(tmp_path, args, "want")
    capsys.readouterr()
    monkeypatch.setattr(native, "_load", lambda: None)
    got = _run(tmp_path, args)
    assert "Native sketcher unavailable" in capsys.readouterr().err
    assert got == want
