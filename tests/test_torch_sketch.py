"""The port's device sketcher (sketch/minhash.py, its plain PyTorch
version on the CPU) and device rank compression (distance/mash.py::
rank_compress) against dipper_tpu's, and how the port routes sketching:
the NJ matrix and -o d from -i r take the device sketcher and device
ranks, placement, D&C and --add the native host sketcher, as in
dipper_tpu. Every comparison here is bitwise. Inputs are made with numpy
from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from datagen import simulate_unaligned, write_fasta
from dipper_tpu.distance.mash import (mash_distance_matrix_device,
                                      rank_compress as jax_rank_compress)
from dipper_tpu.sketch.minhash import (sketch_batch_device as jax_batch,
                                       sketch_sequences as jax_sketch)
from dipper_tpu_torch.cli import main as port_main
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.driver import _distance_matrix
from dipper_tpu_torch.sketch import bank as port_bank
from dipper_tpu_torch.sketch import minhash, native
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


@pytest.mark.parametrize("mode", ["placement", "dc", "add"])
def test_placement_dc_add_take_the_native_sketcher(tmp_path, inputs, mode,
                                                   monkeypatch):
    args = {"placement": ["-i", "r", "-I", inputs["fa"], "-m", "1"],
            "dc": ["-i", "r", "-I", inputs["fa"], "-m", "3"],
            "add": ["-i", "r", "-I", inputs["fa"], "--add", "-t",
                    inputs["back"], "--seed", "-1"]}[mode]
    _refuse(monkeypatch, minhash, "sketch_sequences")
    assert _run(tmp_path, args).count(",") == 99


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
    """Where the native library cannot be loaded, placement from -i r
    sketches with the device sketcher on the caller's device, logs so,
    and writes the native route's Newick bytes."""
    args = ["-i", "r", "-I", inputs["fa"], "-m", "1"]
    want = _run(tmp_path, args, "want")
    capsys.readouterr()
    monkeypatch.setattr(native, "_load", lambda: None)
    got = _run(tmp_path, args)
    assert "Native sketcher unavailable" in capsys.readouterr().err
    assert got == want
