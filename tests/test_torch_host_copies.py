"""The port's copied host modules give the JAX package's output, and the
port imports neither `jax` nor `dipper_tpu`."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dipper_tpu.distance import mash as jm
from dipper_tpu.io import encode as jenc
from dipper_tpu.io.fasta import read_fasta as jax_read_fasta
from dipper_tpu.io.newick import edge_arrays_newick as jax_newick
from dipper_tpu.io.phylip import (
    read_phylip_lower_triangular as jax_read_phylip,
    write_phylip_lower_triangular as jax_write_phylip,
)
from dipper_tpu.placement import kclosest as jk
from dipper_tpu.sketch.bank import get_sketch_bank as jax_sketch_bank
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu.utils.params import Param as JaxParam
from dipper_tpu.utils.treecmp import rf_distance as jax_rf
from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.io import encode as tenc
from dipper_tpu_torch.io.fasta import read_fasta
from dipper_tpu_torch.io.newick import edge_arrays_newick
from dipper_tpu_torch.io.phylip import (
    read_phylip_lower_triangular, write_phylip_lower_triangular,
)
from dipper_tpu_torch.sketch import bank as port_bank
from dipper_tpu_torch.utils.params import Param
from dipper_tpu_torch.utils.treecmp import rf_distance, rf_distance_fast

from datagen import simulate_unaligned, write_fasta
from test_nj import random_additive_matrix

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def seqs_fasta(tmp_path):
    names, seqs = simulate_unaligned(30, 700, np.random.default_rng(2))
    path = tmp_path / "in.fa"
    write_fasta(str(path), names, seqs)
    return names, seqs, str(path)


def test_read_fasta(seqs_fasta):
    names, seqs, path = seqs_fasta
    assert read_fasta(path) == jax_read_fasta(path) == (names, seqs)


def test_phylip_round_trip(tmp_path):
    D = random_additive_matrix(12, np.random.default_rng(4))
    names = [f"T{i}" for i in range(12)]
    a, b = tmp_path / "a.phy", tmp_path / "b.phy"
    write_phylip_lower_triangular(names, D, str(a))
    jax_write_phylip(names, D, str(b))
    assert a.read_bytes() == b.read_bytes()
    got_names, got = read_phylip_lower_triangular(str(a))
    want_names, want = jax_read_phylip(str(a))
    assert got_names == want_names == names
    assert np.array_equal(got, want)


def test_edge_arrays_newick_bytes():
    rng = np.random.default_rng(6)
    D = random_additive_matrix(40, rng)
    D = D / (D.max() * 1.05)
    e, belong, length = (np.asarray(x) for x in jk.run_placement(
        (jnp.asarray(D),), num_sequences=40, frontend="matrix",
        dtype_name="float64"))
    names = [f"L{i}" for i in range(40)]
    got = edge_arrays_newick(40, names, belong, e, length, 40)
    assert got == jax_newick(40, names, belong, e, length, 40)
    assert rf_distance(got, got) == jax_rf(got, got) == (0, 0.0)


def test_treecmp_matches():
    a = "((A:1,B:1):1,(C:1,D:1):1,E:1);"
    b = "((A:1,C:1):1,(B:1,D:1):1,E:1);"
    assert rf_distance(a, b) == jax_rf(a, b)
    assert rf_distance_fast(a, b) == rf_distance(a, b)


ENCODE_SEQS = [b"ACGTUacgtuNn-*.RYKM", b"A", b"TTTTGGGGCCCCAAAA" * 5 + b"-N",
               bytes(range(256))]


@pytest.mark.parametrize("fn", ["encode_2bit_codes", "encode_4bit_codes"])
def test_encode_codes(fn):
    assert np.array_equal(tenc._LUT2, jenc._LUT2)
    assert np.array_equal(tenc._LUT4, jenc._LUT4)
    for seq in ENCODE_SEQS:
        got, want = getattr(tenc, fn)(seq), getattr(jenc, fn)(seq)
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want)


def test_encode_pack():
    for seq in ENCODE_SEQS:
        c2, c4 = jenc.encode_2bit_codes(seq), jenc.encode_4bit_codes(seq)
        for fn, codes in (("pack_2bit", c2), ("pack_4bit", c4)):
            got, want = getattr(tenc, fn)(codes), getattr(jenc, fn)(codes)
            assert got.dtype == want.dtype == np.int32
            assert np.array_equal(got, want)
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 4, (5, 37)).astype(np.uint8)
    assert np.array_equal(tenc.pack_2bit_matrix(mat),
                          jenc.pack_2bit_matrix(mat))
    ascii_mat = np.frombuffer(b"ACGTNacgU-" * 16, np.uint8).reshape(4, 40)
    assert np.array_equal(tenc.encode_pack_2bit_matrix(ascii_mat),
                          jenc.encode_pack_2bit_matrix(ascii_mat))


@pytest.mark.parametrize("pad_to, pad_value", [(None, 4), (300, 0)])
def test_batch_codes(pad_to, pad_value):
    seqs = ENCODE_SEQS
    got = tenc.batch_codes(seqs, tenc.encode_4bit_codes, pad_to, pad_value)
    want = jenc.batch_codes(seqs, jenc.encode_4bit_codes, pad_to, pad_value)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("k, ss", [(15, 200), (12, 64)])
def test_native_sketch_bank(seqs_fasta, k, ss):
    _, seqs, _ = seqs_fasta
    got = port_bank.get_sketch_bank(seqs, Param(kmer_size=k, sketch_size=ss))
    want = jax_sketch_bank(seqs, JaxParam(kmer_size=k, sketch_size=ss))
    assert got.dtype == np.uint64
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, np.asarray(sketch_sequences(seqs, k, ss)))


def test_sketch_bank_raises_without_native(seqs_fasta, monkeypatch,
                                           capsys):
    """Without the native library the bank falls back to the device
    sketcher on the caller's device, as dipper_tpu/sketch/bank.py does:
    on the default device, the card, it raises where there is no card
    (no silent move to the CPU); on --device cpu it gives the native
    bank's bits and logs the fallback."""
    import torch

    from dipper_tpu_torch.sketch import native

    monkeypatch.setattr(native, "sketch_sequences_native",
                        lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bank.get_sketch_bank(seqs_fasta[1], Param())
    got = port_bank.get_sketch_bank(seqs_fasta[1], Param(), device="cpu")
    assert "Native sketcher unavailable" in capsys.readouterr().err
    assert got.dtype == np.uint64
    assert np.array_equal(got, np.asarray(sketch_sequences(
        seqs_fasta[1], 15, 1000)))


@pytest.mark.parametrize("ss", [100, 128])
def test_rank_compress_and_pad(seqs_fasta, ss):
    sk = np.asarray(sketch_sequences(seqs_fasta[1], 12, ss))
    got = tm.pad_ranks(tm.rank_compress_host(sk))
    want = jm.pad_ranks(jm.rank_compress_host(sk))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k, S", [(15, 1000), (12, 100), (9, 17)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dist_table(k, S, dtype):
    got = tm._dist_table(k, S, dtype)
    want = jm._dist_table(k, S, dtype)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_resolve_device():
    from dipper_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


def test_port_imports_no_jax():
    """Import the port and every one of its modules in a fresh process:
    neither jax nor dipper_tpu may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dipper_tpu_torch, dipper_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(dipper_tpu_torch.__path__,"
        " 'dipper_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'dipper_tpu' or"
        " m.startswith('dipper_tpu.'))\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('dipper_tpu_torch.')]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


@pytest.mark.parametrize("cmax", [1, 8, 13, 64])
def test_dc_mask_order_and_group_flags(cmax):
    from dipper_tpu.dc import pipeline as jpl
    from dipper_tpu_torch.dc import cluster as tc

    got, want = tc.mask_order_perm(cmax), jpl._mask_order_perm(cmax)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tc.new_group_scoreable(), jpl._new_group_scoreable())


def test_dc_global_numbering():
    """bb_final_vec and assemble's numbering (backbone internals -> N +
    v - B, middle k of cluster c -> N + B - 1 + prefix[c] + k, slots from
    4B - 4): the global edge arrays of a matrix build with buckets of
    several widths, one of them streamed, equal dipper_tpu.dc's."""
    from dipper_tpu.dc import pipeline as jpl
    from dipper_tpu.utils.params import Param as JP
    from dipper_tpu_torch.dc import pipeline as tpl

    n, b = 200, 12
    D = random_additive_matrix(n, np.random.default_rng(8))
    D = D / (D.max() * 1.05)
    names = [f"L{i}" for i in range(n)]
    kw = dict(in_format="d", dtype="float64", backbone_size=b)
    jpl.build_dc_tree_from_matrix(D, names, JP(**kw))
    tpl._STREAM_CLUSTER_MIN, saved = 20, tpl._STREAM_CLUSTER_MIN
    logs = []
    try:
        tpl.build_dc_tree_from_matrix(D, names, Param(**kw),
                                      device=torch.device("cpu"),
                                      log=logs.append)
    finally:
        tpl._STREAM_CLUSTER_MIN = saved
    assert any("path=stream" in m for m in logs)
    assert sum("path=batch" in m for m in logs) >= 2
    for k in ("e", "belong", "len"):
        assert np.array_equal(tpl.last_debug[k], jpl.last_debug[k]), k
    used = tpl.last_debug["belong"] >= 0
    assert used.sum() == 4 * n - 4


def test_native_library_parallel_first_use(tmp_path):
    """Four processes loading the sketcher at once from a native/ copy
    with no library: each gets a working library (one builds it under the
    lock, the others wait and load the renamed file)."""
    import shutil

    nat = tmp_path / "native"
    nat.mkdir()
    for f in ("Makefile", "sketchnat.cpp"):
        shutil.copy(os.path.join(REPO, "native", f), nat / f)
    code = ("import ctypes, sys\n"
            "from dipper_tpu_torch.utils.native_lib import native_library\n"
            "p = native_library('libsketchnat.so', 'sketchnat.cpp', "
            "sys.argv[1])\n"
            "print(p is not None and hasattr(ctypes.CDLL(p), "
            "'sketchnat_sketch'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(nat)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert outs == ["True"] * 4
    assert sorted(os.listdir(nat)) == [".build.lock", "Makefile",
                                       "libsketchnat.so", "sketchnat.cpp"]
