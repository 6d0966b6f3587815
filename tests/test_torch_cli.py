"""The port's CLI (`--device cpu`) vs dipper_tpu.cli on the inputs of
tests/test_cli_placement.py: identical Newick bytes in f64 (bitwise
equal builds), nRF = 0 in f32 (the trees are bitwise equal there too, but
nRF is the contract the f32 path is held to), for k-closest placement and
conventional NJ; identical PHYLIP bytes for the mash matrix (-i r -o d).
Unported modes exit 1 with a "not yet ported" message."""

import numpy as np
import pytest
import torch

from dipper_tpu.cli import main as jax_main
from dipper_tpu.io.phylip import write_phylip_lower_triangular
from dipper_tpu_torch.cli import main as port_main
from dipper_tpu_torch.utils.treecmp import rf_distance

from datagen import simulate_unaligned, write_fasta
from test_nj import random_additive_matrix

torch.set_num_threads(2)


@pytest.fixture
def phylip(tmp_path):
    n = 35
    D = random_additive_matrix(n, np.random.default_rng(21))
    D = D / (D.max() * 1.05)
    path = tmp_path / "in.phy"
    write_phylip_lower_triangular([f"T{i}" for i in range(n)], D, str(path))
    return str(path)


@pytest.fixture
def fasta(tmp_path):
    names, seqs = simulate_unaligned(20, 1500, np.random.default_rng(31))
    path = tmp_path / "in.fa"
    write_fasta(str(path), names, seqs)
    return str(path)


def _both(tmp_path, args):
    out_j, out_p = tmp_path / "jax.nwk", tmp_path / "port.nwk"
    assert jax_main(args + ["-O", str(out_j)]) == 0
    assert port_main(args + ["-O", str(out_p), "--device", "cpu"]) == 0
    return out_j.read_text(), out_p.read_text()


@pytest.mark.parametrize("extra", [[], ["--state-chunk", "8"],
                                   ["--state-chunk", "8", "--no-prefix-caps"]])
def test_matrix_f64_identical_bytes(tmp_path, phylip, extra):
    want, got = _both(tmp_path, ["-i", "d", "-I", phylip, "-m", "1",
                                 "--precision", "f64"] + extra)
    assert got == want


def test_matrix_f32_nrf_zero(tmp_path, phylip):
    want, got = _both(tmp_path, ["-i", "d", "-I", phylip, "-m", "1"])
    assert rf_distance(got, want)[0] == 0


@pytest.mark.parametrize("seed", ["-1", "42"])
def test_mash_f64_identical_bytes(tmp_path, fasta, seed):
    want, got = _both(tmp_path, ["-i", "r", "-I", fasta, "-m", "1", "-k",
                                 "12", "-s", "150", "--precision", "f64",
                                 "--seed", seed])
    assert got == want


def test_mash_f32_nrf_zero(tmp_path, fasta):
    want, got = _both(tmp_path, ["-i", "r", "-I", fasta, "-m", "1", "-k",
                                 "12", "-s", "150"])
    assert rf_distance(got, want)[0] == 0


def test_sketch_and_state_checkpoints(tmp_path, fasta):
    """--save-sketches/--load-sketches and --save-state/--load-state give
    the same tree as a plain run; a saved state resumes to it."""
    base = ["-i", "r", "-I", fasta, "-m", "1", "-k", "12", "-s", "150",
            "--precision", "f64", "--device", "cpu", "--state-chunk", "6"]
    sk, st = str(tmp_path / "sk.npz"), str(tmp_path / "st.npz")
    outs = []
    for extra in ([], ["--save-sketches", sk, "--save-state", st],
                  ["--load-sketches", sk, "--load-state", st]):
        out = tmp_path / f"o{len(outs)}.nwk"
        assert port_main(base + extra + ["-O", str(out)]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] == outs[2]


# NJ: -m 2, or auto mode below 30,000 taxa (-m 0 included: auto mode)
NJ_MODES = [pytest.param([], id="auto"), pytest.param(["-m", "2"], id="m2"),
            pytest.param(["-m", "0"], id="m0")]


@pytest.mark.parametrize("mode", NJ_MODES)
def test_nj_matrix_f64_identical_bytes(tmp_path, phylip, mode):
    want, got = _both(tmp_path, ["-i", "d", "-I", phylip, "--precision",
                                 "f64"] + mode)
    assert got == want


@pytest.mark.parametrize("mode", NJ_MODES[:2])
def test_nj_matrix_f32_nrf_zero(tmp_path, phylip, mode):
    want, got = _both(tmp_path, ["-i", "d", "-I", phylip] + mode)
    assert rf_distance(got, want)[0] == 0


@pytest.mark.parametrize("mode", NJ_MODES[:2])
@pytest.mark.parametrize("seed", ["-1", "42"])
def test_nj_mash_f64_identical_bytes(tmp_path, fasta, seed, mode):
    want, got = _both(tmp_path, ["-i", "r", "-I", fasta, "-k", "12", "-s",
                                 "150", "--precision", "f64", "--seed",
                                 seed] + mode)
    assert got == want


def test_nj_mash_f32_nrf_zero(tmp_path, fasta):
    want, got = _both(tmp_path, ["-i", "r", "-I", fasta, "-k", "12", "-s",
                                 "150"])
    assert rf_distance(got, want)[0] == 0


@pytest.mark.parametrize("extra", [[], ["--precision", "f64"], ["-m", "1"]])
def test_mash_matrix_output_identical_bytes(tmp_path, fasta, extra):
    """-i r -o d writes the matrix NJ would use, widened to f64, whatever
    the mode."""
    want, got = _both(tmp_path, ["-i", "r", "-I", fasta, "-k", "12", "-s",
                                 "150", "-o", "d"] + extra)
    assert got == want


def test_nj_log_lines(tmp_path, fasta, capsys):
    assert port_main(["-i", "r", "-I", fasta, "-k", "12", "-s", "150", "-O",
                      str(tmp_path / "o.nwk"), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    for line in ("Using conventional NJ", "Sketch in:", "Distance matrix in:",
                 "NJ in:", "Tree Created in:"):
        assert line in err, err


@pytest.mark.parametrize("args, what", [
    (["-i", "r", "-m", "3"], "divide-and-conquer"),
    (["-i", "m", "-m", "1"], "-i m"),
    (["-i", "m", "-m", "2"], "-i m"),
    (["-i", "r", "--add", "-t", "TREE"], "--add"),
    (["-i", "r", "-m", "1", "--profile", "/tmp/x"], "--profile"),
    (["-i", "r", "-m", "1", "--devices", "2"], "--devices"),
    (["-i", "r", "-m", "1", "--coordinator", "localhost:1"], "multi-host"),
])
def test_unported_modes_exit_1(tmp_path, phylip, fasta, capsys, args, what):
    args = [phylip if a == "TREE" else a for a in args]
    inp = phylip if args[1] == "d" else fasta
    rc = port_main(args + ["-I", inp, "-O", str(tmp_path / "o.nwk"),
                           "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "not yet ported" in err and what in err, err


def test_exact_placement_not_ported():
    from dipper_tpu_torch.placement import build_placement_tree_from_matrix
    from dipper_tpu_torch.utils.params import Param

    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_placement_tree_from_matrix(np.zeros((4, 4)), list("abcd"),
                                         Param(), device="cpu", exact=True)


def test_device_cuda_without_cuda_raises(tmp_path, phylip):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["-i", "d", "-I", phylip, "-O", str(tmp_path / "o.nwk"),
                   "-m", "1", "--device", "cuda"])
