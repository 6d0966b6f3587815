"""The port's CLI (`--device cpu`) vs dipper_tpu.cli on the inputs of
tests/test_cli_placement.py: identical Newick bytes in f64 (bitwise
equal builds), nRF = 0 in f32 (the trees are bitwise equal there too, but
nRF is the contract the f32 path is held to), for k-closest placement and
conventional NJ; identical PHYLIP bytes for the mash matrix (-i r -o d).
From aligned FASTA (-i m) the distances are each package's own log and
sqrt results, so trees are held to `assert_newick_close` (the same tree,
branch lengths to rtol 1e-9 in f64) and matrices to rtol 1e-12.
Divide-and-conquer (-m 3, and auto mode at the threshold) gives the JAX
CLI's f64 bytes from -i r and -i m and refuses a matrix as it does. Runs
over two processes (--coordinator, --devices 2) give the single-process
bytes; --profile writes a trace and the same tree."""

import re

import numpy as np
import pytest
import torch

from dipper_tpu.cli import main as jax_main
from dipper_tpu.io.phylip import write_phylip_lower_triangular
from dipper_tpu_torch.cli import main as port_main
from dipper_tpu_torch.utils.treecmp import rf_distance

from datagen import simulate_alignment, simulate_unaligned, write_fasta
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


_LENGTH = re.compile(r":(nan|-?inf|-?[0-9][0-9.eE+-]*)")


def assert_newick_close(got: str, want: str, rtol: float = 1e-9):
    """The same tree written the same way (so nRF = 0), its branch
    lengths within rtol: what -i m outputs are held to where a distance's
    last digit differs between the packages' log and sqrt."""
    if got == want:
        return
    # a NaN length (a model that is undefined on some pair poisons the
    # tree in both packages) is NaN in the same places, with the same sign
    assert _LENGTH.sub(":", got) == _LENGTH.sub(":", want)
    a = np.array(_LENGTH.findall(got), dtype=np.float64)
    b = np.array(_LENGTH.findall(want), dtype=np.float64)
    assert np.allclose(a, b, rtol=rtol, atol=1e-12, equal_nan=True), \
        np.nanmax(np.abs(a - b))


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


def _ranks(tmp_path, args, world=2, timeout=120):
    """The port's CLI as `world` processes of one group (--coordinator on
    a free localhost port, --device cpu); every process is killed past
    `timeout` seconds. Returns the output path and each rank's stderr."""
    import os
    import subprocess
    import sys
    import time

    from dipper_tpu_torch.parallel.distributed import free_port

    out = tmp_path / "ranks.nwk"
    coord = f"127.0.0.1:{free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dipper_tpu_torch.cli", *args, "-O", str(out),
         "--device", "cpu", "--coordinator", coord, "--num-processes",
         str(world), "--process-id", str(r)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            errs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
        assert not re.search(r"\bjax\b", err)
    return out, errs


def _single(tmp_path, args):
    out = tmp_path / "single.nwk"
    assert port_main(args + ["-O", str(out), "--device", "cpu"]) == 0
    return out.read_text()


def test_two_ranks_nj_from_a_matrix_equal_single(tmp_path, phylip):
    """-i d -m 2 over two processes, --devices 2: the Q scan split by rows
    gives the single-process Newick bytes (f32 and f64 alike)."""
    for prec in ("f32", "f64"):
        args = ["-i", "d", "-I", phylip, "-m", "2", "--precision", prec]
        out, errs = _ranks(tmp_path, args + ["--devices", "2"])
        assert out.read_text() == _single(tmp_path, args)
        for r, err in enumerate(errs):
            assert f"Joined distributed runtime: process {r}/2" in err
            assert "Collectives over 2 ranks: gloo" in err
            assert "Sharding over 2 devices" in err
            assert re.search(r"NJ sharded over 2 ranks \(gloo\): 33 merge "
                             r"steps, [0-9.]+ ms a step, 0 host syncs", err)


def test_two_ranks_dc_from_fasta_equal_single(tmp_path, dc_fasta):
    """-i r -m 3 over two processes, --devices 2: phases 2 and 3 split by
    rank give the single-process Newick bytes; each rank logs its own
    phase times."""
    args = ["-i", "r", "-I", dc_fasta, "-m", "3", "-k", "12", "-s", "150",
            "--precision", "f64", "--seed", "7"]
    out, errs = _ranks(tmp_path, args + ["--devices", "2"])
    assert out.read_text() == _single(tmp_path, args)
    for err in errs:
        assert "Sharding over 2 devices" in err
        for phase in (1, 2, 3):
            assert f"DC phase {phase} in:" in err


def test_two_ranks_placement_runs_whole_on_each(tmp_path, phylip):
    """Placement ignores --devices, as in the JAX package: each rank builds
    the whole tree and rank 0 writes it."""
    args = ["-i", "d", "-I", phylip, "-m", "1", "--precision", "f64"]
    out, errs = _ranks(tmp_path, args + ["--devices", "2"])
    assert out.read_text() == _single(tmp_path, args)
    assert not any("Sharding" in err for err in errs)


def test_profile_writes_a_trace_and_the_same_tree(tmp_path, phylip, capsys):
    import json

    args = ["-i", "d", "-I", phylip, "-m", "2"]
    want = _single(tmp_path, args)
    out, trace_dir = tmp_path / "prof.nwk", tmp_path / "trace"
    assert port_main(args + ["-O", str(out), "--device", "cpu", "--profile",
                             str(trace_dir)]) == 0
    assert out.read_text() == want
    trace = trace_dir / "trace.rank0.json"
    assert "Profile trace:" in capsys.readouterr().err
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_devices_on_one_cpu_build_unsharded(tmp_path, phylip, capsys):
    """--device cpu --devices 2 with no coordinator has one device: the
    single-process tree, and a log line that says so."""
    args = ["-i", "d", "-I", phylip, "-m", "2"]
    want = _single(tmp_path, args)
    capsys.readouterr()
    got = _single(tmp_path, args + ["--devices", "2"])
    assert got == want
    err = capsys.readouterr().err
    assert "--devices 2: one device here (cpu), building unsharded" in err
    assert "Sharding" not in err


@pytest.mark.parametrize("flags", [
    ["--coordinator", "127.0.0.1:1"],
    ["--num-processes", "2"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "2"],
])
def test_incomplete_multi_process_flags_exit_1(tmp_path, phylip, capsys,
                                               flags):
    rc = port_main(["-i", "d", "-I", phylip, "-O", str(tmp_path / "o.nwk"),
                    "--device", "cpu"] + flags)
    assert rc == 1
    assert "ERROR:" in capsys.readouterr().err


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    names, seqs = simulate_alignment(25, 300, np.random.default_rng(9),
                                     gap_frac=0.05)
    path = tmp_path_factory.mktemp("msa") / "aligned.fa"
    write_fasta(str(path), names, seqs)
    return str(path)


# -i m modes: auto (NJ below 30,000 taxa), forced NJ, k-closest placement
MSA_MODES = [pytest.param([], id="auto"), pytest.param(["-m", "2"], id="m2"),
             pytest.param(["-m", "1"], id="m1")]


@pytest.mark.parametrize("seed", ["-1", "42"])
@pytest.mark.parametrize("mode", MSA_MODES)
def test_msa_f64_same_tree(tmp_path, aligned, mode, seed):
    want, got = _both(tmp_path, ["-i", "m", "-I", aligned, "-d", "2",
                                 "--precision", "f64", "--seed", seed] + mode)
    assert_newick_close(got, want)


@pytest.mark.parametrize("dt", ["1", "2", "3", "4", "5", "6"])
@pytest.mark.parametrize("mode", MSA_MODES[1:])
def test_msa_every_model_f64_same_tree(tmp_path, aligned, mode, dt):
    want, got = _both(tmp_path, ["-i", "m", "-I", aligned, "-d", dt,
                                 "--precision", "f64"] + mode)
    assert_newick_close(got, want)
    if dt == "3":
        # Tajima-Nei is NaN on some pair here and every length of the
        # tree NaN: the same bytes, NaN signs included
        assert "nan" in got and got == want


@pytest.mark.parametrize("mode", MSA_MODES)
def test_msa_f32_nrf_zero(tmp_path, aligned, mode):
    want, got = _both(tmp_path, ["-i", "m", "-I", aligned, "-d", "2"] + mode)
    assert rf_distance(got, want)[0] == 0


@pytest.mark.parametrize("extra", [[], ["--precision", "f64"],
                                   ["-d", "5", "--precision", "f64"]])
def test_msa_matrix_output(tmp_path, aligned, extra):
    """-i m -o d: the MSA matrix NJ would use, widened to f64; equal to
    the reference's to rtol 1e-12 (f64) or 2e-6 (f32), names and layout
    the same."""
    from dipper_tpu_torch.io.phylip import read_phylip_lower_triangular

    want, got = _both(tmp_path, ["-i", "m", "-I", aligned, "-o", "d", "-d",
                                 "2"] + extra)
    if got != want:
        (wn, wd), (gn, gd) = (read_phylip_lower_triangular(
            str(tmp_path / f)) for f in ("jax.nwk", "port.nwk"))
        assert gn == wn
        rtol = 1e-12 if "f64" in extra else 2e-6
        assert np.allclose(gd, wd, rtol=rtol, atol=0)


def test_msa_nj_log_lines(tmp_path, aligned, capsys):
    assert port_main(["-i", "m", "-I", aligned, "-O", str(tmp_path / "o.nwk"),
                      "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    for line in ("Input in:", "Using conventional NJ", "Distance matrix in:",
                 "NJ in:", "Tree Created in:"):
        assert line in err, err


@pytest.mark.parametrize("fmt", ["d", "r", "m"])
def test_exact_placement_through_the_cli(tmp_path, phylip, fasta, aligned,
                                         fmt, monkeypatch, capsys):
    """The -m value 0 is auto mode with exact placement, reached at N >=
    the placement threshold, which is lowered here in both packages."""
    import dipper_tpu.driver as jdrv
    import dipper_tpu_torch.driver as pdrv

    monkeypatch.setattr(jdrv, "PLACEMENT_THRESHOLD", 10)
    monkeypatch.setattr(pdrv, "PLACEMENT_THRESHOLD", 10)
    inp = {"d": phylip, "r": fasta, "m": aligned}[fmt]
    want, got = _both(tmp_path, ["-i", fmt, "-I", inp, "-m", "0", "-k", "12",
                                 "-s", "150", "-d", "2", "--precision",
                                 "f64"])
    assert "Using exact placement mode" in capsys.readouterr().err
    if fmt == "m":
        assert_newick_close(got, want)
    else:
        assert got == want


def test_exact_state_checkpoint_through_the_cli(tmp_path, phylip,
                                                monkeypatch):
    """--save-state/--load-state with exact placement: the port's
    checkpoint resumes in the reference's CLI and the other way round, to
    the plain run's bytes."""
    import dipper_tpu.driver as jdrv
    import dipper_tpu_torch.driver as pdrv

    monkeypatch.setattr(jdrv, "PLACEMENT_THRESHOLD", 10)
    monkeypatch.setattr(pdrv, "PLACEMENT_THRESHOLD", 10)
    base = ["-i", "d", "-I", phylip, "-m", "0", "--precision", "f64",
            "--state-chunk", "9"]
    want, got = _both(tmp_path, base)
    assert got == want
    for saver, loader, extra in ((port_main, jax_main, ["--device", "cpu"]),
                                 (jax_main, port_main, [])):
        ck = str(tmp_path / f"ck{len(extra)}.npz")
        out = tmp_path / f"resumed{len(extra)}.nwk"
        assert saver(base + ["--save-state", ck, "-O",
                             str(tmp_path / "s.nwk")] + extra) == 0
        other = ["--device", "cpu"] if not extra else []
        assert loader(base + ["--load-state", ck, "-O", str(out)]
                      + other) == 0
        assert out.read_text() == want


@pytest.fixture(scope="module")
def dc_fasta(tmp_path_factory):
    """tests/test_cli_dc.py's input."""
    names, seqs = simulate_unaligned(100, 1200, np.random.default_rng(99))
    path = tmp_path_factory.mktemp("dc") / "in.fa"
    write_fasta(str(path), names, seqs)
    return str(path)


def test_dc_mash_f64_identical_bytes(tmp_path, dc_fasta, capsys):
    """-i r -m 3 (B = N // 20 = 5): the JAX CLI's Newick bytes."""
    want, got = _both(tmp_path, ["-i", "r", "-I", dc_fasta, "-m", "3", "-k",
                                 "12", "-s", "150", "--precision", "f64",
                                 "--seed", "7"])
    assert got == want
    assert "Using divide-and-conquer mode" in capsys.readouterr().err


def test_dc_msa_f64_identical_bytes(tmp_path, aligned):
    """-i m -m 3 from 25 aligned sequences is refused in both packages
    (B = 1 < 4), and 120 give the JAX CLI's Newick bytes."""
    names, seqs = simulate_alignment(120, 400, np.random.default_rng(12),
                                     gap_frac=0.03, blen_scale=0.5)
    path = tmp_path / "a120.fa"
    write_fasta(str(path), names, seqs)
    want, got = _both(tmp_path, ["-i", "m", "-I", str(path), "-m", "3",
                                 "-d", "2", "--precision", "f64"])
    assert got == want
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit, match="backbone too small"):
            main(["-i", "m", "-I", aligned, "-m", "3", "-O",
                  str(tmp_path / "x.nwk")]
                 + (["--device", "cpu"] if main is port_main else []))


def test_dc_matrix_input_refused_as_in_jax(tmp_path, phylip):
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit, match="not supported with input "
                                             "matrix"):
            main(["-i", "d", "-I", phylip, "-m", "3", "-O",
                  str(tmp_path / "x.nwk")]
                 + (["--device", "cpu"] if main is port_main else []))


def test_dc_auto_mode_at_the_threshold(tmp_path, dc_fasta, monkeypatch,
                                       capsys):
    """Auto mode takes D&C at N >= DC_THRESHOLD (1,000,000; lowered here
    to the input's 100 taxa): the same tree as -m 3."""
    from dipper_tpu_torch import driver

    base = ["-i", "r", "-I", dc_fasta, "-k", "12", "-s", "150",
            "--precision", "f64", "--device", "cpu"]
    assert port_main(base + ["-m", "3", "-O", str(tmp_path / "m3.nwk")]) == 0
    monkeypatch.setattr(driver, "DC_THRESHOLD", 100)
    capsys.readouterr()
    assert port_main(base + ["-O", str(tmp_path / "auto.nwk")]) == 0
    assert "Using divide-and-conquer mode" in capsys.readouterr().err
    assert ((tmp_path / "auto.nwk").read_text()
            == (tmp_path / "m3.nwk").read_text())


def test_dc_device_cuda_without_cuda_raises(tmp_path, dc_fasta):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["-i", "r", "-I", dc_fasta, "-O", str(tmp_path / "o.nwk"),
                   "-m", "3", "--device", "cuda"])


def test_device_cuda_without_cuda_raises(tmp_path, phylip):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["-i", "d", "-I", phylip, "-O", str(tmp_path / "o.nwk"),
                   "-m", "1", "--device", "cuda"])
