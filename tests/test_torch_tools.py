"""dipper_tpu_torch.tools against dipper_tpu.tools on tests/test_tools.py's
inputs: every subcommand gives the same exit code, standard output and
error, and the same output bytes (files and directories)."""

import os

import numpy as np
import pytest

from dipper_tpu.tools import main as jax_tools
from dipper_tpu_torch.io.phylip import write_phylip_lower_triangular
from dipper_tpu_torch.tools import main as port_tools

from datagen import simulate_unaligned, write_fasta

TREE_A = "((A:1,B:1):1,(C:1,D:1):1);"
TREE_B = "((A:1,C:1):1,(B:1,D:1):1);"
TREE_5 = "((A:1,B:2):0.5,((C:1,D:1):0.25,E:3):0.5);"


@pytest.fixture
def inputs(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.nwk").write_text(TREE_A)
    (d / "b.nwk").write_text(TREE_B)
    (d / "t5.nwk").write_text(TREE_5)
    (d / "m.phy").write_text("3\nA\nB 0.5\nC 0.25 0.125\n")
    rng = np.random.default_rng(4)
    D = rng.random((6, 6))
    write_phylip_lower_triangular([f"T{i}" for i in range(6)], (D + D.T) / 2,
                                  str(d / "lower.phy"))
    names, seqs = simulate_unaligned(8, 60, np.random.default_rng(5))
    write_fasta(str(d / "s.fa"), names, seqs)
    (d / "sub.nwk").write_text(f"(({names[1]}:1,{names[4]}:1):1,"
                               f"{names[6]}:2);")
    (d / "c.fa").write_text(">c1/x\nAC\n>c2\nGT\n")
    (d / "aln.fa").write_text(">s1\nACGT\n>s2\nTTAA\n")
    (d / "m.tsv").write_text("\tA\tB\tC\nA\t0\t1\t2\nB\t1\t0\t3\nC\t2\t3\t0\n")
    (d / "ids.txt").write_text("B\n\nC\n")
    return d


# each case: a list of commands, "IN/" and "OUT/" standing for the input
# and the package's own output directory
CASES = {
    "nrf": [["nrf", "IN/a.nwk", "IN/b.nwk"]],
    "lower-to-full": [["lower-to-full", "IN/lower.phy", "OUT/full.phy"]],
    "prune-fasta": [["prune-fasta", "IN/s.fa", "IN/sub.nwk", "OUT/p.fa"]],
    "bl-scale": [["bl-scale", "IN/t5.nwk", "2.5", "OUT/s.nwk"]],
    "phylip-to-tab": [["phylip-to-tab", "IN/m.phy", "OUT/m.tsv"],
                      ["phylip-to-tab", "IN/m.phy"]],
    "prune-tree": [["prune-tree", "IN/t5.nwk", "3", "OUT/p.nwk", "7"]],
    "convert": [["convert", "IN/aln.fa", "OUT/a.phy", "fasta", "phylip"],
                ["convert", "OUT/a.phy", "OUT/a.sto", "phylip", "stockholm"],
                ["convert", "OUT/a.sto", "OUT/b.fa", "stockholm", "fasta"],
                ["convert", "IN/aln.fa", "OUT/same.fa", "fasta", "fasta"]],
    "split-fasta": [["split-fasta", "IN/c.fa", "OUT/split"]],
    "concat-contigs": [["concat-contigs", "IN/c.fa", "OUT/cat.fa", "genome"],
                       ["concat-contigs", "IN/c.fa", "OUT/cat2.fa"]],
    "remove-from-matrix": [["remove-from-matrix", "IN/m.tsv", "IN/ids.txt",
                            "OUT/o.tsv"]],
}


def _run(main, cmds, inp, out, capsys):
    os.makedirs(out)
    said = []
    for cmd in cmds:
        argv = [a.replace("IN/", f"{inp}/").replace("OUT/", f"{out}/")
                for a in cmd]
        rc = main(argv)
        cap = capsys.readouterr()
        said.append((rc, cap.out.replace(str(out), "OUT"),
                     cap.err.replace(str(out), "OUT")))
    files = {}
    for root, _, names in os.walk(out):
        for nm in names:
            p = os.path.join(root, nm)
            with open(p, "rb") as f:
                files[os.path.relpath(p, out)] = f.read()
    return said, files


@pytest.mark.parametrize("name", list(CASES))
def test_tool_equals_jax(name, inputs, tmp_path, capsys):
    cmds = CASES[name]
    want = _run(jax_tools, cmds, inputs, tmp_path / "jax", capsys)
    got = _run(port_tools, cmds, inputs, tmp_path / "port", capsys)
    assert got == want
    assert all(rc == 0 for rc, _, _ in got[0])
    assert got[1] or name in ("nrf", "phylip-to-tab")


@pytest.mark.parametrize("argv", [[], ["no-such-command"]])
def test_usage_exits_1_as_in_jax(argv, capsys):
    """No subcommand, or an unknown one: exit 1 and the usage text (each
    package's own module name in it)."""
    assert jax_tools(argv) == 1
    want = capsys.readouterr()
    assert port_tools(argv) == 1
    got = capsys.readouterr()
    assert got.err == want.err
    usage = [ln for ln in want.out.splitlines() if ln.startswith("  python")]
    assert len(usage) == 10
    assert [ln for ln in got.out.splitlines()
            if ln.startswith("  python")] == [
        ln.replace("dipper_tpu.tools", "dipper_tpu_torch.tools")
        for ln in usage]
