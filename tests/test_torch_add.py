"""--add in the port (placing queries onto a loaded backbone) on the CPU
against dipper_tpu: the backbone's edge arrays bitwise; run_add_queries
driven directly from a matrix, and the CLI from -i r and -i m, on binary
and multifurcating backbones (MULTI, and a binary backbone collapsed by
chip_smoke.collapse_backbone; on the CPU they take the dense BFS,
adj=None).
In f64 the final edge arrays and the Newick bytes are equal for the
matrix and for mash (mash distances come from one host table); -i m is
held to the same tree with branch lengths to rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipper_tpu.cli import main as jax_main
from dipper_tpu.io.newick import parse_newick as jax_parse_newick
from dipper_tpu.placement import api as japi
from dipper_tpu.placement import kclosest as jk
from dipper_tpu_torch.cli import main as port_main
from dipper_tpu_torch.io.newick import parse_newick
from dipper_tpu_torch.placement import api as tapi
from dipper_tpu_torch.placement import kclosest as tk
from dipper_tpu_torch.utils.treecmp import _splits_from_newick

from chip_smoke import collapse_backbone

from datagen import simulate_alignment, simulate_unaligned, write_fasta
from test_nj import random_additive_matrix
from test_torch_cli import assert_newick_close

torch.set_num_threads(2)

# leaves in encounter order L0..L7: a root of degree 4, an inner node of
# degree 5 (out-degree > 3 overflows the [M, 3] adjacency rows)
MULTI = ("((L0:0.11,L1:0.2,L2:0.13,L3:0.3):0.1,(L4:0.21,L5:0.12):0.14,"
         "L6:0.2,L7:0.1);")


def _binary_backbone(D, B):
    """Newick of the reference's k-closest tree of the first B taxa."""
    e, belong, length = jax.device_get(jk.run_placement(
        (jnp.asarray(D[:B, :B]),), num_sequences=B, frontend="matrix",
        dtype_name="float64"))
    return jk.edges_to_newick(e, belong, length, [f"L{i}" for i in range(B)],
                              B)


def _matrix(n, seed):
    D = random_additive_matrix(n, np.random.default_rng(seed))
    return D / (D.max() * 1.05)


@pytest.mark.parametrize("kind", ["binary", "multifurcating"])
def test_backbone_arrays_equal_reference(kind):
    n = 14
    nwk = MULTI if kind == "multifurcating" else _binary_backbone(
        _matrix(n, 5), 9)
    want = japi.backbone_tree_to_arrays(jax_parse_newick(nwk, n), n,
                                        jnp.float64)
    got = tapi.backbone_tree_to_arrays(parse_newick(nwk, n), n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    deg = np.bincount(got[1][got[1] >= 0]).max()
    assert (deg > 3) == (kind == "multifurcating")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["binary", "multifurcating", "collapsed"])
def test_run_add_queries_matrix_equals_reference(kind, dtype):
    """run_add_queries from a matrix (the CLI refuses -i d --add): final
    (e, belong, length) equal to the reference's bit for bit."""
    n = 30
    D = _matrix(n, 11)
    if kind == "multifurcating":
        nwk, B = MULTI, 8
    else:
        B = 12
        nwk = _binary_backbone(D, B)
        if kind == "collapsed":
            nwk = collapse_backbone(nwk, 0.3, clade=5)[0]
    tree = parse_newick(nwk, n)
    # the matrix in the tree's leaf order, queries after the backbone
    order = [int(nm[1:]) for nm in tree.leaf_names_in_idx_order()]
    order += [i for i in range(n) if i not in order]
    D = np.ascontiguousarray(D[np.ix_(order, order)]).astype(dtype)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    use_adj = kind == "binary"
    kw = dict(num_sequences=n, backbone_size=B, frontend="matrix",
              dtype_name=dtype, use_adj=use_adj)
    want = jax.device_get(jk.run_add_queries(
        (jnp.asarray(D),), jnp.asarray(e0), jnp.asarray(belong0),
        jnp.asarray(length0, jnp.dtype(dtype)), jnp.asarray(rev0), **kw))
    logs = []
    got = tk.run_add_queries(
        (torch.from_numpy(D),), torch.from_numpy(e0),
        torch.from_numpy(belong0),
        torch.from_numpy(length0).to(getattr(torch, dtype)),
        torch.from_numpy(rev0), log=logs.append, **kw)
    for name, g, w in zip(("e", "belong", "length"), got, want):
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
    # a binary backbone fills its 4B - 4 slots; a multifurcating one has
    # fewer edges and leaves a gap below the cursor, as in the reference
    assert (int((got[1] >= 0).sum()) == 4 * n - 4) == (kind == "binary")
    assert f"Backbone of {B} seeded in" in logs[0]


def _split_set(nwk, keep):
    """The tree's splits restricted to `keep`, each as its side that
    sorts first (tests/test_cli_placement.py's backbone check)."""
    splits, leaves = _splits_from_newick(nwk)
    out = set()
    for s in splits:
        r = frozenset(s & keep)
        if 1 < len(r) < len(keep) - 1:
            out.add(frozenset(min((r, frozenset(keep - r)), key=sorted)))
    return out, leaves


@pytest.fixture(scope="module")
def add_inputs(tmp_path_factory):
    """For -i r and -i m: all 24 sequences, a binary backbone of the first
    16 built by the reference's CLI, the same collapsed, and a
    multifurcating backbone of the first 8."""
    tmp = tmp_path_factory.mktemp("add")
    out = {}
    for fmt in ("r", "m"):
        rng = np.random.default_rng(41)
        names, seqs = (simulate_unaligned(24, 1500, rng) if fmt == "r"
                       else simulate_alignment(24, 400, rng))
        back_fa, all_fa = tmp / f"back.{fmt}.fa", tmp / f"all.{fmt}.fa"
        back_nwk, multi_nwk = tmp / f"back.{fmt}.nwk", tmp / f"multi.{fmt}.nwk"
        write_fasta(str(back_fa), names[:16], seqs[:16])
        write_fasta(str(all_fa), names, seqs)
        assert jax_main(["-i", fmt, "-I", str(back_fa), "-O", str(back_nwk),
                         "-m", "1", "-k", "12", "-s", "150", "--precision",
                         "f64", "--seed", "-1"]) == 0
        multi_nwk.write_text(MULTI.replace("L", "S") + "\n")
        collapsed = tmp / f"collapsed.{fmt}.nwk"
        collapsed.write_text(collapse_backbone(back_nwk.read_text(), 0.3,
                                               clade=6)[0] + "\n")
        out[fmt] = dict(names=names, all_fa=str(all_fa),
                        binary=str(back_nwk), multifurcating=str(multi_nwk),
                        collapsed=str(collapsed))
    return out


@pytest.mark.parametrize("kind", ["binary", "multifurcating", "collapsed"])
@pytest.mark.parametrize("fmt, precision", [("r", "f64"), ("r", "f32"),
                                            ("m", "f64"), ("m", "f32")])
def test_cli_add_equals_reference(tmp_path, add_inputs, capsys, fmt,
                                  precision, kind):
    inp = add_inputs[fmt]
    args = ["-i", fmt, "-I", inp["all_fa"], "--add", "-t", inp[kind], "-k",
            "12", "-s", "150", "-d", "2", "--precision", precision, "--seed",
            "-1"]
    out_j, out_p = tmp_path / "jax.nwk", tmp_path / "port.nwk"
    assert jax_main(args + ["-O", str(out_j)]) == 0
    capsys.readouterr()
    assert port_main(args + ["-O", str(out_p), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert ("using dense witness BFS" in err) == (kind != "binary")
    want, got = out_j.read_text(), out_p.read_text()
    if fmt == "r":
        assert got == want      # also in f32: equal rows, equal arithmetic
    elif precision == "f64":
        assert_newick_close(got, want)
    else:
        assert_newick_close(got, want, rtol=1e-4)
    # every backbone split survives, all leaves are there
    back = open(inp[kind]).read()
    _, back_leaves = _splits_from_newick(back)
    got_splits, leaves = _split_set(got, back_leaves)
    assert leaves == set(inp["names"])
    assert _split_set(back, back_leaves)[0] <= got_splits


def test_cli_add_from_matrix_is_refused(tmp_path, add_inputs, capsys):
    """-i d --add exits 1 with the reference's message."""
    inp = add_inputs["r"]
    args = ["-i", "d", "-I", inp["all_fa"], "--add", "-t", inp["binary"],
            "-O", str(tmp_path / "o.nwk")]
    with pytest.raises(SystemExit) as want:
        jax_main(args)
    want_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        port_main(args + ["--device", "cpu"])
    assert got.value.code == want.value.code == 1
    msg = "Adding new sequences only supported with input aligned"
    assert msg in capsys.readouterr().err and msg in want_err
