"""Small command-line utilities mirroring the reference's scripts/: a
copy of dipper_tpu/tools.py on the port's host modules (io/, utils/
treecmp.py), so that it runs without JAX. Host code only.

  python -m dipper_tpu_torch.tools nrf A.nwk B.nwk
      normalized Robinson-Foulds between two trees (scripts/nrf.sh
      equivalent, computed natively instead of via MAPLE)

  python -m dipper_tpu_torch.tools lower-to-full in.phy out.phy
      lower-triangular PHYLIP -> full matrix
      (scripts/lower_to_full_phylip.cpp equivalent)

  python -m dipper_tpu_torch.tools prune-fasta in.fa tree.nwk out.fa
      keep only sequences whose names are leaves of the tree
      (scripts/prune_fasta_from_newick.cpp equivalent)

  python -m dipper_tpu_torch.tools bl-scale in.nwk factor out.nwk
      multiply every branch length (scripts/bl_scale.py equivalent)

  python -m dipper_tpu_torch.tools phylip-to-tab in.phy [out.tsv]
      full/ragged PHYLIP matrix -> tab-delimited with label header
      (scripts/phylip_to_tab.cpp equivalent; 10-decimal fixed values)

  python -m dipper_tpu_torch.tools prune-tree in.nwk count out.nwk [seed]
      sample `count` tips uniformly and prune the rest, collapsing
      unary internals by summing branch lengths
      (scripts/prune_tree.py equivalent, seeded)

  python -m dipper_tpu_torch.tools convert in out from_fmt to_fmt
      sequence format conversion among fasta / phylip / stockholm
      (scripts/format_converter.py equivalent, no Biopython)

  python -m dipper_tpu_torch.tools split-fasta in.fa out_dir
      one FASTA file per record, names sanitized
      (scripts/mash_split.py equivalent)

  python -m dipper_tpu_torch.tools concat-contigs in.fa out.fa [name]
      concatenate all contigs into a single record named after the
      input file (scripts/concatContigs.py equivalent)

  python -m dipper_tpu_torch.tools remove-from-matrix m.tsv ids.txt out.tsv
      drop rows of a tab-delimited labeled matrix whose label appears
      in ids.txt (scripts/remove_sequences_from_fasta.py equivalent)
"""

from __future__ import annotations

import os
import sys


def _cmd_nrf(argv):
    from dipper_tpu_torch.utils.treecmp import rf_distance

    a = open(argv[0]).read()
    b = open(argv[1]).read()
    rf, nrf = rf_distance(a, b)
    print(f"RF\t{rf}")
    print(f"nRF\t{nrf:.6f}")
    return 0


def _cmd_lower_to_full(argv):
    from dipper_tpu_torch.io.phylip import read_phylip_lower_triangular

    names, D = read_phylip_lower_triangular(argv[0])
    with open(argv[1], "w") as f:
        f.write(f"{len(names)}\n")
        for i, nm in enumerate(names):
            row = " ".join(f"{D[i, j]:.9g}" for j in range(len(names)))
            f.write(f"{nm}\t{row}\n")
    return 0


def _cmd_prune_fasta(argv):
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.utils.treecmp import _splits_from_newick

    names, seqs = read_fasta(argv[0])
    _, leaves = _splits_from_newick(open(argv[1]).read())
    kept = 0
    with open(argv[2], "wb") as f:
        for nm, sq in zip(names, seqs):
            if nm in leaves:
                f.write(b">" + nm.encode() + b"\n" + sq + b"\n")
                kept += 1
    print(f"kept {kept}/{len(names)} sequences", file=sys.stderr)
    return 0


def _cmd_bl_scale(argv):
    import re

    factor = float(argv[1])
    s = open(argv[0]).read()

    def repl(m):
        return ":" + repr(float(m.group(1)) * factor)

    out = re.sub(r":([0-9.eE+-]+)", repl, s)
    open(argv[2], "w").write(out)
    return 0


def _cmd_phylip_to_tab(argv):
    """Mirror scripts/phylip_to_tab.cpp:7-53: read N, then N lines of
    `label v v v...` (any count of values per row), emit a TSV with a
    leading label header row and 10-decimal fixed values, every field
    followed by a tab."""
    with open(argv[0]) as f:
        n = int(f.readline().split()[0])
        labels, rows = [], []
        for _ in range(n):
            parts = f.readline().split()
            labels.append(parts[0])
            rows.append([float(v) for v in parts[1:]])
    out = open(argv[1], "w") if len(argv) > 1 else sys.stdout
    out.write("\t" + "\t".join(labels) + "\t\n")
    for lab, row in zip(labels, rows):
        out.write(lab + "\t" + "".join(f"{v:.10f}\t" for v in row) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_prune_tree(argv):
    """scripts/prune_tree.py:7-15 semantics: uniformly sample `count`
    tips, prune every other tip; a parent left with one child is
    collapsed (child absorbs the parent's branch length)."""
    import random

    from dipper_tpu_torch.io.newick import parse_newick, write_newick, Tree

    s = open(argv[0]).read()
    count = int(argv[1])
    rng = random.Random(int(argv[3]) if len(argv) > 3 else None)
    tree = parse_newick(s, 1 << 30)
    tips = [n for n in tree.all_nodes.values() if n.is_leaf()]
    keep = set(id(t) for t in rng.sample(tips, count))
    for tip in tips:
        if id(tip) in keep:
            continue
        node = tip
        # detach the tip, then collapse any resulting unary ancestors
        while node.parent is not None:
            parent = node.parent
            parent.children.remove(node)
            if parent.children:
                if len(parent.children) == 1 and parent.parent is not None:
                    only = parent.children[0]
                    only.bl += parent.bl
                    only.parent = parent.parent
                    gp = parent.parent
                    gp.children[gp.children.index(parent)] = only
                break
            node = parent
    root = tree.root
    while len(root.children) == 1 and not root.children[0].is_leaf():
        root = root.children[0]
        root.parent = None
        root.bl = 0.0
    open(argv[2], "w").write(write_newick(
        Tree(root, tree.all_nodes, tree.num_leaves)) + "\n")
    return 0


def _read_any_seqs(path, fmt):
    if fmt == "fasta":
        from dipper_tpu_torch.io.fasta import read_fasta

        names, seqs = read_fasta(path)
        return names, [s.decode() for s in seqs]
    if fmt == "phylip":
        with open(path) as f:
            n, _L = (int(x) for x in f.readline().split()[:2])
            names, seqs = [], []
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                names.append(parts[0])
                seqs.append("".join(parts[1:]))
        return names[:n], seqs[:n]
    if fmt == "stockholm":
        names, chunks = [], {}
        for line in open(path):
            line = line.rstrip("\n")
            if (not line or line.startswith("#") or line.startswith("//")):
                continue
            nm, _, sq = line.partition(" ")
            sq = sq.strip().replace(".", "-")
            if nm not in chunks:
                names.append(nm)
                chunks[nm] = []
            chunks[nm].append(sq)
        return names, ["".join(chunks[nm]) for nm in names]
    raise SystemExit(f"unknown format: {fmt}")


def _write_any_seqs(path, fmt, names, seqs):
    with open(path, "w") as f:
        if fmt == "fasta":
            for nm, sq in zip(names, seqs):
                f.write(f">{nm}\n{sq}\n")
        elif fmt == "phylip":
            L = len(seqs[0]) if seqs else 0
            if any(len(s) != L for s in seqs):
                raise SystemExit("phylip output requires aligned sequences")
            f.write(f" {len(names)} {L}\n")
            for nm, sq in zip(names, seqs):
                f.write(f"{nm}  {sq}\n")
        elif fmt == "stockholm":
            f.write("# STOCKHOLM 1.0\n")
            for nm, sq in zip(names, seqs):
                f.write(f"{nm} {sq}\n")
            f.write("//\n")
        else:
            raise SystemExit(f"unknown format: {fmt}")


def _cmd_convert(argv):
    inp, out, in_fmt, out_fmt = argv[:4]
    if in_fmt == out_fmt:
        return 0  # reference exits silently on same-format
    names, seqs = _read_any_seqs(inp, in_fmt)
    _write_any_seqs(out, out_fmt, names, seqs)
    return 0


def _cmd_split_fasta(argv):
    from dipper_tpu_torch.io.fasta import read_fasta

    names, seqs = read_fasta(argv[0])
    os.makedirs(argv[1], exist_ok=True)
    for nm, sq in zip(names, seqs):
        title = nm.replace(" ", "_").replace("/", "_")
        with open(os.path.join(argv[1], f"{title}.fa"), "wb") as f:
            f.write(b">" + nm.encode() + b"\n" + sq + b"\n")
    print(f"wrote {len(names)} files", file=sys.stderr)
    return 0


def _cmd_concat_contigs(argv):
    from dipper_tpu_torch.io.fasta import read_fasta

    _names, seqs = read_fasta(argv[0])
    name = argv[2] if len(argv) > 2 else os.path.basename(argv[0])
    with open(argv[1], "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for sq in seqs:
            f.write(sq + b"\n")
    return 0


def _cmd_remove_from_matrix(argv):
    remove = set(line.strip() for line in open(argv[1]) if line.strip())
    dropped = 0
    with open(argv[0]) as fin, open(argv[2], "w") as fout:
        fout.write(fin.readline())  # header
        for line in fin:
            if line.split("\t", 1)[0] in remove:
                dropped += 1
                continue
            fout.write(line)
    print(f"dropped {dropped} rows", file=sys.stderr)
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "nrf":
        return _cmd_nrf(rest)
    if cmd == "lower-to-full":
        return _cmd_lower_to_full(rest)
    if cmd == "prune-fasta":
        return _cmd_prune_fasta(rest)
    if cmd == "bl-scale":
        return _cmd_bl_scale(rest)
    if cmd == "phylip-to-tab":
        return _cmd_phylip_to_tab(rest)
    if cmd == "prune-tree":
        return _cmd_prune_tree(rest)
    if cmd == "convert":
        return _cmd_convert(rest)
    if cmd == "split-fasta":
        return _cmd_split_fasta(rest)
    if cmd == "concat-contigs":
        return _cmd_concat_contigs(rest)
    if cmd == "remove-from-matrix":
        return _cmd_remove_from_matrix(rest)
    print(f"unknown command: {cmd}", file=sys.stderr)
    print(__doc__)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
