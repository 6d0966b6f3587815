#!/bin/bash
# The port's multi-rank paths on a host with several cards (NCCL): the
# CLI's --devices N without a coordinator (N local ranks, one card each)
# against the single-process build for NJ (-m 2) and D&C (-m 3), the
# trees required byte-equal, and sharded_mash_matrix and
# sharded_placement_build over N ranks against the single-process build
# (chip_smoke.py's phase 22 with N ranks).
#
#   bash scripts/multi_card_torch.sh [N] [TAXA] [OUT_DIR]
#
# N defaults to the host's card count, TAXA to 4,400 (the generator's
# set, seed 1), OUT_DIR to build/multi_card (the CLI logs; the
# times are in their "NJ sharded over", "DC phase" and "Tree Created"
# lines). Exits non-zero on the first difference or failure.
set -euo pipefail
cd "$(dirname "$0")/.."
N=${1:-$(nvidia-smi -L | wc -l)}
TAXA=${2:-4400}
OUT=${3:-build/multi_card}
mkdir -p "$OUT" build
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 scripts/make_dataset.py -n "$TAXA" -L 10000 -o "build/mc$TAXA" \
  --seed 1 > /dev/null
FA="build/mc$TAXA.fa"
for m in 2 3; do
  python3 -m dipper_tpu_torch.cli -i r -I "$FA" -O "build/mc.single$m.nwk" \
    -m "$m" 2> "$OUT/single_m$m.log"
  timeout 900 python3 -m dipper_tpu_torch.cli -i r -I "$FA" \
    -O "build/mc.ranks$m.nwk" -m "$m" --devices "$N" 2> "$OUT/ranks_m$m.log"
  cmp "build/mc.single$m.nwk" "build/mc.ranks$m.nwk"
  echo "-m $m: $N ranks == single"
  grep -hE "NJ in|NJ sharded|DC phase . in|Tree Created" \
    "$OUT/single_m$m.log" "$OUT/ranks_m$m.log" | sort | uniq -c
done
timeout 900 python3 - "$FA" "$N" "$TAXA" <<'PY'
import sys
import tempfile

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

with tempfile.TemporaryDirectory() as tmp:
    res = cs.phase_sharded_library(tmp, sys.argv[1],
                                   min(cs.SHARDED_N, int(sys.argv[3])),
                                   world=int(sys.argv[2]))
    print("sharded library:", res["backend"])
PY
