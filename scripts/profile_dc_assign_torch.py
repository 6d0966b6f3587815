#!/usr/bin/env python3
"""Kernel 10 (csrc/dc_assign.cu, D&C phase 2's assignment) and its pack
under their plans and under forced clusters and rings, on one GPU.

    python3 scripts/profile_dc_assign_torch.py [--repeats 3]

Cases, on made-up backbone states (placement/score_model.py::
made_up_state, 4B slots, half of the used ones valid, witnesses spread
over the row) and random rows made from seed 20:
- "30k": B = 1,500, 6,000 slots, 4,096 rows (a D&C 30K chunk's shape), in
  f32 and f64;
- "100k": B = 5,000, 20,000 slots, 4,096 rows (D&C 100K's width), in f32
  and f64;
- "b50000": B = 50,000, 200,000 slots, 256 rows, in f32 and f64 (the 1M
  band's width);
- "band": B = 50,000, f32, the 1,342 rows a chunk that dc/pipeline.py's
  PHASE2_BYTES gives there, projected to the band's 950,000 rows.
Each case's slots are held to score_edges_rows_plain, bit for bit, under
every variant first. Then, `repeats` times in turn, the plan and each
variant (clusters of 1 and of the plan's blocks; rings of the plan's
stages, 2, 4, 8, 12 and 16 where they fit) is timed as chip_smoke.py's phase
29 times it: five launches queued behind a device sleep
(chip_smoke.py::queued_each_ms), the median. The pack is timed the same
way on the 6,000- and 200,000-slot states beside its plain version
(kclosest.pack_slots_plain) and its byte bound.

Prints JSON lines, the card's name and power limit first; each case's
line holds every repeat's time, their median ("ms", beside the bound and
floors of chip_smoke.py::assign_bound) and their range. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 20
RING_VARIANTS = (None, 2, 4, 8, 12, 16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def state_on_card(B: int, dtype: str, rng):
    from dipper_tpu_torch.placement import score_model as sm
    import chip_smoke as cs

    d = sm.made_up_state(2 * B - 2, 4 * B, B, dtype, rng, bare=False)
    return cs._assign_state({f: torch.from_numpy(np.array(d[f])).cuda()
                             for f in cs.ASSIGN_FIELDS})


def variants(W: int, item: int) -> list:
    """(cluster, stages) of the plan's rows a block that exist and fit,
    the plan's own first."""
    from dipper_tpu_torch.dc import assign_model as am

    plan = am.kernel_plan(W, item)
    out = []
    for cl in (am.CLUSTER_CTAS, 1):
        for stages in RING_VARIANTS:
            try:
                p = am.kernel_plan(W, item, plan.rows, plan.staged, cl,
                                   stages)
            except ValueError:
                continue
            if (cl, p.stages) not in [(c, s) for c, s, _ in out]:
                out.append((cl, p.stages, stages))
    return out


def profile_case(name: str, st, rows, repeats: int) -> dict:
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.placement import kclosest as tk
    import chip_smoke as cs

    W = rows.shape[1]
    records = assign_cuda.pack(st, W)
    plan = assign_cuda.plan(W, rows.dtype)
    want = torch.cat([tk.score_edges_rows_plain(st, rows[a:a + 256])
                      for a in range(0, rows.shape[0], 256)])
    runs = {}
    out = torch.empty_like(want)
    kws = {}
    for cl, stages, asked in variants(W, rows.element_size()):
        kw = dict(rows_per_block=plan.rows, staged=plan.staged, cluster=cl,
                  stages=asked)
        got = assign_cuda.assign(st, rows, records=records, **kw)
        cs.check(torch.equal(got, want), f"{name}: kernel 10 != plain "
                 f"(cluster {cl}, stages {stages})")
        kws[f"{cl}/{stages}"] = kw
        runs[f"{cl}/{stages}"] = []
    for _ in range(repeats):
        for key, kw in kws.items():
            runs[key].append(cs._median(cs.queued_each_ms(
                [lambda kw=kw: assign_cuda.assign(st, rows, out,
                                                  records=records, **kw)
                 for _ in range(5)])))
    own = f"{plan.cluster}/{plan.stages}"
    rec = {"case": name, "rows": rows.shape[0], "width": W,
           "slots": st.e.shape[0],
           "precision": "f64" if rows.dtype == torch.float64 else "f32",
           "plan": plan._asdict(), "plan_key": own,
           "ms_by_variant": runs,
           "range_by_variant": {k: [min(v), max(v)] for k, v in runs.items()},
           "ms": cs._median(runs[own]), "ms_repeats": runs[own],
           "ms_range": [min(runs[own]), max(runs[own])]}
    return cs.with_share(rec, cs.assign_bound(st, rows, plan))


def profile_pack(name: str, st, width: int, repeats: int) -> dict:
    import chip_smoke as cs

    recs = [cs.pack_times(st, width) for _ in range(repeats)]
    ms = [r["ms"] for r in recs]
    return {**recs[-1], "case": name, "ms_repeats": ms,
            "ms_range": [min(ms), max(ms)],
            "plain_ms_repeats": [r["plain_ms"] for r in recs]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_dc_assign_torch: CUDA is not available",
              file=sys.stderr)
        return 1
    from dipper_tpu_torch.csrc.build import load
    from dipper_tpu_torch.dc import assign_cuda, pipeline
    import chip_smoke as cs

    load("dc_assign", assign_cuda._ARGS)  # set-up: no nvcc in a timed call
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B, n_rows, tag in ((1500, 4096, "30k"), (5000, 4096, "100k"),
                           (50000, 256, "b50000")):
        for dtype in ("float32", "float64"):
            st = state_on_card(B, dtype, rng)
            rows = torch.rand((n_rows, B), generator=gen, device="cuda",
                              dtype=getattr(torch, dtype))
            rows[3, ::97] = float("nan")
            name = f"{tag}_{dtype}"
            emit(profile_case(name, st, rows, args.repeats))
            if dtype == "float32" and B != 5000:
                emit(profile_pack(f"pack_{name}", st, B, args.repeats))
            if B == 50000 and dtype == "float32":
                q = pipeline.PHASE2_BYTES // (B * 4)
                band = torch.rand((q, B), generator=gen, device="cuda")
                rec = profile_case("band_float32", st, band, args.repeats)
                rec["projected_s_1m_band"] = [
                    t * cs.ASSIGN_BAND_QUERIES / q / 1e3
                    for t in rec["ms_range"]]
                emit(rec)
                del band
            del st, rows
    emit({"nvidia_smi_end": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
