"""How often a torch.profiler session on the card misses its first kernels.

A session's first device activity can be missing from its trace.
chip_smoke.py's graph_route_profiled phase counts the cursor route's
kernels by name in a trace, so it starts its session with a lead-in (a
few spin kernels and a device sync) that its counts leave out. This
script measures both ways: --sessions sessions without the lead-in and
as many with it, alternating, each a marker kernel (a multiply) followed
by KERNELS adds, and prints one JSON line with the sessions whose trace
missed the marker or an add.

    python3 scripts/profiler_lead_in_check.py [--sessions 200]
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

KERNELS = 16


def lead_in() -> None:
    """Device work that a profiled window's counts leave out, then a sync."""
    for _ in range(8):
        torch.cuda._sleep(10000)
    torch.cuda.synchronize()


def session(x: torch.Tensor, lead: bool) -> tuple[int, int, list]:
    """One profiled session: the marker kernel, then KERNELS adds. Returns
    the marker's and the adds' kernel records in the trace, and the
    names of the trace's kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead:
            lead_in()
        x.mul_(1.0)               # the marker
        for _ in range(KERNELS):
            x.add_(1.0)
        torch.cuda.synchronize()
    marks = adds = 0
    names = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        names.append([e.key[:120], e.count])
        if "mul" in e.key.lower():
            marks += e.count
        elif "add" in e.key.lower():
            adds += e.count
    return marks, adds, names


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=200)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    x = torch.zeros(1 << 16, device="cuda")
    res = {False: {"sessions": 0, "marker_missing": 0, "adds_missing": 0,
                   "first_session_kernels": None},
           True: {"sessions": 0, "marker_missing": 0, "adds_missing": 0}}
    for s in range(2 * a.sessions):
        lead = bool(s % 2)
        marks, adds, names = session(x, lead)
        r = res[lead]
        r["sessions"] += 1
        r["marker_missing"] += marks != 1
        r["adds_missing"] += adds != KERNELS
        if s == 0:
            r["first_session_kernels"] = names
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "kernels_a_session": KERNELS + 1,
                      "without_lead_in": res[False],
                      "with_lead_in": res[True]}))


if __name__ == "__main__":
    main()
