#!/usr/bin/env python3
"""Readings of a cell's compared numbers on many seeds, in one process:
the program's, and the lower-precision control's (the reference at the
nearest precision below the configuration's, in the program's place).
The limits in ``checks/<workload>.json`` are set from these readings.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 5 [--set streams=4096] \\
        [--out control_<name>.jsonl]

Each seed runs the cell's set-up and a window of ``--seconds`` at the
cell's own sizes, then the check; a seed in ``--control-seeds`` also
runs the control on the same inputs and sample.  One JSON line a seed.
``--set key=value`` overrides a traffic parameter (a sweep's knob).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def overrides(items) -> dict:
    out = {}
    for item in items or ():
        key, value = item.split("=", 1)
        out[key] = json.loads(value)
    return out


def readings(workload: str, seed: int, seconds: float, control: bool,
             traffic_set: dict | None = None, device="cuda") -> dict:
    """One seed's run (``run.execute``: set-up, window, check); the
    compared numbers, and the control's with ``control``."""
    import torch

    from portbench import harness, run

    wl = harness.workload(harness.manifest(), workload)
    traffic = dict(harness.load_traffic(wl["traffic"]), **(traffic_set or {}))
    out, checks, cell = run.execute(wl, seed, seconds, False, device=device,
                                    traffic=traffic, t0=time.perf_counter())
    rec = {"workload": workload, "seed": seed, "seconds": seconds,
           "traffic_set": traffic_set or {},
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "peak_bytes": out["device"]["memory_peak_bytes"],
           "program": checks, "program_readings": cell.readings}
    if control:
        rec["control"] = cell.check(
            harness.load_reference(wl["config"]), control=True)
        rec["control_readings"] = cell.readings
    del cell
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness, run

    run.setup_paths()
    harness.setup_env()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds + sorted(ctrl - set(seeds)):
            rec = readings(args.workload, seed, args.seconds, seed in ctrl,
                           overrides(args.set))
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
