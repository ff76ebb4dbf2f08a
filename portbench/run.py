#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with the cell's cards.  Set-up
(weights and inputs from the seed, the program built and warmed on the
cell's shapes) runs first; the window measures for ``--seconds``; with
``--trace 1`` a short profiled sub-window follows and the line carries
the per-layer metrics, else the end-to-end ones.  Then the program's
state is freed and the outputs the window produced are compared with the
plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
trace ``breakdown``, and the compared numbers beside their limits under
``checks``, last); the compared numbers are also the last lines of
standard error.

Exits non-zero with no result line when CUDA is absent or has fewer
cards than the cell asks for, when any step fails, and when a module of
JAX or of the JAX package is loaded once the run is over.  Build and
kernel caches stay in ``build/`` inside the checkout; the host's numeric
libraries run one thread.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def setup_paths() -> None:
    """The checkout's root (``portbench``) and ``src`` (the program) on
    the import path; the script's own directory off it, so that its
    ``trace.py`` never shadows the standard library's ``trace``."""
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != BENCH]
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def power_limit_w():
    """The card's power limit in W, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(wl: dict, seed: int, seconds: float, trace: bool, *,
            device="cuda", config: dict | None = None,
            traffic: dict | None = None, t0: float = T0) -> tuple:
    """One run of the cell ``wl`` after the look for its cards: set-up,
    window, the optional profiled sub-window, the metrics, the release
    of the program's state and the check.  ``config`` and ``traffic``
    stand in for the cell's files (the CPU tests' small sizes).  ->
    (result dict in the line's key order, checks, the cell, whose
    ``check`` can be asked again, e.g. for the control)."""
    import torch

    from portbench import harness

    man = harness.manifest()
    config = config or harness.load_config(man, wl["config"])
    traffic = traffic or harness.load_traffic(wl["traffic"])
    driver = harness.load_driver(traffic["driver"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = driver.Cell(config, traffic, seed, device,
                       harness.load_limits(wl["name"]))
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cell.window(seconds)
    summary = cell.traced() if trace else None
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    ctx = cell.context()
    ctx.update(setup_s=setup_s, trace=summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = harness.read_metrics(
        harness.cell_metrics(man, wl["name"], kind), ctx)
    cell.release()
    checks = cell.check(harness.load_reference(wl["config"]))
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": wl["chips"], "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": harness.checks_pass(checks),
           "attempted": cell.attempted, "failed": cell.failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out, checks, cell


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    from portbench import harness

    harness.setup_env()
    wl = harness.workload(harness.manifest(), args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl["chips"]:
        print(f"{wl['name']} needs {wl['chips']} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 3
    torch.set_num_threads(harness.HOST_THREADS)
    out, checks, _ = execute(wl, args.seed & ((1 << 63) - 1), args.seconds,
                          bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 4
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(checks=checks, **out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
