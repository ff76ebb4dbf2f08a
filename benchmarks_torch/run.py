"""Benchmark harness of the port.

Prints ``name,us_per_call/value,derived`` CSV rows (repo convention).

  PYTHONPATH=src python -m benchmarks_torch.run                 # all suites
  PYTHONPATH=src python -m benchmarks_torch.run kernel roofline

Only the ported suites are here; the reference's paper-table, stream and
accuracy suites are still to port (ROADMAP A.10).
"""
from __future__ import annotations

import sys
import traceback

SUITES = {
    "kernel": "benchmarks_torch.kernel_bench",    # B.7 vs B.8 GEMM duel
    "roofline": "benchmarks_torch.roofline_table",  # dry-run aggregation
}


def main(argv=None) -> None:
    which = (sys.argv[1:] if argv is None else argv) or list(SUITES)
    print("name,us_per_call,derived")
    failed = []
    for key in which:
        mod_name = SUITES[key]
        try:
            mod = __import__(mod_name, fromlist=["run"])
            for line in mod.run():
                print(line, flush=True)
        except Exception as e:  # noqa: BLE001
            failed.append(key)
            print(f"{key}.ERROR,{type(e).__name__},{e}")
            traceback.print_exc(file=sys.stderr)
    if failed:
        raise SystemExit(f"benchmark suites failed: {failed}")


if __name__ == "__main__":
    main()
