"""The two cells at the CPU tests' size: the same drivers, references,
limits and metric readers as on the card, with smoke-size configurations
(``data/``) and small traffic, through ``run.execute`` on the CPU."""
from __future__ import annotations

import json
import time
from pathlib import Path

from portbench import harness, run

DATA = Path(__file__).resolve().parent / "data"

KWS_TRAFFIC = {"streams": 8, "bank_rows": 37, "warm_rounds": 1,
               "check_streams": 8, "check_hops": 4}
LM_TRAFFIC = {"slots": 4, "max_seq": 256, "max_new": 250, "warm_ticks": 1}


def small(workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, smoke config, small traffic) of a cell."""
    wl = harness.workload(harness.manifest(), workload)
    base = harness.load_traffic(wl["traffic"])
    if base["driver"] == "kws_stream":
        cfg, extra = "pscnn_kws_smoke", KWS_TRAFFIC
    else:
        cfg, extra = "deepseek_moe_16b_smoke", LM_TRAFFIC
    config = json.loads((DATA / f"{cfg}.json").read_text())
    return wl, config, dict(base, **extra)


def run_small(workload: str, seed: int = 1234567890123,
              seconds: float = 0.3) -> tuple[dict, dict]:
    """``run.execute`` of the cell at the CPU tests' size -> (result,
    checks)."""
    wl, config, traffic = small(workload)
    out, checks, _ = run.execute(wl, seed, seconds, False, device="cpu",
                                 config=config, traffic=traffic,
                                 t0=time.perf_counter())
    return out, checks
