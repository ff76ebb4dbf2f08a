"""Aggregate the port's dry-run matrix (results/dryrun_torch/*.json) into
roofline rows.  Rows appear as cells complete; a missing directory is
reported as no results yet."""
from __future__ import annotations

import json
import pathlib

from benchmarks_torch.common import row

DRYRUN_DIR = (pathlib.Path(__file__).resolve().parent.parent / "results"
              / "dryrun_torch")


def run(dryrun_dir=None) -> list[str]:
    d = pathlib.Path(dryrun_dir) if dryrun_dir else DRYRUN_DIR
    rows = []
    if not d.exists():
        return [row("roofline.status", "no results yet",
                    "run: python -m repro_torch.launch.dryrun")]
    cells = sorted(d.glob("*.json"))
    n_ok = n_fail = n_skip = 0
    for path in cells:
        c = json.loads(path.read_text())
        name = f"{c['arch']}/{c['shape']}/{c['mesh']}"
        if c["status"] == "skip":
            n_skip += 1
            continue
        if c["status"] == "fail":
            n_fail += 1
            rows.append(row(f"roofline.{name}", "FAIL",
                            c.get("error", "")[:120]))
            continue
        n_ok += 1
        r = c["roofline"]
        frac = c.get("useful_flops_frac")
        rows.append(row(
            f"roofline.{name}",
            f"{r['step_s_lower_bound']:.4f}s",
            f"dom={r['dominant']};c={r['compute_s']:.3f};"
            f"m={r['memory_s']:.3f};coll={r['collective_s']:.3f};"
            f"peak_gb={c['mem']['peak_gb']:.1f};"
            + (f"useful={frac:.2f}" if frac else "useful=-"),
        ))
    rows.insert(0, row("roofline.cells", f"{n_ok}ok/{n_fail}fail/{n_skip}skip",
                       f"of {len(cells)} attempted"))
    return rows
