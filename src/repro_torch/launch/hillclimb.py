"""Perf hillclimb: re-run one dry-run cell under named variants and
print the roofline deltas.

The port of the reference's ``repro/launch/hillclimb.py``:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch qwen3-0.6b --shape train_4k --mesh 16x16 --device cpu \\
      --variant dp_only:profile=dp_only \\
      --variant dots:remat=dots

Variant keys: ``profile``, ``remat``, ``compression`` (and the decode
cell's ``kv_replication``).  Each variant's full cell JSON lands in
results/hillclimb_torch/.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch import dryrun
from repro_torch.utils.logging import get_logger

log = get_logger("hillclimb")


def parse_variant(s: str):
    name, _, kvs = s.partition(":")
    kw = {}
    for kv in filter(None, kvs.split(",")):
        k, v = kv.split("=")
        kw[k] = int(v) if v.isdigit() else v
    return name, kw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["16x16", "2x16x16"], default="16x16")
    ap.add_argument("--variant", action="append", default=[],
                    help="name:key=val,key=val  (keys: profile, remat, "
                         "compression)")
    ap.add_argument("--baseline", action="store_true",
                    help="also re-run the baseline with current code")
    ap.add_argument("--out", default="results/hillclimb_torch")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default cuda)")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    multi = args.mesh == "2x16x16"
    variants = [("baseline", {})] if args.baseline else []
    variants += [parse_variant(v) for v in args.variant]

    rows = []
    for name, kw in variants:
        profile = kw.pop("profile", "megatron")
        cell = dryrun.run_cell(args.arch, args.shape, multi,
                               profile=profile, device=args.device, **kw)
        tag = f"{args.arch}__{args.shape}__{args.mesh}__{name}"
        (outdir / f"{tag}.json").write_text(
            json.dumps(cell, indent=2, default=str))
        if cell["status"] == "ok":
            r = cell["roofline"]
            rows.append((name, r["compute_s"], r["memory_s"],
                         r["collective_s"], r["dominant"],
                         cell["mem"]["peak_gb"]))
            log.info("%s: c=%.3f m=%.3f coll=%.3f dom=%s peak=%.1fGB",
                     name, r["compute_s"], r["memory_s"], r["collective_s"],
                     r["dominant"], cell["mem"]["peak_gb"])
        else:
            log.error("%s FAILED: %s", name, cell.get("error"))
            rows.append((name, None, None, None, "FAIL", None))

    print("\nvariant,compute_s,memory_s,collective_s,dominant,peak_gb")
    for row in rows:
        print(",".join(str(x) for x in row))


if __name__ == "__main__":
    main()
