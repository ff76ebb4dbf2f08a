"""Render results/dryrun_torch/*.json into the roofline markdown table,
plus the streaming-runtime table from a stream bench JSON.

The port of the reference's ``repro/launch/report.py``: the same lines
for the same dicts.  The stream bench's port (ROADMAP A.10) will write
``BENCH_stream_torch.json``; ``stream_lines`` reads any bench JSON of the
reference's layout, named on the command line.

  PYTHONPATH=src python -m repro_torch.launch.report \
      [results/dryrun_torch] [BENCH_stream_torch.json]
"""
from __future__ import annotations

import json
import pathlib
import sys


def fmt_s(x: float) -> str:
    return f"{x*1e3:.1f}ms" if x < 1 else f"{x:.2f}s"


def roofline_lines(cells: list[dict]) -> list[str]:
    out = [
        "| arch | shape | mesh | peak GB/dev | compute | memory | "
        "collective | dominant | useful | status |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    n_ok = n_fail = n_skip = 0
    for c in cells:
        if c["status"] == "skip":
            n_skip += 1
            out.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — "
                f"| — | — | — | skip (full-attn @500k) |"
            )
            continue
        if c["status"] == "fail":
            n_fail += 1
            out.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — "
                f"| — | — | — | FAIL: {c.get('error','')[:60]} |"
            )
            continue
        n_ok += 1
        r, m = c["roofline"], c["mem"]
        uf = c.get("useful_flops_frac")
        if c.get("cost_note"):
            out.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} "
                f"| {m['peak_gb']:.1f} | — | — | — | — | — "
                f"| ok (compile+memory proof; cost pass skipped) |"
            )
            continue
        # a measured 0.0 is a legitimate value, not a missing one — only
        # an absent field renders as "—"
        uf_cell = f"{uf:.2f}" if uf is not None else "—"
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {m['peak_gb']:.1f} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {uf_cell} | ok |"
        )
    out.append(
        f"\n{n_ok} ok / {n_fail} fail / {n_skip} skip "
        f"of {len(cells)} recorded cells"
    )
    return out


def _num(row: dict, key: str, fmt: str) -> str:
    v = row.get(key)
    # v == v filters NaN (an empty latency window reports NaN rather
    # than a fabricated 0.0) — both it and a missing field render as "—"
    return format(v, fmt) if isinstance(v, (int, float)) and v == v else "—"


def stream_lines(bench: dict) -> list[str]:
    """§Streaming table: the BENCH_stream.json steady-state sweep and the
    mesh-sharded 1k-stream sweep, one row per configuration, with each
    hop's latency split into its host-pack and device halves."""
    out = [
        "",
        "## Streaming (BENCH_stream.json)",
        "",
        "| config | streams | shards | hop p50 ms | hop p99 ms | "
        "host-pack ms | device ms | stream-hops/s | uJ/inference |",
        "|---|---|---|---|---|---|---|---|---|",
    ]

    def row(label: str, streams, shards, r: dict) -> str:
        # _num is falsy- and NaN-safe: a measured 0.0 renders as a
        # number; a missing field (pre-arena artifacts) or a NaN (no
        # steps in the window) renders as "—"
        return (
            f"| {label} | {streams} | {shards} "
            f"| {_num(r, 'hop_ms_p50', '.3f')} "
            f"| {_num(r, 'hop_ms_p99', '.3f')} "
            f"| {_num(r, 'host_pack_ms_p50', '.3f')} "
            f"| {_num(r, 'device_ms_p50', '.3f')} "
            f"| {_num(r, 'stream_hops_per_sec', '.0f')} "
            f"| {_num(r, 'uj_per_inference', '.4f')} |"
        )

    for b, r in sorted(
        bench.get("sweep", {}).items(), key=lambda kv: int(kv[0])
    ):
        out.append(row("steady", b, 1, r))
    sharded = bench.get("sharded") or {}  # may be committed as null
    total = sharded.get("total_streams", "—")
    stale = sharded.get("carried_from_prior_run")
    label = "mesh-sharded (prior run)" if stale else "mesh-sharded"
    for s, r in sorted(
        sharded.get("configs", {}).items(), key=lambda kv: int(kv[0])
    ):
        out.append(row(label, total, s, r))
    ratio = sharded.get("multi_vs_single")
    if isinstance(ratio, (int, float)):
        out.append(
            f"\nbest multi-shard vs best single-device at "
            f"{total} streams: {ratio:.2f}x aggregate stream-hops/s"
            + (" (prior run)" if stale else "")
        )
    phases = bench.get("phases") or {}
    if phases:
        parts = [
            f"{p} {_num(d, 'ms_p50', '.3f')}/{_num(d, 'ms_p99', '.3f')} ms "
            f"({d.get('share_of_wall', 0.0) * 100:.0f}%)"
            for p, d in phases.items()
        ]
        out.append(
            "\nper-phase hop breakdown at B="
            f"{bench.get('n_streams', '—')} (p50/p99, share of hop wall): "
            + ", ".join(parts)
        )
    tr = bench.get("trace") or {}
    if isinstance(tr.get("span_coverage"), (int, float)):
        out.append(
            f"\ntrace: {tr.get('events', 0)} spans -> {tr.get('artifact')} "
            f"({tr['span_coverage'] * 100:.1f}% of hop wall covered); "
            "open at ui.perfetto.dev"
        )
    ev = bench.get("event_log") or {}
    if ev.get("counts"):
        out.append(
            f"\nevent log -> {ev.get('artifact')}: "
            + ", ".join(f"{k}={v}" for k, v in sorted(ev["counts"].items()))
        )
    oo = bench.get("obs_overhead") or {}
    if isinstance(oo.get("overhead_frac"), (int, float)):
        out.append(
            f"\nobservability overhead: "
            f"{oo['instrument_ms_per_hop'] * 1e3:.1f} us/hop = "
            f"{oo['overhead_frac'] * 100:.2f}% of hop p50 "
            f"({'within' if oo.get('within_2pct') else 'OVER'} the 2% cap)"
        )
    hp = bench.get("host_pack") or {}
    if isinstance(hp.get("reduction"), (int, float)):
        out.append(
            f"\nhost-side hop packing at {hp.get('streams', 0):.0f} "
            f"streams: {hp['host_pack_ms_before']:.3f} ms (per-slot loop) "
            f"-> {hp['host_pack_ms_after']:.3f} ms (arena gather), "
            f"{hp['reduction']:.1f}x"
        )
    sk = bench.get("skewed_churn") or {}  # may be committed as null
    if isinstance(sk.get("floor_capacity"), (int, float)):
        reb, pin = sk["rebalance"], sk["no_rebalance"]
        out.append(
            f"\nskewed-churn shrink floor ({sk['shards']} shards, "
            f"{sk['active_after_churn']} of {sk['total_streams']} streams "
            f"left, all on one shard): capacity "
            f"{pin['steady_capacity']:.0f} pinned without rebalance -> "
            f"{reb['steady_capacity']:.0f} with it "
            f"({reb['rows_migrated']:.0f} rows migrated; balanced floor "
            f"{sk['floor_capacity']:.0f})"
            + (" (prior run)" if sk.get("carried_from_prior_run") else "")
        )
    mt = bench.get("multi_tenant") or {}  # absent in pre-pool artifacts
    per_k = mt.get("per_k") or {}
    if per_k:
        out += [
            "",
            f"multi-tenant weight pool at {mt.get('total_streams', '—')} "
            "total streams (fused pool vs K separate schedulers):",
            "",
            "| K | hop p50 ms | launches/emit hop | stream-hops/s | "
            "baseline hops/s | speedup |",
            "|---|---|---|---|---|---|",
        ]
        for k, r in sorted(per_k.items(), key=lambda kv: int(kv[0])):
            base = r.get("baseline") or {}
            out.append(
                f"| {k} | {_num(r, 'hop_ms_p50', '.3f')} "
                f"| {_num(r, 'dispatches_per_emit_hop', '.0f')} "
                f"| {_num(r, 'stream_hops_per_sec', '.0f')} "
                f"| {_num(base, 'stream_hops_per_sec', '.0f')} "
                f"| {_num(r, 'speedup_vs_separate', '.2f')}x |"
            )
        if isinstance(mt.get("speedup_at_k4"), (int, float)):
            out.append(
                f"\nK=4 fused vs separate: {mt['speedup_at_k4']:.2f}x "
                f"(floor 2x: {'PASS' if mt.get('k4_target_met') else 'FAIL'}"
                "; launches/hop K-independent: "
                f"{bool(mt.get('launches_k_independent'))})"
            )
    lm = bench.get("lm_elastic") or {}  # absent in pre-runtime artifacts
    lm_cfg = lm.get("configs") or {}
    if lm_cfg:
        out += [
            "",
            f"LM decode on the shared slot pool ({lm.get('arch', '—')}, "
            f"pool starts at {lm.get('min_slots', '—')} slots, "
            "grow/shrink churn per wave):",
            "",
            "| slot ceiling | tokens/s | grows | shrinks | peak cap | "
            "final cap |",
            "|---|---|---|---|---|---|",
        ]
        for s, r in sorted(lm_cfg.items(), key=lambda kv: int(kv[0])):
            out.append(
                f"| {s} | {_num(r, 'tokens_per_sec', '.1f')} "
                f"| {_num(r, 'resizes_grow', '.0f')} "
                f"| {_num(r, 'resizes_shrink', '.0f')} "
                f"| {_num(r, 'peak_capacity', '.0f')} "
                f"| {_num(r, 'final_capacity', '.0f')} |"
            )
    ov = bench.get("overlap") or {}
    if isinstance(ov.get("hidden_frac"), (int, float)):
        out.append(
            f"\nasync overlap at B={ov.get('batch', 0)} open-loop: "
            f"{ov['hidden_frac']*100:.1f}% of pack+detector time hidden "
            f"under device spans ({ov['hidden_ms']:.1f} ms; floor 90%: "
            f"{'PASS' if ov.get('hidden_target_met') else 'FAIL'}), "
            f"device-span utilization {ov['utilization']*100:.1f}%, "
            f"{ov['speedup_vs_sync']:.2f}x vs sync throughput"
        )
    return out


def main() -> None:
    d = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                     else "results/dryrun_torch")
    cells = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    for line in roofline_lines(cells):
        print(line)

    bench_path = pathlib.Path(
        sys.argv[2] if len(sys.argv) > 2 else "BENCH_stream_torch.json"
    )
    if bench_path.exists():
        for line in stream_lines(json.loads(bench_path.read_text())):
            print(line)


if __name__ == "__main__":
    main()
