"""Discovery by name, the result line and the guards every run keeps.

The manifest is ``BENCHMARK.json`` at the root of the checkout.  A
workload names a configuration and a traffic mix; each is a file of its
own, found by its name:

* ``configs/<config>.json``   the sizes as run, the source, ``reduced``
* ``traffic/<traffic>.json``  the mix's parameters and the ``driver``
* ``checks/<workload>.json``  the limit of each number ``correct`` compares
* ``reference/<config>.py``   the plain reference
* ``metrics/<metric>.py``     a reader: ``read(ctx) -> float | None``
* ``drivers/<driver>.py``     a general driver: ``Cell(config, traffic,
                              seed, device, limits)``

A later cell, configuration or metric is new files and new manifest
entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level modules a run must not hold once its window has closed:
#: JAX and the JAX package's tree (compared whole: ``repro_torch`` is
#: the port and passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks",
             "benchmarks_torch", "chip_smoke")


#: threads of the host's numeric libraries: one process, one thread, so
#: that a run's host work does not contend with itself
HOST_THREADS = 1


def setup_env() -> None:
    """Before torch or numpy is imported: every build and kernel cache at
    a fixed path inside the checkout (the port's own nvcc builds go to
    ``build/`` there already), one thread for the host's numeric
    libraries, and no JAX behind any library."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in man['workloads']]}")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_config(man: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(man, name)["file"])


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "traffic" / f"{name}.json")


def load_limits(workload_name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "checks" / f"{workload_name}.json")


def _module_from(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_reference(config_name: str, bench: Path = BENCH):
    return _module_from(bench / "reference" / f"{config_name}.py",
                        f"portbench_reference_{config_name}")


def load_metric(name: str, bench: Path = BENCH):
    return _module_from(bench / "metrics" / f"{name}.py",
                        "portbench_metric_" + name.replace(".", "_"))


def cell_metrics(man: dict, workload_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it, or list no cells (a per-layer metric without a
    ``workloads`` key is reported where its end-to-end metric is)."""
    out = []
    cell_e2e = {m["name"] for m in cell_metrics(man, workload_name,
                                                "end_to_end")} \
        if kind == "per_layer" else set()
    for m in man[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if workload_name in cells:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in cell_e2e:
            out.append(m)
    return out


def read_metrics(metrics: list[dict], ctx: dict, bench: Path = BENCH
                 ) -> dict:
    """Each metric's reader on ``ctx``; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_metric(m["name"], bench).read(ctx)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def checks_pass(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The run's last line of standard output; the compared numbers come
    last, each beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
