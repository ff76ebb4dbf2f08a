"""Port parity, host side: the ``RingArena`` ingest plane, the batched
detector, the batched primer, the slot pool (resize, rebalance, slot-axis
inference) and the energy ledgers of ``repro_torch`` against the
reference's, on the same seeded inputs; plus the import guard that keeps
the port free of ``jax`` and of the reference package."""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port_cases as cases
from repro.models import kws as ref_kws
from repro.runtime import pool as ref_pool
from repro.runtime import remap as ref_remap
from repro.stream import detector as ref_det
from repro.stream import metrics as ref_metrics
from repro.stream import state as ref_state
from repro.kernels import ops as ref_ops
from repro_torch import obs as port_obs
from repro_torch.obs import Observability
from repro_torch.runtime import pool as port_pool
from repro_torch.runtime import remap as port_remap
from repro_torch.stream import detector as port_det
from repro_torch.stream import metrics as port_metrics
from repro_torch.stream import state as port_state

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _arena_state(a):
    return (a.data, a.rd, a.wr, a.samples_in, a.chunks_in, a.gain,
            a.total_samples_in, a.total_chunks_in, a.generation)


def _assert_arenas_equal(ref, port):
    for x, y in zip(_arena_state(ref), _arena_state(port)):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_ring_arena_pack_ready_remap_parity():
    rng = np.random.default_rng(3)
    hop, cap = 16, 64
    arenas = (ref_state.RingArena(6, cap), port_state.RingArena(6, cap))
    for a in arenas:
        a.set_gain(2, 0.5)
    for rnd in range(12):
        slots = np.sort(rng.choice(6, size=int(rng.integers(1, 6)),
                                   replace=False))
        chunks = [
            (rng.standard_normal(int(rng.integers(1, 20))) * 0.6
             if rng.random() < 0.5 else
             rng.integers(0, 256, int(rng.integers(1, 20)), dtype=np.uint8))
            for _ in slots
        ]
        free = cap - arenas[1].fill()[slots]
        chunks = [c[:f] for c, f in zip(chunks, free)]
        for a in arenas:
            a.push_batch(slots, chunks)
        masks = [a.ready_mask(hop) for a in arenas]
        np.testing.assert_array_equal(masks[1], masks[0])
        ready = np.nonzero(masks[0])[0]
        packed = [a.pack_hops(ready, hop) for a in arenas]
        np.testing.assert_array_equal(packed[1], packed[0])
        if rnd == 4:
            ready = np.nonzero(arenas[0].ready_mask(3))[0]
            outs = [a.pop_batch(ready, 3) for a in arenas]
            np.testing.assert_array_equal(outs[1], outs[0])
            for a in arenas:
                a.rebase_batch(ready)
        if rnd == 7:
            remap = {0: 3, 2: 0, 5: 1}
            for a in arenas:
                a.apply_remap(remap, 6)
        if rnd == 9:
            for a in arenas:
                a.clear_slot(1)
        _assert_arenas_equal(*arenas)
    np.testing.assert_array_equal(
        port_state.quantize_pcm(np.linspace(-2, 2, 41), 0.7),
        ref_state.quantize_pcm(np.linspace(-2, 2, 41), 0.7))


BLOCK_HOP, BLOCK_CAP = 16, 64


def _block_rows(rng, case, n):
    """``n`` chunks of ``BLOCK_HOP`` samples of one case's kind."""
    def u8():
        return rng.integers(0, 256, BLOCK_HOP, dtype=np.uint8)

    def pcm(i):
        x = rng.standard_normal(BLOCK_HOP) * 0.8
        return x.astype(np.float32) if i % 2 else x

    if case in ("u8", "single"):
        return [u8() for _ in range(n)]
    if case == "float":
        return [pcm(i) for i in range(n)]
    if case == "int16":
        return [u8().astype(np.int16) for _ in range(n)]
    return [pcm(i) if i % 2 else u8() for i in range(n)]   # mixed


@pytest.mark.parametrize("case", ["u8", "float", "int16", "mixed",
                                  "single"])
def test_ring_arena_block_push_parity(case):
    """Equal-length pushes at hop-aligned offsets take the block path
    (the port counts every row) and leave the reference's state bit for
    bit, across the region's end and through aligned packs."""
    rng = np.random.default_rng(["u8", "float", "int16", "mixed",
                                 "single"].index(case))
    arenas = (ref_state.RingArena(6, BLOCK_CAP),
              port_state.RingArena(6, BLOCK_CAP))
    for a in arenas:
        for slot in range(6):
            a.set_gain(slot, 0.3 + 0.4 * slot)
    for rnd in range(18):
        if case == "single":
            slot = rnd % 2
            chunk = _block_rows(rng, case, 1)[0]
            arenas[0].push(slot, chunk)
            assert arenas[1].push(slot, chunk) == 1
        else:
            slots = np.sort(rng.choice(6, size=int(rng.integers(1, 7)),
                                       replace=False))
            chunks = _block_rows(rng, case, slots.size)
            arenas[0].push_batch(slots, chunks)
            assert arenas[1].push_batch(slots, chunks) == slots.size
        _assert_arenas_equal(*arenas)
        for _ in range(rnd % 3):   # inboxes hold 0-2 hops between packs
            ready = np.nonzero(arenas[0].ready_mask(BLOCK_HOP))[0]
            packed = [a.pack_hops(ready, BLOCK_HOP) for a in arenas]
            np.testing.assert_array_equal(packed[1], packed[0])
            _assert_arenas_equal(*arenas)
    assert arenas[1].wr.max() > BLOCK_CAP   # some slot wrapped the region


@pytest.mark.parametrize("case", ["unequal", "unaligned", "capacity"])
def test_ring_arena_push_falls_back_to_flat(case):
    """Unequal lengths, a write offset off the block grid, or a region
    the length does not divide: the flat path, no block rows, and the
    reference's state."""
    cap = BLOCK_CAP - 4 if case == "capacity" else BLOCK_CAP
    arenas = (ref_state.RingArena(4, cap), port_state.RingArena(4, cap))
    rng = np.random.default_rng(9)
    slots = np.arange(3)
    if case == "unaligned":
        head = [rng.integers(0, 256, 5, dtype=np.uint8)]
        arenas[0].push_batch(slots[1:2], head)
        assert arenas[1].push_batch(slots[1:2], head) == 0
    for _ in range(3):
        chunks = _block_rows(rng, "mixed", slots.size)
        if case == "unequal":
            chunks[1] = chunks[1][:BLOCK_HOP // 2]
        arenas[0].push_batch(slots, chunks)
        assert arenas[1].push_batch(slots, chunks) == 0
        _assert_arenas_equal(*arenas)
        ready = np.nonzero(arenas[0].ready_mask(BLOCK_HOP))[0]
        for a in arenas:
            a.pack_hops(ready, BLOCK_HOP)


@pytest.mark.parametrize("bad", ["range", "overflow", "dtype"])
def test_ring_arena_block_push_rejects_before_writing(bad):
    """A push that meets the block path's shape but carries codes out
    of u8 range, a non-integer dtype, or more than a slot's room raises
    the reference's error before any state changes (the generation
    included)."""
    arenas = (ref_state.RingArena(4, BLOCK_CAP),
              port_state.RingArena(4, BLOCK_CAP))
    rng = np.random.default_rng(11)
    slots = np.arange(3)
    fill = _block_rows(rng, "u8", 3)
    for a in arenas:
        a.push_batch(slots, fill)
        for _ in range(3):
            a.push(0, fill[0])     # slot 0 full
    chunks = _block_rows(rng, "int16", 3)
    want = ValueError
    if bad == "range":
        chunks[2][5] = 300
        slots = slots[1:]
        chunks = chunks[1:]
    elif bad == "dtype":
        chunks[2] = chunks[2].astype(bool)
        slots, chunks, want = slots[1:], chunks[1:], TypeError
    else:
        want = MemoryError
    before = [np.copy(x) for x in _arena_state(arenas[1])]
    errs = []
    for a in arenas:
        with pytest.raises(want) as err:
            a.push_batch(slots, chunks)
        errs.append(str(err.value))
    assert errs[1] == errs[0]
    for x, y in zip(before, _arena_state(arenas[1])):
        np.testing.assert_array_equal(y, x)
    _assert_arenas_equal(*arenas)


def test_batched_detector_parity():
    rng = np.random.default_rng(4)
    dets = (ref_det.BatchedDetector(5, 12), port_det.BatchedDetector(5, 12))
    frames = np.zeros(5, np.int64)
    for step in range(40):
        slots = np.sort(rng.choice(5, size=int(rng.integers(1, 6)),
                                   replace=False))
        frames[slots] += 1
        logits = rng.normal(0, 3, (slots.size, 12))
        logits[:, 4] += 4 * (step % 10 < 5)
        post = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out = [d.update_batch(slots, frames[slots], post) for d in dets]
        for x, y in zip(out[0], out[1]):
            np.testing.assert_array_equal(y, x)
        if step == 20:
            for d in dets:
                d.apply_remap({0: 1, 1: 0, 3: 3, 4: 2}, 5)
                d.reset_slot(3)


def test_prime_batch_parity():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = cases.exported(spec)
    ref_plan = ref_state.plan_stream(spec, hop_frames=2)
    port_plan = port_state.plan_stream(cases.port_spec(spec), hop_frames=2)
    samples = np.random.default_rng(6).integers(
        0, 256, (4, ref_plan.prime_samples), dtype=np.int32)
    ref = ref_state.prime_batch(ref_plan, weights, thresholds, samples)
    port = port_state.prime_batch(port_plan, weights, thresholds, samples)
    assert port["frames"] == ref["frames"]
    np.testing.assert_array_equal(port["gap"], ref["gap"])
    for key in ("tails", "pendings"):
        for a, b in zip(ref[key], port[key]):
            np.testing.assert_array_equal(b, a)


class _Client:
    """A minimal slot-pool workload: one (cap, 3) and one (2, cap) state
    leaf, and a log of the host remaps."""

    def __init__(self, zeros, cap):
        self.state = (zeros((cap, 3)), (zeros((2, cap)),))
        self.remaps = []

    def device_state(self):
        return self.state

    def set_device_state(self, state):
        self.state = state

    def slot_axes(self):
        return (0, (1,))

    def shard(self, x, axis=0):
        return x

    def apply_host_remap(self, remap, new_cap):
        self.remaps.append((dict(remap), new_cap))


def _fill_row(client, slot, value, torch_side):
    a, (b,) = client.state
    if torch_side:
        a = a.clone()
        b = b.clone()
        a[slot] = value
        b[:, slot] = value
    else:
        a = a.at[slot].set(value)
        b = b.at[:, slot].set(value)
    client.state = (a, (b,))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_slot_pool_resize_and_rebalance_parity(n_shards):
    zr = lambda s: jnp.zeros(s, jnp.int32)  # noqa: E731
    zp = lambda s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    cr, cp = _Client(zr, 2 * n_shards), _Client(zp, 2 * n_shards)
    kw = dict(initial_capacity=2 * n_shards, min_capacity=2 * n_shards,
              n_shards=n_shards)
    pr = ref_pool.SlotPool(cr, 16, **kw)
    pp = port_pool.SlotPool(cp, 16, **kw)

    def check():
        assert pp.capacity == pr.capacity
        assert pp.placement.slots == pr.placement.slots
        assert cp.remaps == cr.remaps
        for x, y in zip((cr.state[0], cr.state[1][0]),
                        (cp.state[0], cp.state[1][0])):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))

    slots = {}
    for sid in range(11):       # grows 2 -> 4 -> 8 -> 16 per pool
        slots[sid] = pr.alloc(sid)
        assert pp.alloc(sid) == slots[sid]
        _fill_row(cr, slots[sid], sid + 1, False)
        _fill_row(cp, slots[sid], sid + 1, True)
        check()
    for sid in (0, 2, 4, 6, 8, 9, 10):   # skewed leave churn
        for pool, client, t in ((pr, cr, False), (pp, cp, True)):
            slot = pool.placement.slots.index(sid)
            pool.free(slot)
            _fill_row(client, slot, 0, t)
        pr.maybe_shrink()
        pp.maybe_shrink()
        check()
    pr.hop_barrier()
    pp.hop_barrier()
    check()


def test_infer_slot_axes_on_meta_tensors():
    ref = ref_pool.infer_slot_axes(
        lambda b: (jnp.zeros((b, 3)), [jnp.zeros((4, b)), jnp.zeros(5)]))
    port = port_pool.infer_slot_axes(
        lambda b: (torch.zeros(b, 3), [torch.zeros(4, b), torch.zeros(5)]))
    assert port == (0, [1, -1])
    assert ref == (0, [1, -1])
    assert torch.zeros(1).device.type == "cpu"  # the meta default is gone


def test_remap_device_rows_matches_reference():
    x = np.arange(6 * 2 * 3, dtype=np.int32).reshape(6, 2, 3)
    perm, keep = port_remap.perm_keep({0: 3, 4: 0, 5: 1}, 6)
    ref_p, ref_k = ref_remap.perm_keep({0: 3, 4: 0, 5: 1}, 6)
    np.testing.assert_array_equal(perm, ref_p)
    np.testing.assert_array_equal(keep, ref_k)
    want = np.asarray(ref_ops.remap_slot_rows(jnp.asarray(x), perm, keep))
    got = port_remap.remap_device_rows(torch.as_tensor(x), perm, keep)
    np.testing.assert_array_equal(got.numpy(), want)
    got1 = port_remap.remap_device_rows(
        torch.as_tensor(x).movedim(0, 1).contiguous(), perm, keep, axis=1)
    np.testing.assert_array_equal(got1.movedim(1, 0).numpy(), want)


@pytest.mark.parametrize("hf", [1, 8])
def test_energy_ledgers_match(hf):
    spec = ref_kws.build_kws_spec()
    ref_plan = ref_state.plan_stream(spec, hop_frames=hf)
    port_plan = port_state.plan_stream(cases.port_spec(spec), hop_frames=hf)
    for fn in ("plan_hop_ledger", "plan_tail_ledger"):
        ref = getattr(ref_metrics, fn)(ref_plan)
        port = getattr(port_metrics, fn)(port_plan)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), fn


def test_tracer_profiler_bridge_records_spans(tmp_path):
    """Under a running profile every context-managed span (the tracer's
    and ``obs.span``'s) is also a ``user_annotation`` range of its name,
    nested as in the ring; outside one only the ring records."""
    obs = Observability.create(mirror_events=False)
    with obs.trace.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace.span("push", n=3):
            with port_obs.span("layer.moe"):
                torch.zeros(4).add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"push", "layer.moe"} <= set(ranges)
    assert "outside" not in ranges
    outer, inner = ranges["push"], ranges["layer.moe"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert [s["name"] for s in obs.trace.spans()] == [
        "outside", "layer.moe", "push"]


# ---------------------------------------------------------------------------
# Import guard: the port never imports jax or the reference package
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    benches = sorted((ROOT / "benchmarks_torch").glob("*.py"))
    return files + examples + benches + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    assert path.is_file(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.stream, repro_torch.kernels.ops, "
            "repro_torch.serve.engine, repro_torch.launch.train, "
            "repro_torch.data.lm_data, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb, repro_torch.launch.report, "
            "benchmarks_torch.run, benchmarks_torch.kernel_bench, "
            "benchmarks_torch.roofline_table; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
