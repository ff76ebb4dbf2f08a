"""The port's chip twin (``repro_torch.core``: isa, pwb, macro, pingpong,
twm, compiler, executor) against the reference's ``repro.core`` on the
same seeded inputs and the reference's exported models.

Tolerance: equality everywhere (instruction words, placement, the macro's
cell planes and the weight SRAM's pages, the whole ``ExecutionReport``,
error types and messages), except the Monte Carlo flip rates of
``twm.flip_rate_under_noise``: the port cannot reproduce ``jax.random``,
so there each package's rate is a mean of ``n`` independent Bernoulli
draws (variance <= 1 / (4 n)), and the two must agree within five
standard deviations of their difference, ``5 * sqrt(1 / (2 n))``.

The port runs on CPU tensors here (``device="cpu"``): its executor's MAC
chunks go through ``kernels/ops.py``, which runs each kernel's plain
version on the CPU and counts the launch as the card would.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_cases import RANDOM_SEEDS, exported, port_spec, random_spec
from repro.core import cnn_spec as ref_cs
from repro.core import compiler as ref_compiler
from repro.core import energy as ref_energy
from repro.core import executor as ref_executor
from repro.core import isa as ref_isa
from repro.core import macro as ref_macro
from repro.core import pingpong as ref_pingpong
from repro.core import pwb as ref_pwb
from repro.core import twm as ref_twm
from repro.models import kws as ref_kws
from repro_torch import core as port_core
from repro_torch.core import compiler, energy, executor, isa, macro
from repro_torch.core import pingpong, pwb, twm
from repro_torch.kernels import conv_kernels as bk
from repro_torch.kernels import dispatch
from repro_torch.kernels import twm_matmul as tm
from repro_torch.models import kws

CPU = torch.device("cpu")
FULL = dict(rotate_hints=ref_kws.ROTATE_HINTS,
            rowsplit_hints=ref_kws.ROWSPLIT_HINTS)
SPECS = {"smoke": (ref_kws.build_kws_smoke_spec, {}),
         "full": (ref_kws.build_kws_spec, FULL)}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compile_both(spec, weights, thresholds, **hints):
    ref = ref_compiler.compile_model(spec, weights, thresholds, **hints)
    port = compiler.compile_model(port_spec(spec), weights, thresholds,
                                  device="cpu", **hints)
    return ref, port


def _audio(spec, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << spec.in_bits, (spec.in_len, spec.in_channels)).astype(
        np.uint8)


def _ledger(led):
    return {f.name: getattr(led, f.name) for f in dataclasses.fields(led)
            if f.name != "params"}


def same_report(got, want):
    """The whole ExecutionReport equal: output, fmaps, layer_cycles,
    bank_active_cycles and every ledger field (params too)."""
    assert got.output.dtype == torch.int64
    np.testing.assert_array_equal(_np(got.output), want.output)
    assert sorted(got.fmaps) == sorted(want.fmaps)
    for li, fm in want.fmaps.items():
        assert got.fmaps[li].dtype == torch.int64
        np.testing.assert_array_equal(_np(got.fmaps[li]), fm)
    assert got.layer_cycles == want.layer_cycles
    np.testing.assert_array_equal(got.bank_active_cycles,
                                  want.bank_active_cycles)
    assert got.bank_active_cycles.dtype == want.bank_active_cycles.dtype
    assert _ledger(got.ledger) == _ledger(want.ledger)
    assert dataclasses.asdict(got.ledger.params) == dataclasses.asdict(
        want.ledger.params)
    assert got.ledger.summary() == want.ledger.summary()


def same_images(port, ref):
    """Macro cell planes, pages and the weight SRAM equal."""
    np.testing.assert_array_equal(_np(port.cim.pos), ref.cim.pos)
    np.testing.assert_array_equal(_np(port.cim.neg), ref.cim.neg)
    np.testing.assert_array_equal(port.cim._owner, ref.cim._owner)
    assert sorted(port.cim.pages) == sorted(ref.cim.pages)
    for pid, page in ref.cim.pages.items():
        assert dataclasses.asdict(port.cim.pages[pid]) == \
            dataclasses.asdict(page)
        got = port.cim.read_page(pid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), ref.cim.read_page(pid))
    assert sorted(port.wsram.pages) == sorted(ref.wsram.pages)
    for wp, w in ref.wsram.pages.items():
        assert port.wsram.load(wp).dtype == torch.int8
        np.testing.assert_array_equal(_np(port.wsram.load(wp)), w)
    assert port.cim.used_cells == ref.cim.used_cells
    assert port.wsram.used_bits == ref.wsram.used_bits


# ---------------------------------------------------------------------------
# ISA
# ---------------------------------------------------------------------------

def _random_instrs(rng, n):
    """Random valid instructions of every type (the reference's types)."""
    out = []
    for _ in range(n):
        op = int(rng.integers(0, 4))
        if op == 0:
            out.append(dict(
                kind="MacInstr", fuse=bool(rng.integers(0, 2)),
                ltype=int(rng.integers(0, 2)), k=int(rng.integers(0, 32)),
                stride=int(rng.choice([1, 2, 4, 8])),
                cin=int(rng.integers(1, 1025)), cout=int(rng.integers(1, 513)),
                bitser=int(rng.choice([1, 2, 4, 8])),
                wpage=int(rng.integers(0, 16)),
                pool=int(rng.choice([1, 2, 4, 8])),
                outmode=int(rng.integers(0, 2))))
        elif op == 1:
            out.append(dict(kind="WrepInstr",
                            row_start=int(rng.integers(0, 1024)),
                            n_rows=int(rng.integers(0, 1024)),
                            wsram_page=int(rng.integers(0, 512))))
        elif op == 2:
            out.append(dict(kind="PtrInstr",
                            ifm_addr=int(rng.integers(0, isa.MAX_ADDR)),
                            ofm_addr=int(rng.integers(0, isa.MAX_ADDR))))
        else:
            out.append(dict(kind="HaltInstr"))
    return out


def _make(mod, fields):
    fields = dict(fields)
    return getattr(mod, fields.pop("kind"))(**fields)


@pytest.mark.parametrize("seed", range(4))
def test_isa_random_instructions_encode_decode_equal(seed):
    descs = _random_instrs(np.random.default_rng(seed), 200)
    ref = [_make(ref_isa, d) for d in descs]
    port = [_make(isa, d) for d in descs]
    words = isa.encode_program(port)
    assert words == ref_isa.encode_program(ref)
    for w in words:
        assert isa.opcode(w) == ref_isa.opcode(w)
        got, want = isa.decode(w), ref_isa.decode(w)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isa.disassemble(words) == ref_isa.disassemble(words)
    assert [dataclasses.asdict(i) for i in isa.decode_program(words)] == [
        dataclasses.asdict(i) for i in ref_isa.decode_program(words)]
    for name in ("BANK_BITS", "N_BANKS", "WORD", "BANK_WORDS", "ADDR_BITS",
                 "MAX_ADDR", "OP_MAC", "OP_WREP", "OP_PTR", "OP_HALT"):
        assert getattr(isa, name) == getattr(ref_isa, name)


BAD_INSTRS = [
    dict(kind="MacInstr", k=32), dict(kind="MacInstr", stride=3),
    dict(kind="MacInstr", stride=16), dict(kind="MacInstr", cin=1040),
    dict(kind="MacInstr", cout=513), dict(kind="MacInstr", bitser=16),
    dict(kind="MacInstr", wpage=16), dict(kind="MacInstr", pool=16),
    dict(kind="MacInstr", ltype=2), dict(kind="MacInstr", outmode=2),
    dict(kind="MacInstr", k=-1), dict(kind="WrepInstr", row_start=1024,
                                      n_rows=1, wsram_page=0),
    dict(kind="WrepInstr", row_start=0, n_rows=1024, wsram_page=0),
    dict(kind="WrepInstr", row_start=0, n_rows=1, wsram_page=512),
    dict(kind="PtrInstr", ifm_addr=isa.MAX_ADDR, ofm_addr=0),
    dict(kind="PtrInstr", ifm_addr=0, ofm_addr=-1),
]


@pytest.mark.parametrize("desc", BAD_INSTRS, ids=str)
def test_isa_field_overflow_errors_agree(desc):
    with pytest.raises(ValueError) as want:
        _make(ref_isa, desc).encode()
    with pytest.raises(ValueError) as got:
        _make(isa, desc).encode()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("op", [4, 5, 6, 7])
def test_isa_unknown_opcode_errors_agree(op):
    with pytest.raises(ValueError) as want:
        ref_isa.decode(op << 29)
    with pytest.raises(ValueError) as got:
        isa.decode(op << 29)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------

CHUNK_FIELDS = ("name", "layer_idx", "exec_idx", "rows", "pairs", "ch0",
                "ch1", "row0_w", "rotating", "page_id", "placed",
                "wsram_page")


def same_program(port, ref):
    assert port.words == ref.words
    assert port.disassemble() == ref.disassemble()
    assert port.rotation_region == ref.rotation_region
    assert port.in_addr == ref.in_addr
    assert [k for k, _ in port.instr_meta] == [k for k, _ in ref.instr_meta]
    assert len(port.bindings) == len(ref.bindings)
    for pb, rb in zip(port.bindings, ref.bindings):
        assert (pb.layer_idx, pb.ifm_addr, pb.ofm_addr) == (
            rb.layer_idx, rb.ifm_addr, rb.ofm_addr)
        assert dataclasses.asdict(pb.spec) == dataclasses.asdict(rb.spec)
        assert [[getattr(c, f) for f in CHUNK_FIELDS] for c in pb.chunks] \
            == [[getattr(c, f) for f in CHUNK_FIELDS] for c in rb.chunks]
    for li, (thr, flip) in ref.thresholds.items():
        pt, pf = port.thresholds[li]
        assert pt.dtype == torch.float64 and pf.dtype == torch.bool
        np.testing.assert_array_equal(_np(pt), thr)
        np.testing.assert_array_equal(_np(pf), flip)
    same_images(port, ref)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_compiler_matches_reference(name):
    build, hints = SPECS[name]
    spec = build()
    ref, port = _compile_both(spec, *exported(spec), **hints)
    same_program(port, ref)
    assert port.device == CPU
    if name == "full":
        # 26 words: 13 MAC chunks, 4 of them rotating behind a WREP
        assert len(port.words) == 26
        macs = [p for k, p in port.instr_meta if k == "mac"]
        assert [c.name for _, c in macs] == [
            "l0.c0", "b1.c0", "b2.c0", "b2.c1", "b3.c0", "b3.c1", "b3.c2",
            "fc1.c0", "fc1.c1", "fc1.c2", "fc1.c3", "fc2.r0c0", "fc2.r1c0"]
        assert [c.name for _, c in macs if c.rotating] == list(
            ref_kws.ROTATE_HINTS)
        assert port.wsram.used_bits == macro.WEIGHT_SRAM_BITS


def test_compiler_takes_tensors_and_flat_conv_weights():
    """Weights as tensors, a conv's as (K * Cin, Cout): the same program."""
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec)
    ref = ref_compiler.compile_model(spec, weights, thresholds)
    flat = {li: torch.as_tensor(w.reshape(-1, w.shape[-1]))
            for li, w in weights.items()}
    tthr = {li: (torch.as_tensor(t), torch.as_tensor(f))
            for li, (t, f) in thresholds.items()}
    port = compiler.compile_model(port_spec(spec), flat, tthr, device="cpu")
    same_program(port, ref)


def test_compiler_errors_agree():
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec)
    # row-split needs a raw-output layer
    for mod, sp in ((ref_compiler, spec), (compiler, port_spec(spec))):
        kw = dict(device="cpu") if mod is compiler else {}
        with pytest.raises(ValueError, match="row-split needs raw output"):
            mod.compile_model(sp, weights, thresholds,
                              rowsplit_hints={"b1": 2}, **kw)
    # every chunk of the full model rotating overflows the weight SRAM
    full = ref_kws.build_kws_spec()
    fw, ft = exported(full)
    names = tuple(c.name for li, lay in enumerate(full.layers)
                  for c in ref_compiler.chunk_layer(lay, li, 0))
    with pytest.raises(MemoryError) as want:
        ref_compiler.compile_model(full, fw, ft, rotate_hints=names)
    with pytest.raises(MemoryError) as got:
        compiler.compile_model(port_spec(full), fw, ft, rotate_hints=names,
                               device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rowsplit", [1, 2, 3])
def test_chunk_layer_matches_reference(rowsplit):
    spec = ref_kws.build_kws_spec()
    for li, lay in enumerate(spec.layers):
        got = compiler.chunk_layer(port_spec(spec).layers[li], li, 5,
                                   rowsplit)
        want = ref_compiler.chunk_layer(lay, li, 5, rowsplit)
        assert [dataclasses.asdict(c) for c in got] == [
            dataclasses.asdict(c) for c in want]


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_kws():
    """The full-width KWS model compiled in both packages, its input and
    the reference's fused report (compiled and run once per module)."""
    spec = ref_kws.build_kws_spec()
    weights, thresholds = exported(spec)
    ref, port = _compile_both(spec, weights, thresholds, **FULL)
    x = _audio(spec, 0)
    return spec, ref, port, x, ref_executor.Executor(ref).run(x)


def test_executor_full_width_matches_reference(full_kws):
    spec, ref, port, x, want = full_kws
    with dispatch.counting() as launched:
        got = executor.Executor(port).run(x)
    same_report(got, want)
    assert tuple(got.output.shape) == (1, 12)
    # one launch per MAC chunk: l0 on B.3, b1-b3's six chunks on B.6
    # raw, fc1's four bit-plane chunks and fc2's two row slices on B.7
    assert launched() == {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 6,
                          tm.POPCOUNT_KERNEL: 6}
    # the simulated chip's Table I figures follow from the ledger
    assert got.ledger.macs == spec.total_macs
    same_images(port, ref)   # after the rotating chunks' WREPs


def test_executor_full_width_unfused_matches_reference(full_kws):
    _, ref, port, x, fused = full_kws
    want = ref_executor.Executor(ref, fuse_pool=False).run(x)
    got = executor.Executor(port, fuse_pool=False).run(x)
    same_report(got, want)
    np.testing.assert_array_equal(_np(got.output), fused.output)
    assert got.ledger.cycles > fused.ledger.cycles


def test_executor_full_width_calibrated_matches_reference(full_kws):
    """``energy.calibrate_e_mac`` on the port's ledger gives the
    reference's parameters, and a run with them the same report."""
    _, ref, port, x, want = full_kws
    got = executor.Executor(port).run(x)
    target = want.ledger.macs / 885.86e12
    p_ref = ref_energy.calibrate_e_mac(want.ledger, target)
    p_port = energy.calibrate_e_mac(got.ledger, target)
    assert dataclasses.asdict(p_port) == dataclasses.asdict(p_ref)
    same_report(executor.Executor(port, params=p_port).run(x),
                ref_executor.Executor(ref, params=p_ref).run(x))


@pytest.mark.parametrize("fuse_pool", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_executor_smoke_matches_reference(seed, fuse_pool):
    spec = ref_kws.build_kws_smoke_spec()
    ref, port = _compile_both(spec, *exported(spec))
    x = _audio(spec, seed)
    same_report(executor.Executor(port, fuse_pool=fuse_pool).run(x),
                ref_executor.Executor(ref, fuse_pool=fuse_pool).run(x))


@pytest.mark.parametrize("fuse_pool", [True, False])
def test_executor_forced_rotation_matches_reference(fuse_pool):
    """Every chunk of the smoke model rotating: a WREP before every MAC,
    all through the one rotation region."""
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec, 1)
    names = tuple(c.name for li, lay in enumerate(spec.layers)
                  for c in ref_compiler.chunk_layer(lay, li, 0))
    ref, port = _compile_both(spec, weights, thresholds, rotate_hints=names)
    same_program(port, ref)
    assert sum(isa.opcode(w) == isa.OP_WREP for w in port.words) == len(
        names)
    base = ref_compiler.compile_model(spec, weights, thresholds)
    x = _audio(spec, 2)
    got = executor.Executor(port, fuse_pool=fuse_pool).run(x)
    same_report(got, ref_executor.Executor(ref, fuse_pool=fuse_pool).run(x))
    np.testing.assert_array_equal(
        _np(got.output),
        ref_executor.Executor(base, fuse_pool=fuse_pool).run(x).output)
    same_images(port, ref)


def test_executor_twice_on_one_program():
    """The executor mutates its program (a rotating chunk's WREP claims the
    rotation region with eviction): a second run gives the same report in
    both packages, and leaves the same macro image."""
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec)
    ref, port = _compile_both(spec, weights, thresholds,
                              rotate_hints=("b2.c0", "b3.c0", "fc1.c0"))
    x = _audio(spec, 5)
    for _ in range(2):
        got = executor.Executor(port).run(x)
        want = ref_executor.Executor(ref).run(x)
        same_report(got, want)
        same_images(port, ref)


def _pool_spec_model():
    """A spec no KWS builder makes, with seeded numpy weights: a binary
    multi-channel input (the input written as bits), a standalone pool
    layer (the PWB bypass, ``ltype=1``), a binary conv of 160 channels
    (two column chunks), a bit-serial fc and a binary raw fc."""
    spec = ref_cs.CNN1DSpec(
        in_len=300, in_channels=4, in_bits=1, name="pooled",
        layers=(ref_cs.Conv1DSpec(4, 24, k=5, stride=2, pad=2, name="c0"),
                ref_cs.PoolSpec(24, pool=3, name="p0"),
                ref_cs.Conv1DSpec(24, 160, k=3, pad=1, pool=2, name="c1"),
                ref_cs.GAPSpec(160, name="gap"),
                ref_cs.FCSpec(160, 24, in_bits=8, in_offset=3, name="fc1"),
                ref_cs.FCSpec(24, 12, out_raw=True, name="fc2")))
    rng = np.random.default_rng(11)
    weights, thresholds = {}, {}
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, (ref_cs.PoolSpec, ref_cs.GAPSpec)):
            continue
        k = getattr(lay, "k", 1)
        w = rng.integers(-1, 2, (k, lay.cin, lay.cout) if k > 1
                         else (lay.cin, lay.cout)).astype(np.int8)
        scale = 40.0 if lay.in_bits > 1 else 2.0
        weights[li] = w
        thresholds[li] = (rng.normal(0, scale, lay.cout).round(1),
                          rng.random(lay.cout) < 0.3)
    return spec, weights, thresholds


@pytest.mark.parametrize("fuse_pool", [True, False])
def test_executor_pool_layer_and_binary_input_match_reference(fuse_pool):
    spec, weights, thresholds = _pool_spec_model()
    ref, port = _compile_both(spec, weights, thresholds)
    same_program(port, ref)
    assert sum(k == "pool" for k, _ in port.instr_meta) == 1
    x = np.random.default_rng(12).integers(0, 2, (300, 4)).astype(np.uint8)
    with dispatch.counting() as launched:
        got = executor.Executor(port, fuse_pool=fuse_pool).run(x)
    assert launched() == {bk.CONV_KERNEL: 3, tm.POPCOUNT_KERNEL: 2}
    same_report(got, ref_executor.Executor(ref, fuse_pool=fuse_pool).run(x))


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_executor_random_specs_match_reference(seed):
    case = random_spec(seed)
    assert case is not None
    spec, _ = case
    weights, thresholds = exported(spec)
    ref, port = _compile_both(spec, weights, thresholds)
    same_program(port, ref)
    for s in (0, 1):
        x = _audio(spec, 10 + s)
        for fuse_pool in (True, False):
            same_report(
                executor.Executor(port, fuse_pool=fuse_pool).run(x),
                ref_executor.Executor(ref, fuse_pool=fuse_pool).run(x))


def test_executor_computes_from_the_cells():
    """Overwrite one fixed page's cells after compiling: the port's wrong
    answer equals the reference's wrong answer."""
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec)
    ref, port = _compile_both(spec, weights, thresholds)
    x = _audio(spec, 3)
    clean = ref_executor.Executor(ref).run(x)
    chunk = next(c for b in ref.bindings for c in b.chunks
                 if c.name == "b2.c0")
    page = ref.cim.pages[chunk.page_id]
    junk = np.random.default_rng(7).integers(
        -1, 2, (page.rows, page.pairs)).astype(np.int8)
    ref.cim.write_page(chunk.page_id, junk)
    port.cim.write_page(chunk.page_id, torch.as_tensor(junk))
    same_images(port, ref)
    want = ref_executor.Executor(ref).run(x)
    same_report(executor.Executor(port).run(x), want)
    li = chunk.layer_idx
    assert not np.array_equal(want.fmaps[li], clean.fmaps[li])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_executor_logits_match_offline_logits(name):
    """The executor's raw logits equal the kernel library's utterance
    (``models.kws.offline_logits``) on the same exported model."""
    build, hints = SPECS[name]
    spec = build()
    weights, thresholds = exported(spec)
    pspec = port_spec(spec)
    port = compiler.compile_model(pspec, weights, thresholds, device="cpu",
                                  **hints)
    x = _audio(spec, 4)
    got = executor.Executor(port).run(x).output
    want = kws.offline_logits(pspec, weights, thresholds, x[:, 0],
                              device="cpu")
    np.testing.assert_array_equal(_np(got).ravel(), _np(want))


def test_core_exports():
    for name in ("quant", "twm", "macro", "isa", "cnn_spec", "pwb",
                 "pingpong", "energy", "compile_model", "CompiledProgram",
                 "Executor", "ExecutionReport"):
        assert name in port_core.__all__ and hasattr(port_core, name)
    assert port_core.compile_model is compiler.compile_model
    assert port_core.Executor is executor.Executor


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------

def test_device_rule_no_card_raises(monkeypatch):
    """With no card, nothing of the chip twin falls back to the CPU
    unasked; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ref_kws.build_kws_smoke_spec()
    weights, thresholds = exported(spec)
    pspec = port_spec(spec)
    for make in (lambda: compiler.compile_model(pspec, weights, thresholds),
                 macro.CIMMacro, macro.WeightSRAM, pingpong.PingPongSRAM,
                 lambda: twm.twm_mac(np.ones((2, 8), np.int32),
                                     np.ones((8, 3), np.int32))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    prog = compiler.compile_model(pspec, weights, thresholds, device="cpu")
    rep = executor.Executor(prog).run(_audio(spec, 0))
    assert rep.output.device == CPU and prog.device == CPU
    # a program that lies on the card cannot run without one
    prog.cim.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        executor.Executor(prog)


# ---------------------------------------------------------------------------
# PWB, macro and ping-pong units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", [2, 3, 4])
def test_pwb_matches_reference(pool):
    rng = np.random.default_rng(pool)
    y = rng.integers(0, 2, (301, 37)).astype(np.uint8)
    got = pwb.maxpool_bits(torch.as_tensor(y), pool)
    np.testing.assert_array_equal(_np(got), ref_pwb.maxpool_bits(y, pool))
    assert pwb.gap_counts(torch.as_tensor(y)).dtype == torch.uint8
    np.testing.assert_array_equal(_np(pwb.gap_counts(torch.as_tensor(y))),
                                  ref_pwb.gap_counts(y))
    for length, ch in ((301, 37), (2000, 64), (250, 352)):
        assert pwb.standalone_pool_cycles(length, ch, pool) == \
            ref_pwb.standalone_pool_cycles(length, ch, pool)
        assert pwb.gap_cycles(length, ch) == ref_pwb.gap_cycles(length, ch)
        for fused in (True, False):
            assert pwb.PoolPlanEntry(fused, pool, length, ch).extra_cycles \
                == ref_pwb.PoolPlanEntry(fused, pool, length,
                                         ch).extra_cycles
    assert pwb.POOL_UNIT_BITS == ref_pwb.POOL_UNIT_BITS


def test_pwb_gap_counts_saturate():
    y = np.ones((300, 5), np.uint8)
    y[:100, 0] = 0
    got = pwb.gap_counts(torch.as_tensor(y))
    np.testing.assert_array_equal(_np(got), ref_pwb.gap_counts(y))
    assert _np(got).tolist() == [200, 255, 255, 255, 255]


def test_pingpong_roundtrip_words_match_reference():
    """Bits and bytes written to the same addresses give the reference's
    words, a word with bit 31 set included, and read back."""
    rng = np.random.default_rng(3)
    port, ref = pingpong.PingPongSRAM("cpu"), ref_pingpong.PingPongSRAM()
    cases = [(pingpong.FmapRef(100, 33, 17, "bits"),
              rng.integers(0, 2, (33, 17)).astype(np.uint8)),
             (pingpong.FmapRef(400, 4, 32, "bits"),
              np.ones((4, 32), np.uint8)),
             (pingpong.FmapRef(3000, 10, 7, "u8"),
              rng.integers(0, 256, (10, 7)).astype(np.uint8)),
             (pingpong.FmapRef(5000, 3, 4, "u8"),
              np.full((3, 4), 255, np.uint8))]
    for r, vals in cases:
        rr = ref_pingpong.FmapRef(r.addr, r.length, r.channels, r.fmt)
        (port.write_bits if r.fmt == "bits" else port.write_u8)(r, vals)
        (ref.write_bits if r.fmt == "bits" else ref.write_u8)(rr, vals)
        back = (port.read_bits if r.fmt == "bits" else port.read_u8)(r)
        np.testing.assert_array_equal(_np(back), vals)
        (ref.read_bits if r.fmt == "bits" else ref.read_u8)(rr)
    words = port.mem.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, ref.mem)
    assert (words >> 31).any()   # bit 31 set in some words
    assert (port.reads_bits, port.writes_bits) == (ref.reads_bits,
                                                   ref.writes_bits)
    with pytest.raises(ValueError):
        port.write_bits(pingpong.FmapRef(0, 3, 3, "u8"),
                        np.zeros((3, 3), np.uint8))
    with pytest.raises(ValueError):
        port.write_bits(pingpong.FmapRef(0, 3, 3, "bits"),
                        np.zeros((3, 4), np.uint8))


LAYER_CASES = [
    ((0, 100, 32, "bits"), (4096, 100, 32, "bits")),      # banks 0 / 2
    ((0, 100, 32, "bits"), (50, 100, 32, "bits")),        # overlap
    ((0, 100, 32, "bits"), (200, 100, 32, "bits")),       # shared bank 0
    ((0, 5000, 32, "bits"), (6144, 2000, 32, "bits")),    # Fig. 5c
    ((8000, 100, 32, "u8"), (0, 10, 8, "bits")),          # out of range
    ((0, 16000, 1, "u8"), (8192 - 4000, 2000, 64, "bits")),   # KWS l0
]


@pytest.mark.parametrize("ifm,ofm", LAYER_CASES, ids=str)
def test_pingpong_bank_discipline_matches_reference(ifm, ofm):
    pi, po = pingpong.FmapRef(*ifm), pingpong.FmapRef(*ofm)
    ri, ro = ref_pingpong.FmapRef(*ifm), ref_pingpong.FmapRef(*ofm)
    assert (pi.banks, po.banks, pi.n_words) == (ri.banks, ro.banks,
                                                ri.n_words)
    try:
        ref_pingpong.PingPongSRAM.check_layer(ri, ro)
    except MemoryError as e:
        with pytest.raises(MemoryError) as got:
            pingpong.PingPongSRAM.check_layer(pi, po)
        assert str(got.value) == str(e)
    else:
        pingpong.PingPongSRAM.check_layer(pi, po)
        port, ref = pingpong.PingPongSRAM("cpu"), ref_pingpong.PingPongSRAM()
        port.account_layer(pi, po, 123)
        ref.account_layer(ri, ro, 123)
        np.testing.assert_array_equal(port.bank_active_cycles,
                                      ref.bank_active_cycles)
    assert pingpong.FixedPingPong().fits(pi, po) == \
        ref_pingpong.FixedPingPong().fits(ri, ro)


def test_macro_claims_and_errors_match_reference():
    port, ref = macro.CIMMacro("cpu"), ref_macro.CIMMacro()
    rng = np.random.default_rng(4)
    for mod, cim in ((macro, port), (ref_macro, ref)):
        cim.claim(mod.Page(0, 0, 0, 64, 32))
        cim.claim(mod.Page(1, 64, 0, 32, 128))
        with pytest.raises(ValueError, match="overlaps pages"):
            cim.claim(mod.Page(2, 32, 16, 64, 16))
        assert cim.claim(mod.Page(2, 32, 16, 64, 16), evict=True) == [0, 1]
        assert cim.region_free(0, 0, 32, 512)
        assert not cim.region_free(32, 16, 1, 1)
        assert cim.region_free(32, 16, 1, 1, ignore={2})
    w = rng.integers(-1, 2, (64, 16)).astype(np.int8)
    port.write_page(2, torch.as_tensor(w))
    ref.write_page(2, w)
    np.testing.assert_array_equal(_np(port.read_page(2)), ref.read_page(2))
    np.testing.assert_array_equal(_np(port.pos), ref.pos)
    np.testing.assert_array_equal(_np(port.neg), ref.neg)
    np.testing.assert_array_equal(port._owner, ref._owner)
    assert (port.used_cells, port.utilization(2)) == (ref.used_cells,
                                                      ref.utilization(2))
    assert port.mac_cycle_count(2, 500, 8) == ref.mac_cycle_count(2, 500, 8)
    for mod, cim in ((macro, port), (ref_macro, ref)):
        with pytest.raises(ValueError, match="weight shape"):
            cim.write_page(2, np.zeros((64, 17), np.int8))


@pytest.mark.parametrize("args", [(0, 1000, 0, 25, 16), (0, 0, 500, 16, 16),
                                  (0, 0, 0, 16, 129), (0, -1, 0, 1, 1)],
                         ids=str)
def test_macro_page_out_of_range_errors_agree(args):
    with pytest.raises(ValueError) as want:
        ref_macro.Page(*args)
    with pytest.raises(ValueError) as got:
        macro.Page(*args)
    assert str(got.value) == str(want.value)


def test_weight_sram_capacity_matches_reference():
    port, ref = macro.WeightSRAM("cpu"), ref_macro.WeightSRAM()
    for ws in (port, ref):
        ws.store(0, np.ones((1024, 256), np.int8))    # exactly 512 Kb
        assert ws.used_bits == macro.WEIGHT_SRAM_BITS
        with pytest.raises(MemoryError, match="weight SRAM overflow"):
            ws.store(1, np.ones((1, 16), np.int8))
    np.testing.assert_array_equal(_np(port.load(0)), ref.load(0))
    with pytest.raises(MemoryError):
        macro.WeightSRAM("cpu").store(0, np.ones((1024, 512), np.int8))


# ---------------------------------------------------------------------------
# TWM: the exact parts equal, the Monte Carlo flip rates within tolerance
# ---------------------------------------------------------------------------

def test_twm_exact_parts_match_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (11, 96))
    w = rng.integers(-1, 2, (96, 17))
    with dispatch.counting() as launched:
        got = twm.twm_mac(torch.as_tensor(x), torch.as_tensor(w))
    assert launched() == {tm.POPCOUNT_KERNEL: 1}
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(ref_twm.twm_mac(jnp.array(x, jnp.uint32),
                                             jnp.array(w, jnp.int32))))
    np.testing.assert_array_equal(_np(got), x @ w)
    # leading axes
    x3 = rng.integers(0, 2, (2, 3, 40))
    w3 = rng.integers(-1, 2, (40, 5))
    np.testing.assert_array_equal(
        _np(twm.twm_mac(torch.as_tensor(x3), torch.as_tensor(w3))),
        np.asarray(ref_twm.twm_mac(jnp.array(x3), jnp.array(w3))))
    wb = rng.choice([-1, 1], (96, 17))
    for n_ref in (None, 20.0):
        np.testing.assert_array_equal(
            _np(twm.bwm_mac(torch.as_tensor(x), torch.as_tensor(wb), n_ref)),
            np.asarray(ref_twm.bwm_mac(jnp.array(x, jnp.uint32),
                                       jnp.array(wb, jnp.int32), n_ref)))
    d = [-1.0, -0.5, 0.0, 0.5, 1.0]
    np.testing.assert_array_equal(
        _np(twm.SAModel(0.0).decide(torch.tensor(d)).view(torch.int32)),
        np.asarray(ref_twm.SAModel(0.0).decide(jnp.array(d))))
    assert twm.sensing_margin_twm() == ref_twm.sensing_margin_twm()
    assert twm.sensing_margin_bwm() == ref_twm.sensing_margin_bwm()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        twm.SAModel(1.0).decide(torch.tensor(d))
    with pytest.raises(ValueError):
        twm.flip_rate_under_noise(torch.Generator(), x, w, 1.0, "cwm")


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 4.0])
def test_twm_flip_rates_within_sampling_tolerance(sigma):
    """±1 weights, so the BWM arm rounds nothing: each rate's only chance
    is the SA noise, a mean of n = rows x cols x trials Bernoulli draws."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2, (64, 128))
    w = rng.choice([-1, 1], (128, 32))
    trials = 64
    n = x.shape[0] * w.shape[1] * trials
    tol = 5 * math.sqrt(1 / (2 * n))
    gen = torch.Generator().manual_seed(0)
    for mapping in ("twm", "bwm"):
        got = float(twm.flip_rate_under_noise(
            gen, torch.as_tensor(x), torch.as_tensor(w), sigma, mapping,
            trials=trials))
        want = float(ref_twm.flip_rate_under_noise(
            jax.random.PRNGKey(0), jnp.array(x, jnp.uint32),
            jnp.array(w, jnp.int32), sigma, mapping, trials=trials))
        assert abs(got - want) <= tol, (mapping, got, want, tol)


def test_twm_flips_less_than_bwm_in_both():
    """The reference's Fig. 3(c) case, ternary weights with zeros: TWM
    flips less than BWM at equal noise, in both packages."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2, (64, 128))
    w = rng.integers(-1, 2, (128, 32))
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for sigma in (1.0, 2.0):
        ft, fb = (float(twm.flip_rate_under_noise(
            gen, torch.as_tensor(x), torch.as_tensor(w), sigma, m,
            trials=16)) for m in ("twm", "bwm"))
        rt, rb = (float(ref_twm.flip_rate_under_noise(
            key, jnp.array(x, jnp.uint32), jnp.array(w, jnp.int32), sigma, m,
            trials=16)) for m in ("twm", "bwm"))
        assert ft < fb and rt < rb, (sigma, ft, fb, rt, rb)
