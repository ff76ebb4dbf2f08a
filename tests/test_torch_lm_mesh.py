"""The port's LM ``Engine`` over a mesh of S >= 2 shards against the
reference's ``Engine(mesh=make_stream_mesh(S))`` on S forced host devices.

  * The reference side runs in one subprocess per S and config, side by
    side, each setting ``XLA_FLAGS=--xla_force_host_platform_device_count
    =4`` before JAX starts (the pattern of ``tests/test_torch_multi_
    device.py``) and driving both drives in both modes, the config's
    jitted steps shared by its engines so that each shape compiles
    once.  S = 2 and 4 for
    ``qwen3-0.6b`` and ``deepseek-moe-16b``, S = 2 for
    ``jamba-1.5-large-398b``, ``xlstm-350m`` and ``seamless-m4t-medium``,
    all at smoke size; sync and async; on ``tests/test_torch_serve.py``'s
    drive at 4 slots and on the skewed drive (``DRIVES["skewed"]``: six
    4-token prompts, ``max_new`` 2, 8, 2, 8, 2, 8, all at once, 4 slots,
    ``max_seq`` 32), whose short requests empty a shard so that a
    rebalance migrates a live request.  Each run records, tick by tick,
    the tokens fed to every row, every row's logits, which request each
    row serves, the prefill logits of the rows filled before the tick,
    and for the MoE configs the decode state before the tick.
  * The port drives the same requests through ``Engine(mesh=
    make_stream_mesh(S, device="cpu"))``: S shards of the CPU on the code
    a machine with several cards runs, the copies between cards
    excepted.  Its events and clock must equal the reference's, and its
    tokens follow :func:`same_drive`'s rule.  After every structural
    remap and at the end each shard's cache parts and feedback token lie
    on ``mesh.devices[s]`` in storage of their own, the clock has one
    copy a distinct device and the params one copy a distinct device.
  * The dense config over S shards equals the port's unsharded engine
    token for token; the MoE exchange (``moe.apply_moe_gathered``) over
    S = 2 and 4 shards equals ``apply_moe`` on the whole batch bit for
    bit at a binding capacity; ``stack.decode_shards`` over S shards
    equals one ``decode_step`` over the concatenated state for every
    smoke config.

The token rule.  Rows that serve no request decode too, and under the
``dropping`` MoE dispatch every row competes for expert capacity, so a
config with an MoE layer is compared tick by tick: every row's fed token
equal up to the first tick where one differs.  There, each differing
token is either a near tie of the reference's logits of its row (its
own token's logit beats the port's by at most ``LOGIT_ATOL``), or the
drives parted at a router near tie at an earlier tick ``t0``, the first
tick where the logits differ beyond (``LOGIT_RTOL``, ``LOGIT_ATOL``):
on the reference's state before ``t0``, the reference's router run op by
op (``jax.disable_jit``) agrees with the port's within the tolerances of
``chip_smoke.py``'s ``RouterPin``, and every expert the two choose
differently is a near tie of the reference's probabilities; with those
rows held to the reference's experts, the port's tick ``t0`` on its own
state gives the reference's op-by-op logits within tolerance.  (Where
the reference's compiled and op-by-op ticks part there themselves, the
port must instead equal the op-by-op tick, whose router then holds a
near tie.)  Nothing after the split is compared.  A config without an
MoE layer keeps its rows apart, so each request is compared on its own
as ``serve.same_tokens`` does.

The skewed async drive on DeepSeek-MoE splits so at tick 4: the
reference's router puts experts 0 and 3 of row 0 in its second MoE
layer within 2.2e-4 of each other (``test_skewed_async_moe_splits_at_a_
router_near_tie``).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_families as lmf
import test_torch_serve as serve
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro_torch.configs import base as port_base
from repro_torch.launch.mesh import Replicated, ShardRows, make_stream_mesh
from repro_torch.models import api, moe, stack
from repro_torch.runtime.pool import tree_map
from repro_torch.serve import engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_RTOL, LOGIT_ATOL = lmf.LOGIT_RTOL, lmf.LOGIT_ATOL
#: ``chip_smoke.py``'s ``RouterPin`` tolerances: router probabilities of
#: two runs within them, an expert taken over only at such a near tie
ROUTER_RTOL, ROUTER_ATOL = 0.06, 1e-4
DENSE, MOE = "qwen3-0.6b", "deepseek-moe-16b"
#: the configs driven at each S
CONFIGS = {2: (DENSE, MOE, "jamba-1.5-large-398b", "xlstm-350m",
               lmf.ENCDEC),
           4: (DENSE, MOE)}
SLOTS = 4
#: (prompt tokens, max_new per request, requests before the wait, max_seq)
DRIVES = {"serve": (serve.PROMPT, serve.MAX_NEW, serve.FIRST_WAVE,
                    serve.MAX_SEQ),
          "skewed": (4, (2, 8, 2, 8, 2, 8), 6, 32)}
MODES = ("sync", "async")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are too small to share out: one torch thread
    runs this file's drives several times faster than a thread a core,
    and keeps them from crowding the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _has_moe(cfg) -> bool:
    return cfg.family != "encdec" and any(
        f == "moe" for _, f in stack.block_structure(cfg))


def requests(cls, vocab: int, drive: str):
    prompt, max_new, _, _ = DRIVES[drive]
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, prompt).astype(
        np.int32), max_new_tokens=n) for i, n in enumerate(max_new)]


@dataclasses.dataclass
class Trace:
    """One drive, tick by tick (see the module docstring)."""
    tokens: dict
    events: list
    clock: int
    feeds: list = dataclasses.field(default_factory=list)
    rows: list = dataclasses.field(default_factory=list)
    rids: list = dataclasses.field(default_factory=list)
    fills: list = dataclasses.field(default_factory=list)
    states: list = dataclasses.field(default_factory=list)
    routes: list = dataclasses.field(default_factory=list)
    remaps: int = 0
    eng: object = None
    step: object = None      # the engine's own tick, untraced


def trace_drive(eng, reqs, asyn: bool, first: int, *, host, keep_state,
                route=None) -> Trace:
    """Drive ``eng`` as ``serve._drive`` does (``first`` requests, a wait,
    the rest), recording each tick's feeds, logits rows, requests by row
    and the prefill logits of the rows filled before it (``host`` brings
    a tensor or array to numpy, ``keep_state`` copies the state before a
    tick or returns None).  ``route``: a context that records the
    router's calls of a tick into a list, kept per tick."""
    tr = Trace({}, [], 0)
    decode, prefill, install = eng._decode, eng._prefill_one, eng._install
    tr.step = decode
    pending: dict = {}
    last_prefill: list = []

    def traced(params, state, last):
        tr.states.append(keep_state(state))
        tr.feeds.append(host(last).ravel().tolist())
        tr.rids.append([None if r is None else r.rid for r in eng.slot_req])
        tr.fills.append(dict(pending))
        pending.clear()
        calls: list = []
        if route is None:
            logits, state = decode(params, state, last)
        else:
            with route(calls):
                logits, state = decode(params, state, last)
        tr.routes.append(calls)
        tr.rows.append(host(logits)[:, -1].astype(np.float32))
        return logits, state

    def traced_prefill(*args):
        st, last = prefill(*args)
        last_prefill[:] = [host(last).astype(np.float32)]
        return st, last

    def traced_install(slot, st1):
        pending[slot] = last_prefill[0]
        return install(slot, st1)

    eng._decode, eng._prefill_one, eng._install = (traced, traced_prefill,
                                                   traced_install)
    tr.tokens, _ = serve._drive(eng, reqs, asyn, first)
    tr.events = serve._events(eng.obs)
    tr.clock = int(eng.state["cache_len"])
    return tr


# ---------------------------------------------------------------------------
# The reference over S forced host devices
# ---------------------------------------------------------------------------

_REF_RUN = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
S, name, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import jax
import jax.numpy as jnp
import numpy as np
import test_torch_lm_mesh as lm
from repro.configs.base import get_arch
from repro.launch.mesh import make_stream_mesh
from repro.models import api
from repro.obs import Observability
from repro.serve.engine import Engine, Request

assert jax.device_count() == 4
mesh = make_stream_mesh(S)


def host(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


runs = {}
cfg = get_arch(name, smoke=True)
params = api.init_params(cfg, jax.random.PRNGKey(0))
moe = lm._has_moe(cfg)
jitted = {}
for drive, (_, _, first, max_seq) in lm.DRIVES.items():
    for mode in lm.MODES:
        eng = Engine(cfg, params, batch_slots=lm.SLOTS, max_seq=max_seq,
                     mesh=mesh, obs=Observability.create(mirror_events=False))
        # one compile a shape: the engines of a config share the steps
        fns = jitted.setdefault(max_seq, (eng._decode, eng._prefill_one))
        eng._decode, eng._prefill_one = fns
        tr = lm.trace_drive(
            eng, lm.requests(Request, cfg.vocab, drive), mode == "async",
            first, host=host, keep_state=lambda st: (
                jax.tree_util.tree_map(host, st) if moe else None))
        tr.eng = tr.step = None
        runs[S, name, drive, mode] = tr
with open(out, "wb") as f:
    pickle.dump(runs, f)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Every config's drives in both modes on the reference's mesh engine
    over S = 2 and 4 of 4 host devices, one subprocess per S and config
    (all side by side)."""
    d = tmp_path_factory.mktemp("ref_lm_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu")
    jobs = [(S, name) for S, names in CONFIGS.items() for name in names]
    procs = {job: subprocess.Popen(
        [sys.executable, "-c", _REF_RUN, str(job[0]), job[1],
         str(d / f"ref{i}.pkl")], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, job in enumerate(jobs)}
    logs = {}
    try:
        for job, p in procs.items():
            logs[job] = p.communicate(timeout=400)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    runs = {}
    for i, (job, p) in enumerate(procs.items()):
        assert p.returncode == 0, (job, logs[job][-3000:])
        # written by the subprocess above, from this repository's code
        with open(d / f"ref{i}.pkl", "rb") as f:
            runs.update(pickle.load(f))
    return runs


# ---------------------------------------------------------------------------
# The port over S shards of the CPU
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, ShardRows):
        x = x.cpu()
    return x.detach().to(torch.float32).numpy() if x.is_floating_point() \
        else x.numpy()


def _clone(state):
    """A deep copy of an engine's state (``ShardRows`` parts, the
    ``Replicated`` clock) that no later tick writes."""
    if isinstance(state, ShardRows):
        return ShardRows(p.clone() for p in state.parts)
    if isinstance(state, Replicated):
        return state.map(torch.clone)
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_clone(v) for v in state)
    return copy.copy(state)


class _Route:
    """``moe.route`` recorded into a list (experts and probabilities of
    every call) or, with ``hold``, its experts replaced by ``hold[i]``'s
    on the i-th call where they differ (gates re-normalised from this
    run's probabilities, as ``RouterPin.hold`` does)."""

    def __init__(self, hold=None):
        self.hold = hold

    def __call__(self, calls):
        self.calls = calls
        return self

    def __enter__(self):
        own = self.own = moe.route

        def route(p, x, top_k):
            vals, idx, aux = own(p, x, top_k)
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).to(
                torch.float32) @ p["router"], dim=-1)
            i = len(self.calls)
            self.calls.append((idx.numpy().copy(), probs.numpy().copy()))
            if self.hold is not None:
                want = torch.as_tensor(np.array(self.hold[i]),
                                       dtype=idx.dtype)
                if not torch.equal(want, idx):
                    vals = probs.gather(1, want)
                    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
                    idx = want
            return vals, idx, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.own


_PORT: dict = {}


def port_drive(name, drive, mode, S=None) -> Trace:
    """The port's drive (over ``make_stream_mesh(S, "cpu")`` unless S is
    None), each structural remap's placement checked and counted; made
    once per arguments, the file's tests sharing it."""
    key = (name, drive, mode, S)
    if key in _PORT:
        return _PORT[key]
    c = lmf.case(name)
    _, _, first, max_seq = DRIVES[drive]
    mesh = None if S is None else make_stream_mesh(S, device="cpu")
    eng = engine.Engine(c.cfg, c.params, batch_slots=SLOTS, max_seq=max_seq,
                        mesh=mesh)
    remaps = [0]
    if mesh is not None:
        install = eng.set_device_state

        def set_device_state(state):
            install(state)
            check_placement(eng, "remap")
            remaps[0] += 1
        eng.set_device_state = set_device_state
    moe_cfg = _has_moe(c.cfg)
    tr = trace_drive(eng, requests(engine.Request, c.cfg.vocab, drive),
                     mode == "async", first, host=_host,
                     keep_state=_clone if moe_cfg else lambda st: None,
                     route=_Route() if moe_cfg else None)
    tr.eng, tr.remaps = eng, remaps[0]
    if mesh is not None:
        check_placement(eng, "end")
    _PORT[key] = tr
    return tr


def check_placement(eng, where):
    """Each slot leaf of the cache and the feedback token a ``ShardRows``
    with part ``s`` on ``mesh.devices[s]`` in storage of its own; the
    clock one copy a distinct device; one params copy a distinct device,
    each shard stepping with its device's."""
    mesh = eng.mesh
    leaves = []
    tree_map(leaves.append, eng.device_state())
    clock = eng.state["cache_len"]
    assert isinstance(clock, Replicated), where
    assert list(clock.copies) == list(mesh.distinct), where
    seen = set()
    for leaf in leaves:
        if leaf is None or leaf is clock:
            continue
        assert isinstance(leaf, ShardRows), (where, type(leaf))
        assert leaf.devices == mesh.devices, where
        for p in leaf.parts:
            ptr = p.untyped_storage().data_ptr()
            assert ptr not in seen, (where, "shared storage")
            seen.add(ptr)
    if eng._last_tok is not None:
        assert isinstance(eng._last_tok, ShardRows), where
    assert list(eng._params_on) == list(mesh.distinct), where
    assert all(p is eng._params_on[d]
               for p, d in zip(eng._tick_params, mesh.devices)), where


# ---------------------------------------------------------------------------
# The token rule
# ---------------------------------------------------------------------------

def _ref_state(ref_cfg, state, max_seq):
    """A recorded reference state (numpy) as the reference's arrays."""
    like = ref_api.init_decode_state(ref_cfg, SLOTS, max_seq)
    return jax.tree_util.tree_map(
        lambda a, lk: jnp.asarray(a).astype(lk.dtype), state, like)


def _ref_tick_op_by_op(c, state, feed):
    """The reference's tick on ``state`` run op by op, its router's calls
    recorded -> (logits rows, [(experts, probabilities)])."""
    calls = []
    own = ref_moe._router

    def router(p, x, top_k):
        out = own(p, x, top_k)
        n = x.shape[0] * x.shape[1]
        calls.append((np.asarray(out[1]), np.asarray(jax.nn.softmax(
            x.reshape(n, -1).astype(jnp.float32) @ p["router"], axis=-1))))
        return out

    ref_moe._router = router
    try:
        with jax.disable_jit():
            logits, _ = ref_api.decode_fn(c.ref_cfg)(
                c.ref_params, state, jnp.asarray(feed, jnp.int32)[:, None])
    finally:
        ref_moe._router = own
    return np.asarray(logits[:, -1]), calls


def _near_tie(want_idx, got_idx, probs) -> bool:
    """Every expert chosen differently is a near tie of ``probs`` (the
    reference's): its own expert's probability beats the other's by at
    most the router tolerance."""
    for k in np.nonzero(want_idx != got_idx)[0]:
        a, b = probs[want_idx[k]], probs[got_idx[k]]
        if a - b > ROUTER_ATOL + ROUTER_RTOL * b:
            return False
    return True


def router_split(got: Trace, want: Trace, c, max_seq, t0) -> int:
    """The router near tie at tick ``t0`` (module docstring) -> the count
    of routing rows found at a near tie there; raises where there is
    none."""
    state = _ref_state(c.ref_cfg, want.states[t0], max_seq)
    rows, calls = _ref_tick_op_by_op(c, state, want.feeds[t0])
    vocab = c.cfg.vocab
    # the port's routing against the reference's, call by call
    assert len(calls) == len(got.routes[t0]), t0
    parted = 0
    for (want_idx, want_p), (got_idx, got_p) in zip(calls, got.routes[t0]):
        np.testing.assert_allclose(got_p, want_p, rtol=ROUTER_RTOL,
                                   atol=ROUTER_ATOL)
        for r in np.nonzero((want_idx != got_idx).any(-1))[0]:
            assert _near_tie(want_idx[r], got_idx[r], want_p[r]), (t0, r)
            parted += 1
    # held to the reference's experts, the port's tick on its own state
    # is the reference's
    eng = got.eng
    held: list = []
    with _Route(hold=[idx for idx, _ in calls])(held):
        logits, _ = got.step(eng._tick_params, _clone(got.states[t0]),
                             _to_port_tokens(eng, got.feeds[t0]))
    np.testing.assert_allclose(_host(logits)[:, -1, :vocab], rows[:, :vocab],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    if parted:
        return parted
    # the same routing as the reference run op by op: its compiled tick
    # parts from it, at a near tie of its router
    assert not np.allclose(rows[:, :vocab], want.rows[t0][:, :vocab],
                           rtol=LOGIT_RTOL, atol=LOGIT_ATOL), t0
    ties = 0
    for idx, probs in calls:
        top = np.sort(probs, axis=-1)[:, ::-1][:, :idx.shape[1] + 1]
        ties += int((top[:, :-1] - top[:, 1:] <= ROUTER_ATOL
                     + ROUTER_RTOL * top[:, 1:]).any(-1).sum())
    assert ties, (t0, "the reference parts from itself with no tie")
    return ties


def _to_port_tokens(eng, feed):
    toks = torch.as_tensor(np.asarray(feed, np.int32))[:, None]
    return eng.mesh.split(toks) if eng.mesh is not None else toks


def _margin_rows(tr: Trace, t: int) -> dict:
    """The logits each row's token fed at tick ``t`` was sampled from:
    the prefill's for a row filled before ``t``, else tick ``t - 1``'s."""
    out = {r: tr.rows[t - 1][r] for r in range(len(tr.feeds[t]))} \
        if t else {}
    out.update(tr.fills[t])
    return out


def _per_request_logits(tr: Trace) -> dict:
    """Each request's logits, token by token: its prefill's, then each
    tick's row while it is live."""
    out: dict = {}
    for t, (rids, fills) in enumerate(zip(tr.rids, tr.fills)):
        for slot, lg in fills.items():
            out[rids[slot]] = [lg]
        for slot, rid in enumerate(rids):
            if rid is not None:
                out[rid].append(tr.rows[t][slot])
    return out


def same_drive(got: Trace, want: Trace, name: str, drive: str) -> dict:
    """The token rule of the module docstring, with the events and the
    clock held equal -> what it met: ``split`` (the tick where the fed
    tokens part, or None), ``logit_ties``, ``router_rows``."""
    c = lmf.case(name)
    vocab = c.cfg.vocab
    assert got.events == want.events
    assert got.clock == want.clock
    assert got.tokens.keys() == want.tokens.keys()
    met = dict(split=None, logit_ties=0, router_rows=0)
    if not _has_moe(c.cfg):
        ref = serve.Run(want.tokens, want.events, want.clock,
                        _per_request_logits(want))
        met["logit_ties"] = len(serve.same_tokens(
            serve.Run(got.tokens, got.events, got.clock), ref, vocab))
        return met
    assert len(got.feeds) == len(want.feeds)
    split = next((t for t, (a, b) in enumerate(zip(want.feeds, got.feeds))
                  if a != b), None)
    met["split"] = split
    if split is None:
        assert got.tokens == want.tokens
        return met
    assert split > 0
    margins = _margin_rows(want, split)
    far = []
    for row, (a, b) in enumerate(zip(want.feeds[split], got.feeds[split])):
        if a != b:
            lg = margins[row][:vocab]
            assert int(np.argmax(lg)) == a, (split, row)
            if float(lg[a] - lg[b]) <= LOGIT_ATOL:
                met["logit_ties"] += 1
            else:
                far.append(row)
    if far:
        t0 = next(t for t in range(split) if not np.allclose(
            got.rows[t][:, :vocab], want.rows[t][:, :vocab],
            rtol=LOGIT_RTOL, atol=LOGIT_ATOL))
        met["router_rows"] = router_split(got, want, c, DRIVES[drive][3], t0)
    return met


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

CASES = [(S, name, drive, mode) for S, names in CONFIGS.items()
         for name in names for drive in DRIVES for mode in MODES]


@pytest.mark.parametrize("S,name,drive,mode", CASES,
                         ids=[f"S{S}-{n}-{d}-{m}" for S, n, d, m in CASES])
def test_engine_matches_reference_mesh(reference_runs, S, name, drive,
                                       mode):
    """Tokens, events and clock against the reference's S-device engine;
    placement after every structural remap.  The skewed drive fires a
    rebalance at S = 2 (every shard holds one slot at S = 4)."""
    got = port_drive(name, drive, mode, S)
    same_drive(got, reference_runs[S, name, drive, mode], name, drive)
    rebalances = [e for e in got.events if e["event"] == "lm_rebalance"]
    assert got.remaps == len(rebalances)
    if drive == "skewed" and S == 2:
        assert rebalances and all(e["shards"] == 2 for e in rebalances)


@pytest.mark.parametrize("S", sorted(CONFIGS))
@pytest.mark.parametrize("drive", DRIVES)
def test_dense_shards_match_one(S, drive):
    """The dense config's S-shard engine equals its unsharded one token
    for token, sync and async."""
    for mode in MODES:
        got = port_drive(DENSE, drive, mode, S)
        one = port_drive(DENSE, drive, mode)
        assert got.tokens == one.tokens and got.clock == one.clock


def test_skewed_async_moe_splits_at_a_router_near_tie(reference_runs):
    """DeepSeek-MoE smoke on the skewed drive, async, over 2 shards
    against the reference's 2-device engine.  The fed tokens part at
    tick 5, and not at a near tie of the logits:
    at tick 4 the reference's router, run op by op on its own state,
    ranks experts 0 and 3 of row 0 in the second MoE layer within the
    router tolerance, the port takes the other one, and with that row
    held to the reference's experts the port's tick 4 is the
    reference's within the logits' tolerance."""
    want = reference_runs[2, MOE, "skewed", "async"]
    got = port_drive(MOE, "skewed", "async", 2)
    met = same_drive(got, want, MOE, "skewed")
    assert met["split"] == 5 and met["router_rows"] >= 1
    c = lmf.case(MOE)
    state = _ref_state(c.ref_cfg, want.states[4], DRIVES["skewed"][3])
    _, calls = _ref_tick_op_by_op(c, state, want.feeds[4])
    idx, probs = calls[1]
    top = np.sort(probs[0])[::-1]
    assert set(idx[0]) <= {int(np.argmax(probs[0])), 0, 3}
    assert top[1] - top[2] <= ROUTER_ATOL + ROUTER_RTOL * top[2]
    assert {int(np.argsort(probs[0])[::-1][i]) for i in (1, 2)} == {0, 3}


@pytest.mark.parametrize("S", (2, 4))
def test_moe_exchange_is_bit_equal_at_a_binding_capacity(S):
    """``apply_moe_gathered`` over the rows of a (4, 1, D) batch split
    into S shards equals ``apply_moe`` on the whole batch bit for bit,
    under the dropping dispatch at DeepSeek's decode capacity: 4 rows,
    top-6 of 64 experts give ``max(1, int(4 * 6 / 64 * 1.25)) = 1``, so
    rows drop."""
    g = torch.Generator().manual_seed(S)
    p = moe.init_moe(g, 32, 16, 64, n_shared=2, device="cpu")
    x = torch.randn((4, 1, 32), generator=g).to(torch.bfloat16)
    whole, _ = moe.apply_moe(p, x, top_k=6, impl="dropping")
    _, idx, _ = moe.route(p, x, 6)
    _, keep = moe._positions(idx, 64, 1)
    assert not all(bool(k.all()) for k in keep)     # the capacity binds
    outs = moe.apply_moe_gathered([p] * S, list(x.chunk(S)), top_k=6)
    assert [tuple(o.shape) for o in outs] == [(4 // S, 1, 32)] * S
    assert torch.equal(torch.cat(outs), whole)


@pytest.mark.parametrize("name", port_base.arch_names())
def test_decode_shards_equal_one_step(name):
    """``stack.decode_shards`` (``api.decode_shards_fn``) over 2 and 4
    shards of a batch of 4 against one ``decode_step`` over the state
    they make together, after 3 steps that fill the caches: every bf16
    cache row equal bit for bit, the float32 recurrent states and logits
    within float32 rounding (a float32 product over 1 row or 2 may round
    otherwise than over 4)."""
    cfg = port_base.get_arch(name, smoke=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(0)
    state = api.init_decode_state(cfg, SLOTS, 16, device="cpu")
    if cfg.family == "encdec":
        state["memory"] = torch.as_tensor(rng.standard_normal(
            tuple(state["memory"].shape)).astype(np.float32)).to(
                torch.bfloat16)
    step = api.decode_fn(cfg)
    for _ in range(3):
        _, state = step(params, state, torch.as_tensor(rng.integers(
            0, cfg.vocab, (SLOTS, 1)).astype(np.int32)))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, 1)).astype(
        np.int32))
    axes = engine.Engine(cfg, params, batch_slots=SLOTS,
                         max_seq=16)._cache_axes
    flat = engine._flat(state)
    for S in (2, 4):
        n = SLOTS // S
        parts = [engine._unflat(tree_map(
            lambda a, ax, s=s: a.clone() if ax < 0
            else a.narrow(ax, s * n, n).clone(), flat, axes), state)
            for s in range(S)]
        whole = engine._unflat(tree_map(lambda a, ax: a.clone(), flat, axes),
                               state)
        want, want_state = step(params, whole, toks)
        got, got_states = api.decode_shards_fn(cfg)(
            [params] * S, parts, list(toks.chunk(S)))
        torch.testing.assert_close(torch.cat(got), want, rtol=1e-5,
                                   atol=1e-5)
        assert all(int(st["cache_len"]) == int(want_state["cache_len"])
                   for st in got_states)

        def same(w, ax, *g):
            if ax >= 0:
                tol = 0 if w.dtype == torch.bfloat16 else 1e-5
                torch.testing.assert_close(torch.cat(g, ax), w, rtol=tol,
                                           atol=tol, msg=f"{name} S={S}")

        tree_map(same, engine._flat(want_state), axes,
                 *(engine._flat(st) for st in got_states))


def test_engine_shard_settles_a_whole_leaf():
    """``Engine.shard`` (the reference's ``NamedSharding`` hook) splits a
    whole leaf's slot axis into a ``ShardRows``, each block a tensor of
    its own on its shard's device, and leaves a ``ShardRows`` as it is."""
    c = lmf.case(DENSE)
    eng = engine.Engine(c.cfg, c.params, batch_slots=SLOTS, max_seq=8,
                        mesh=make_stream_mesh(2, device="cpu"))
    x = torch.arange(3 * SLOTS * 2).reshape(3, SLOTS, 2)
    got = eng.shard(x, 1)
    assert isinstance(got, ShardRows) and eng.shard(got, 1) is got
    assert [tuple(p.shape) for p in got.parts] == [(3, 2, 2)] * 2
    assert torch.equal(torch.cat(got.parts, 1), x)
    assert all(p.is_contiguous() and p.untyped_storage().data_ptr()
               != x.untyped_storage().data_ptr() for p in got.parts)
