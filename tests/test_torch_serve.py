"""The port's LM serving (``repro_torch.serve``, ``launch.serve``) against
the reference's on the CPU: the sampler, and the continuous-batching
``Engine`` on the same Qwen3 smoke params (carried over through
``params_from_numpy``), sync and async, through slot refills, elastic
grow/shrink, a queue held at the ceiling and a 2-shard ``StreamMesh``,
with the same ``lm_*`` events.  The drives run the shared position clock
past ``max_seq`` (ROADMAP C.6, which the port reproduces).

Tokens are compared exactly.  Where one differs, the first differing
step of that request must be a near tie of the reference's logits: the
reference's logit of its own token exceeds its logit of the port's token
by at most ``LOGIT_ATOL``, the logit tolerance of ``test_torch_lm.py``;
that request's later tokens follow their own history and are not
compared.  Runs of the port against itself (sync and async, 2 shards and
1) are equal token for token.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro.serve import sampler as ref_sampler
from repro_torch.configs.base import get_arch
from repro_torch.launch import serve as port_launch
from repro_torch.launch.mesh import StreamMesh, make_stream_mesh
from repro_torch.models import api
from repro_torch.serve import engine, sampler

LOGIT_ATOL = 0.08
NAME = "qwen3-0.6b"
PROMPT = 6
#: (first wave, ticks before the second wave, max_new per request)
MAX_NEW = (8, 3, 8, 3, 5, 5)
FIRST_WAVE, WAIT = 2, 2
MAX_SEQ = 16


@dataclasses.dataclass
class Run:
    tokens: dict
    events: list
    clock: int
    logits: dict | None = None    # the reference's, per rid per token
    capacities: list | None = None


def _requests(cls, vocab: int):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT).astype(np.int32),
                max_new_tokens=n) for i, n in enumerate(MAX_NEW)]


def _drive(eng, reqs, asyn: bool, first: int = FIRST_WAVE):
    """Submit a first wave of ``first`` requests, tick ``WAIT`` times,
    submit the rest, drain; records the slot capacity after every tick."""
    step = eng.step_async if asyn else eng.step
    caps, done = [], []
    for r in reqs[:first]:
        eng.submit(r)
    for _ in range(WAIT):
        done += step()
        caps.append(eng.slots)
    for r in reqs[first:]:
        eng.submit(r)
    for _ in range(200):
        done += step()
        caps.append(eng.slots)
        if not eng.queue and all(r is None for r in eng.slot_req) and (
                not asyn or not eng._pending):
            break
    if asyn:
        done += eng.shutdown()
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in done)
    return {r.rid: list(r.out_tokens) for r in done}, caps


def _events(obs) -> list:
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in obs.events.tail() if e["event"].startswith("lm_")]


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_get_arch(NAME, smoke=True)
    ref_params = ref_api.init_params(ref_cfg, jax.random.PRNGKey(0))
    cfg = get_arch(NAME, smoke=True)
    params = api.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_params),
        device="cpu")
    return ref_cfg, ref_params, cfg, params


_REF: dict = {}


def ref_run(models, first=FIRST_WAVE, asyn=False, **kw) -> Run:
    """The reference engine's drive (sync unless ``asyn``), with its
    logits recorded per request and token (prefill's, then each decode
    tick's row, recorded at dispatch)."""
    key = (models[0].name, first, asyn, *sorted(kw.items()))
    if key in _REF:
        return _REF[key]
    ref_cfg, ref_params, _, _ = models
    eng = ref_engine.Engine(ref_cfg, ref_params, max_seq=MAX_SEQ, **kw)
    rec: dict = {}
    prefills: list = []
    decode, prefill = eng._decode, eng._prefill_one

    def rec_decode(params, state, last):
        logits, state = decode(params, state, last)
        rows = np.asarray(logits[:, -1])
        for slot, req in enumerate(eng.slot_req):
            if req is not None:
                rec.setdefault(req.rid, []).append(rows[slot])
        return logits, state

    def rec_prefill(*args):
        state, last = prefill(*args)
        prefills.append(np.asarray(last))
        return state, last

    eng._decode, eng._prefill_one = rec_decode, rec_prefill
    tokens, caps = _drive(eng, _requests(ref_engine.Request, ref_cfg.vocab),
                          asyn, first)
    events = _events(eng.obs)
    fills = [e["rid"] for e in events if e["event"] == "lm_slot_fill"]
    logits = {rid: [first] + rec.get(rid, [])
              for rid, first in zip(fills, prefills)}
    run = _REF[key] = Run(tokens, events, int(eng.state["cache_len"]),
                          logits, caps)
    return run


def port_run(models, asyn=False, first=FIRST_WAVE, **kw) -> Run:
    _, _, cfg, params = models
    eng = engine.Engine(cfg, params, max_seq=MAX_SEQ, **kw)
    tokens, caps = _drive(eng, _requests(engine.Request, cfg.vocab), asyn,
                          first)
    return Run(tokens, _events(eng.obs), int(eng.state["cache_len"]),
               capacities=caps)


def same_tokens(got: Run, ref: Run, vocab: int) -> list:
    """Exact tokens, or a near tie of the reference's logits at the first
    differing step of a request; returns the ties met."""
    assert got.tokens.keys() == ref.tokens.keys()
    ties = []
    for rid, want in ref.tokens.items():
        have = got.tokens[rid]
        assert len(have) == len(want) == len(ref.logits[rid])
        for j, (a, b) in enumerate(zip(want, have)):
            row = ref.logits[rid][j][:vocab]
            assert int(np.argmax(row)) == a
            if a != b:
                margin = float(row[a] - row[b])
                assert margin <= LOGIT_ATOL, (rid, j, a, b, margin)
                ties.append((rid, j, margin))
                break
    return ties


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------

def _logits(seed=0, rows=4, v=544):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, v)).astype(np.float32)
    x[:, 512:] = 100.0            # padded columns would win unmasked
    x[0, 3] = x[0, 7] = 50.0      # a tie: the first index wins
    return x


def test_mask_padded_matches_reference():
    x = _logits()
    got = sampler.mask_padded(torch.as_tensor(x), 512).numpy()
    want = np.asarray(ref_sampler.mask_padded(jnp.asarray(x), 512))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[:, 512:]).all()
    same = torch.as_tensor(x[:, :512])
    assert sampler.mask_padded(same, 512) is same


@pytest.mark.parametrize("seed", range(3))
def test_greedy_matches_reference(seed):
    x = _logits(seed)
    got = sampler.greedy(torch.as_tensor(x), 512)
    want = np.asarray(ref_sampler.greedy(jnp.asarray(x), 512))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < 512).all() and int(got[0]) == 3


def test_sample_temperature_zero_is_greedy():
    x = torch.as_tensor(_logits())
    g = torch.Generator().manual_seed(0)
    assert torch.equal(sampler.sample(g, x, 512, temperature=0.0),
                       sampler.greedy(x, 512))
    # top_k=1 keeps the maximum alone (row 0's tie keeps both ids)
    one = sampler.sample(g, x, 512, temperature=1.0, top_k=1)
    assert torch.equal(one[1:], sampler.greedy(x, 512)[1:])
    assert int(one[0]) in (3, 7)


def test_sample_top_k_keeps_only_the_top_k():
    """Draws stay in the top k of the real vocab and never in the padded
    columns; they repeat for a seed.  They cannot equal ``jax.random``'s
    draws (another generator), so only these properties are compared."""
    x = torch.as_tensor(_logits(1))
    top = set(torch.topk(x[:, :512], 5, dim=-1).indices.flatten().tolist())
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([sampler.sample(g, x, 512, temperature=2.0, top_k=5)
                         for _ in range(200)])
    assert draws.dtype == torch.int32
    for row in range(x.shape[0]):
        keep = set(torch.topk(x[row, :512], 5).indices.tolist())
        assert set(draws[:, row].tolist()) <= keep
    assert set(draws.flatten().tolist()) <= top
    assert len(set(draws[:, 1].tolist())) > 1      # it does sample
    g2 = torch.Generator().manual_seed(0)
    again = torch.stack([sampler.sample(g2, x, 512, temperature=2.0, top_k=5)
                         for _ in range(200)])
    assert torch.equal(draws, again)
    free = sampler.sample(torch.Generator().manual_seed(1), x, 512)
    assert (free < 512).all()


# ---------------------------------------------------------------------------
# Engine against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
def test_engine_matches_reference_through_refills(models, asyn):
    """2 fixed slots, 6 requests in two waves: slots refill as requests
    finish, and the shared clock runs past ``max_seq``."""
    ref = ref_run(models, batch_slots=2)
    got = port_run(models, asyn, batch_slots=2)
    same_tokens(got, ref, models[2].vocab)
    assert got.clock == ref.clock > MAX_SEQ
    assert set(got.capacities) == {2}


def test_engine_sync_equals_async(models):
    sync = port_run(models, batch_slots=2)
    asyn = port_run(models, True, batch_slots=2)
    assert sync.tokens == asyn.tokens and sync.clock == asyn.clock


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
def test_engine_elastic_matches_reference(models, asyn):
    """batch_slots=2 growing to 8 while requests are live, then shrinking
    back: the same tokens and the same lm_resize events as the
    reference's elastic engine."""
    kw = dict(batch_slots=2, max_slots=8, min_slots=2)
    ref = ref_run(models, **kw)
    got = port_run(models, asyn, **kw)
    same_tokens(got, ref, models[2].vocab)
    resizes = [e for e in got.events if e["event"] == "lm_resize"]
    assert resizes == [e for e in ref.events if e["event"] == "lm_resize"]
    assert max(got.capacities) == 8 and got.capacities[-1] == 2
    assert any(e["new"] < e["old"] for e in resizes)


def test_engine_queue_at_the_ceiling(models):
    """An elastic pool capped at 4 slots: the second wave waits in the
    queue at the ceiling and every request is served, as the reference's
    engine serves them."""
    kw = dict(batch_slots=2, max_slots=4, min_slots=2)
    ref = ref_run(models, **kw)
    got = port_run(models, **kw)
    assert max(got.capacities) == 4 == max(ref.capacities)
    assert got.capacities == ref.capacities
    same_tokens(got, ref, models[2].vocab)


def test_engine_event_sequence_matches_reference(models):
    for kw in (dict(batch_slots=2), dict(batch_slots=2, max_slots=8,
                                         min_slots=2)):
        ref = ref_run(models, **kw)
        got = port_run(models, **kw)
        assert got.events == ref.events, kw
        kinds = {e["event"] for e in got.events}
        assert {"lm_submit", "lm_slot_fill", "lm_finish"} <= kinds


@pytest.mark.parametrize("asyn", [False, True], ids=["sync", "async"])
def test_engine_two_shards_match_one(models, asyn):
    """4 slots over a 2-shard CPU ``StreamMesh`` against the reference's
    unsharded engine (its own mesh engine runs on forced host devices in
    ``tests/test_torch_lm_mesh.py``) and the port's 1-shard run, token
    for token.  All six requests come
    at once: requests 1 and 3, the short ones, land on shard 1 and leave
    it empty, so a rebalance migrates a live request."""
    mesh = make_stream_mesh(2, device="cpu")
    n = len(MAX_NEW)
    got = port_run(models, asyn, n, batch_slots=4, mesh=mesh)
    one = port_run(models, asyn, n, batch_slots=4)
    assert got.tokens == one.tokens and got.clock == one.clock
    same_tokens(got, ref_run(models, n, batch_slots=4), models[2].vocab)
    assert any(e["event"] == "lm_rebalance" for e in got.events)


def test_engine_rejects_a_mesh_on_another_device(models):
    _, _, cfg, params = models
    mesh = StreamMesh((torch.device("meta"),) * 2)
    with pytest.raises(ValueError, match="mesh"):
        engine.Engine(cfg, params, mesh=mesh)


def test_engine_and_launcher_raise_without_a_card(models, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.main(["--arch", NAME, "--smoke"])
    monkeypatch.setattr(engine, "canonical_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Engine(cfg, params)


def test_launcher_serves_on_the_cpu():
    port_launch.main(["--arch", NAME, "--smoke", "--requests", "3",
                      "--slots", "2", "--prompt-len", "4", "--max-new", "3",
                      "--device", "cpu"])
