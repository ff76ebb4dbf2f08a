"""Batched serving engine on the shared continuous-batching runtime.

The port of the reference's ``repro/serve/engine.py``.  Requests enter a
queue; free batch slots are filled per decode tick (continuous batching),
finished sequences vacate their slot.  The slot state is the stacked
cache tree of ``models.api.init_decode_state``; a request's prefill runs
the decode step over its prompt tokens one by one into a one-row state,
and its install copies that row into the batch in place.

Everything structural about the slot plane (slot <-> request binding,
pow-2 elastic grow/shrink, S shards of the slot axis, the epoch barrier
that drains in-flight decode ticks before any slot remap) comes from
:class:`repro_torch.runtime.SlotPool`; the engine is a pool client like
the KWS stream scheduler, and the pool emits the ``lm_resize`` /
``lm_rebalance`` events.  By default (``max_slots=None``) the pool is
pinned at ``batch_slots``; pass ``max_slots`` / ``min_slots`` for elastic
capacity and ``mesh`` (``launch.mesh.make_stream_mesh``) to shard the
slot axis, as the reference's ``Engine(mesh=)`` does.

Over a mesh of S >= 2 shards every cache leaf with a slot axis and the
async feedback token are ``launch.mesh.ShardRows``: shard ``s``'s rows
are a tensor of their own on ``mesh.devices[s]``, whether the shards
share a device or each has a card (one code path).  The clock is a
``launch.mesh.Replicated`` (a copy on each distinct device) and the
params are copied once to each distinct device.  A tick decodes each
shard's rows on its device, layer by layer in lockstep
(``models.stack.decode_shards``); at an MoE layer every device gathers
the tick's normed rows in pool order and runs the dispatch on all of
them (``models.moe.apply_moe_gathered``), so that the dropping dispatch
ranks the rows in the reference's one global order.  A prefill runs on
the device of the shard its slot lies in.

Every family is served: the state's own keys are flattened for the pool
(the stack's ``cache_len`` / ``head`` / ``layers``, the encoder-decoder's
``cache_len`` / ``memory`` / ``self``; recurrent layers hold tuples of
2-4 float32 states).  Rows without a request decode beside the live ones,
as in the reference: an empty row is fed token 0 (async: its last
sampled token), a freed row keeps its stale state until an install
overwrites it.  Under the ``dropping`` MoE dispatch every row competes
for expert capacity, so only drives with equal batch shapes can be
token-equal (an elastic pool's tokens equal the reference's elastic
engine's, not a fixed pool's).

The engine runs where its params lie (over a mesh, on its devices; the
params must lie on one of them); CUDA params with no card raise.  Every
decode tick syncs with the host once per device, for the sampled
tokens.

Each tick is traced (``obs``): ``decode`` holds ``decode.issue`` (the
model's step, which returns once its kernels are enqueued; the model's
own ``embed``, ``layer.*``, ``moe.*`` and ``head`` spans hang under it),
``decode.sample`` and ``decode.fence`` (the tokens' host copy, the wait
on the card); ``step_async`` splits them over ``decode_dispatch`` and
``decode_retire``, and a prefill's layer spans hang under ``prefill``.
While the tracer is enabled, the MoE layers' expert counts of a decode
tick (``moe.expert_tally``) are read with its tokens and folded into the
registry's ``serve.moe_assigned`` / ``_local`` / ``_kept`` / ``_rows`` /
``_experts_hit`` / ``_layer_ticks`` counters (a layer that holds a share
of the experts counts ``_local`` the assignments to its own, and the
rest over those alone), and ``serve.moe_fused``, the layer dispatches
that ran as ``kernels/moe_dispatch.py``'s kernels.  The
clock ``cache_len`` is shared by all slots and merged with ``max`` at an
install, as in the reference (ROADMAP C.6, reproduced: a request
installed while the clock is ahead attends to the zero rows between its
prompt and the clock, and past ``max_seq`` the cache row write clamps to
the last row).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import (
    Replicated,
    ShardRows,
    canonical_device,
    current,
    dp_size,
)
from repro_torch.models import api, moe
from repro_torch.obs import Observability
from repro_torch.runtime import InFlightQueue, SlotPool, infer_slot_axes
from repro_torch.runtime.pool import tree_map
from repro_torch.serve import sampler
from repro_torch.utils import tree
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _flat(state: dict) -> tuple:
    """The decode state as the nested tuples the slot pool walks: its
    values by sorted key (the stack's ``cache_len``, ``head``, ``layers``;
    the encoder-decoder's ``cache_len``, ``memory``, ``self``)."""
    return tuple(state[k] for k in sorted(state))


def _unflat(flat: tuple, like: dict) -> dict:
    """Inverse of :func:`_flat`, with the keys of the state ``like``."""
    return dict(zip(sorted(like), flat))


def _shard_part(state, s: int, device):
    """Shard ``s``'s own decode state (on ``device``) of a state over a
    mesh: each ``ShardRows`` leaf's part ``s``, the clock's copy there."""
    if isinstance(state, ShardRows):
        return state.parts[s]
    if isinstance(state, Replicated):
        return state.on(device)
    if isinstance(state, dict):
        return {k: _shard_part(v, s, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_shard_part(v, s, device) for v in state)
    return state


def _sharded_decode(cfg: ArchConfig, mesh):
    """The tick over a mesh's shards, with ``decode_fn``'s signature:
    ``(params, state, tokens)`` with ``params[s]`` the copy on shard
    ``s``'s device, the state's slot leaves and the (n, 1) tokens
    ``ShardRows`` -> (logits, state): the logits a ``ShardRows``, each
    leaf's parts written in place, the clock one past the old on every
    device."""
    step = api.decode_shards_fn(cfg)
    first = {d: mesh.devices.index(d) for d in mesh.distinct}

    def decode(params, state, tokens):
        states = [_shard_part(state, s, d)
                  for s, d in enumerate(mesh.devices)]
        logits, new = step(params, states, list(tokens.parts))
        clock = Replicated({d: new[s]["cache_len"]
                            for d, s in first.items()})
        return ShardRows(logits), dict(state, cache_len=clock)

    return decode


class Engine:
    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 4,
                 max_seq: int = 128, obs: Observability | None = None,
                 max_slots: int | None = None,
                 min_slots: int | None = None,
                 mesh=None):
        """Greedy decoding, as the reference's engine does (its ``seed``
        seeds a key it never draws from, so the port has none)."""
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = canonical_device(params["embed"].device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the engine's params lie on a CUDA device and "
                               "none is available")
        if mesh is not None and self.device not in mesh.distinct:
            raise ValueError(f"mesh on {[str(d) for d in mesh.distinct]}, "
                             f"params on {self.device}")
        # S >= 2 shards: the ShardRows path, one params copy a device
        self.mesh = mesh if mesh is not None and dp_size(mesh) > 1 else None

        # prefill and decode-tick latencies land in bounded histograms,
        # spans cover both paths (fenced: the tick's token copy syncs),
        # request lifecycle goes to the structured event log
        self.obs = obs if obs is not None else Observability.create()
        self._prefill_hist = self.obs.registry.histogram("serve.prefill_s")
        self._decode_hist = self.obs.registry.histogram("serve.decode_tick_s")
        # the tick's step (``_decode``) and the prefill's (``_step``)
        self._step = api.decode_fn(cfg)
        if self.mesh is None:
            self._decode = self._step
            self._params_on = {self.device: params}
            self._tick_params = params
        else:
            self._decode = _sharded_decode(cfg, self.mesh)
            self._params_on = {
                d: params if d == self.device else tree.tree_map(
                    lambda t, d=d: t.to(d), params)
                for d in self.mesh.distinct}
            self._tick_params = [self._params_on[d]
                                 for d in self.mesh.devices]

        # the slot axis of every cache leaf, by shape-diffing the state at
        # two batch sizes on the meta device (cache_len's shared clock maps
        # to -1: the pool never touches it, _install merges it via max)
        self._cache_axes = infer_slot_axes(lambda b: _flat(
            api.init_decode_state(cfg, b, max_seq, device="meta")))
        # ``batch_slots`` is the initial capacity; with no ``max_slots``
        # the pool is pinned there, otherwise it doubles on demand up to
        # the ceiling and halves at quarter occupancy down to ``min_slots``
        self._slots = SlotPool(
            self, max_slots if max_slots is not None else batch_slots,
            initial_capacity=batch_slots,
            min_capacity=min_slots if min_slots is not None else min(
                batch_slots, max_slots if max_slots is not None
                else batch_slots),
            n_shards=1 if mesh is None else dp_size(mesh),
            obs=self.obs, event_prefix="lm_", noun="request",
        )
        if self.mesh is None:
            self.state = api.init_decode_state(cfg, batch_slots, max_seq,
                                               device=self.device)
        else:
            # each shard's zeroed state on its device, joined leaf by leaf
            n = batch_slots // dp_size(self.mesh)
            states = [api.init_decode_state(cfg, n, max_seq, device=d)
                      for d in self.mesh.devices]
            first = {d: self.mesh.devices.index(d)
                     for d in self.mesh.distinct}
            self.state = _unflat(tree_map(
                lambda ax, *leaves: Replicated(
                    {d: leaves[s] for d, s in first.items()}) if ax < 0
                else ShardRows(leaves),
                self._cache_axes, *map(_flat, states)), states[0])
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_remaining = np.zeros(batch_slots, np.int32)
        self.queue: list[Request] = []
        # async decode plane (step_async): the last sampled token per slot
        # stays ON DEVICE so tick T+1 dispatches on tick T's tokens, and
        # each tick's host copy retires one tick late; the InFlightQueue's
        # barrier is the pool's pre_structural hook, so a resize or
        # rebalance on ANY path drains in-flight ticks first
        self._last_tok: torch.Tensor | None = None   # (slots, 1) int32
        self._pending = InFlightQueue(self._retire_tick, depth=1)
        self._barrier_finished: list[Request] = []

    @property
    def slots(self) -> int:
        """Current slot capacity (elastic pools grow/shrink this)."""
        return self._slots.capacity

    # -- SlotPool client surface (see repro_torch.runtime.pool) ------------

    def device_state(self):
        """The per-slot device tree the pool resizes/remaps: the stacked
        cache (slot axis 1: leaves are (reps, batch, ...)) and the
        device-resident async feedback token (slot axis 0)."""
        return (_flat(self.state), self._last_tok)

    def set_device_state(self, state) -> None:
        self.state = _unflat(state[0], self.state)
        self._last_tok = state[1]

    def slot_axes(self):
        return (self._cache_axes, -1 if self._last_tok is None else 0)

    def shard(self, x, axis: int = 0):
        """Settle a leaf's slot ``axis`` onto the mesh: a whole tensor's S
        blocks along it become a ``ShardRows``, each block copied to its
        shard's device (nothing moves with no mesh)."""
        if self.mesh is None or isinstance(x, ShardRows):
            return x
        return ShardRows(
            b.to(d, copy=True, memory_format=torch.contiguous_format)
            for b, d in zip(x.chunk(len(self.mesh.devices), axis),
                            self.mesh.devices))

    def _locate(self, slot: int) -> tuple[int, int]:
        """``(shard, row within it)`` of pool slot ``slot``."""
        return divmod(slot, self.slots // len(self.mesh.devices))

    def _device_of(self, slot: int) -> torch.device:
        if self.mesh is None:
            return self.device
        return self.mesh.devices[self._locate(slot)[0]]

    def apply_host_remap(self, remap: dict[int, int], new_cap: int) -> None:
        """Ride the host-side planes (request binding, budget counters)
        through a slot remap: a request's bookkeeping stays glued to its
        cache rows across grows, shrinks and migrations."""
        slot_req: list[Request | None] = [None] * new_cap
        remaining = np.zeros(new_cap, np.int32)
        for old, new in remap.items():
            slot_req[new] = self.slot_req[old]
            remaining[new] = self.slot_remaining[old]
        self.slot_req = slot_req
        self.slot_remaining = remaining

    def pre_structural(self) -> None:
        """Epoch barrier: the pool is about to resize or rebalance; fold
        every in-flight decode tick so the remap never invalidates
        in-flight slot rows.  Requests that finish inside the barrier
        surface from the next ``step_async`` return."""
        for finished in self._pending.barrier():
            self._barrier_finished.extend(finished)

    # -- prefill -------------------------------------------------------------

    def _prefill_one(self, prompt: np.ndarray, device: torch.device):
        """Sequential prefill on ``device`` through the decode step, token
        by token, into a fresh one-row state -> (state, last logits
        (padded_vocab,)) (the reference's scan of the decode step over the
        prompt)."""
        params = self._params_on[device]
        with current(device):
            st = api.init_decode_state(self.cfg, 1, self.max_seq,
                                       device=device)
            toks = torch.as_tensor(np.asarray(prompt, np.int32)).to(device)
            last = None
            for t in range(toks.shape[0]):
                logits, st = self._step(params, st, toks[t:t + 1, None])
                last = logits[0, -1]
            if last is None:
                last = torch.zeros(self.cfg.padded_vocab, device=device)
        return st, last

    # -- queue management ------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.obs.events.emit("lm_submit", rid=req.rid,
                             prompt_tokens=len(req.prompt),
                             max_new=req.max_new_tokens)

    def _fill_slots(self) -> None:
        while self.queue:
            try:
                # least-loaded placement; an elastic pool grows (pow-2,
                # epoch-barriered) on demand up to its ceiling
                slot = self._slots.alloc(self.queue[0].rid)
            except MemoryError:
                break  # every slot busy at the ceiling: stay queued
            req = self.queue.pop(0)
            with self.obs.trace.span("prefill", rid=req.rid,
                                     tokens=len(req.prompt)):
                t0 = time.perf_counter()
                st1, last_logits = self._prefill_one(
                    req.prompt, self._device_of(slot))
                tok = int(sampler.greedy(last_logits[None],
                                         self.cfg.vocab)[0])
                self._prefill_hist.record(time.perf_counter() - t0)
            req.out_tokens.append(tok)
            self._install(slot, st1)
            if self._last_tok is not None:
                # keep the device-resident feedback token in sync so the
                # next async dispatch feeds the prefill's token; a copy,
                # as the reference's ``.at[].set``: the old one is a view
                # of an in-flight tick's tokens, which retire later
                self._last_tok = self._set_row(self._last_tok, slot, tok)
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new_tokens - 1
            self.obs.events.emit("lm_slot_fill", slot=slot, rid=req.rid,
                                 prompt_tokens=len(req.prompt))
            log.info("slot %d <- request %d (prompt %d toks)",
                     slot, req.rid, len(req.prompt))

    def _set_row(self, last, slot: int, tok: int):
        """A copy of the (slots, 1) feedback token with row ``slot`` set
        to ``tok`` (over a mesh only the slot's shard's part is new)."""
        if isinstance(last, ShardRows):
            s, row = self._locate(slot)
            parts = list(last.parts)
            parts[s] = self._set_row(parts[s], row, tok)
            return ShardRows(parts)
        last = last.clone()
        last[slot, 0] = tok
        return last

    def _install(self, slot: int, st1: dict) -> None:
        """Copy a one-row cache tree into batch row ``slot``, in place
        (over a mesh into the slot's shard's part, on its device); the
        shared clock merges with ``max`` (on every device)."""
        def put(full, one, ax):
            if isinstance(full, Replicated):
                return full.map(lambda c: torch.maximum(c, one.to(c.device)))
            if ax < 0:
                return torch.maximum(full, one)  # cache_len: shared clock
            if isinstance(full, ShardRows):
                s, row = self._locate(slot)
                full.parts[s].narrow(ax, row, 1).copy_(one)
            else:
                full.narrow(ax, slot, 1).copy_(one)
            return full

        self.state = _unflat(tree_map(put, _flat(self.state), _flat(st1),
                                      self._cache_axes), self.state)

    def _release(self, slot: int) -> None:
        """Vacate a finished request's slot (the pool rebalances and
        shrinks at the tick barrier)."""
        self.slot_req[slot] = None
        self._slots.free(slot)

    def _tick_barrier(self) -> None:
        self._slots.hop_barrier()
        self._slots.maybe_shrink()

    def _feed(self):
        """(slots, 1) int32 last tokens on the device, over a mesh each
        shard's on its own (empty slots: 0)."""
        toks = torch.tensor(
            [(r.out_tokens[-1] if r is not None and r.out_tokens else 0)
             for r in self.slot_req], dtype=torch.int32)[:, None]
        if self.mesh is not None:
            return self.mesh.split(toks)
        return toks.to(self.device)

    def _sample(self, logits):
        """Greedy tokens (slots,) on the device(s) of the logits."""
        if isinstance(logits, ShardRows):
            return logits.map(
                lambda lg: sampler.greedy(lg[:, -1], self.cfg.vocab))
        return sampler.greedy(logits[:, -1], self.cfg.vocab)

    def _fences(self) -> list:
        """One event a card, recorded after the tick's work queued there
        (none with no mesh, where the tokens' host copy fences)."""
        if self.mesh is None:
            return []
        fences = []
        for d in self.mesh.distinct:
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                fences.append(ev)
        return fences

    # -- decode tick -----------------------------------------------------------

    def _tally(self):
        """The MoE layers' expert tally over one tick's decode call
        (``moe.expert_tally``); a no-op while the tracer is disabled."""
        if not self.obs.trace.enabled:
            return contextlib.nullcontext()
        return moe.expert_tally()

    def _fold_tally(self, tally) -> None:
        """Fold one tick's expert tally into the registry, after its
        tokens' copy: summed over its MoE layers, the (token, slot)
        assignments, those on the experts the layer holds (``local``),
        those of them kept under capacity, the E_held x C bucket rows
        computed and the distinct held experts hit, the layer count, and
        the layers whose dispatch ran as the kernels.  A layer that holds
        every expert counts local all its assignments."""
        if not tally:
            return
        # one (groups, E) block of counts a layer: stacked as rows, each
        # row with its layer's capacity and its held experts' columns
        counts = torch.cat([c.reshape(-1, c.shape[-1]) for c, _, _ in tally]
                           ).cpu().numpy()
        groups = [c.numel() // c.shape[-1] for c, _, _ in tally]
        caps = np.repeat([cap for _, cap, _ in tally], groups)
        held = np.zeros(counts.shape, bool)
        starts = np.cumsum([0] + groups[:-1])
        for r0, g, (_, _, (lo, hi)) in zip(starts, groups, tally):
            held[r0:r0 + g, lo:hi] = True
        local = np.where(held, counts, 0)
        per_layer = np.add.reduceat(local, starts)
        reg = self.obs.registry
        reg.counter("serve.moe_assigned").inc(int(counts.sum()))
        reg.counter("serve.moe_local").inc(int(local.sum()))
        reg.counter("serve.moe_kept").inc(
            int(np.minimum(local, caps[:, None]).sum()))
        reg.counter("serve.moe_rows").inc(int((caps[:, None] * held).sum()))
        reg.counter("serve.moe_experts_hit").inc(int((per_layer > 0).sum()))
        reg.counter("serve.moe_layer_ticks").inc(len(tally))
        reg.counter("serve.moe_fused").inc(tally.fused)

    def step(self) -> list[Request]:
        """One continuous-batching tick: fill slots, decode, retire."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        last = self._feed()
        trace = self.obs.trace
        with trace.span("decode", active=len(active)):
            t0 = time.perf_counter()
            with trace.span("decode.issue"), self._tally() as tally:
                logits, self.state = self._decode(self._tick_params,
                                                  self.state, last)
            with trace.span("decode.sample"):
                toks = self._sample(logits)
            # the tokens' copy to the host (one a device) is the tick's
            # sync: the recorded tick is the decode step, not its enqueue
            with trace.span("decode.fence"):
                toks = toks.cpu().numpy()
                self._fold_tally(tally)
            self._decode_hist.record(time.perf_counter() - t0)
        finished = []
        for slot in active:
            req = self.slot_req[slot]
            req.out_tokens.append(int(toks[slot]))
            self.slot_remaining[slot] -= 1
            if self.slot_remaining[slot] <= 0:
                req.done = True
                finished.append(req)
                self._release(slot)
                self.obs.events.emit("lm_finish", rid=req.rid, slot=slot,
                                     tokens=len(req.out_tokens))
        if finished:
            self._tick_barrier()
        return finished

    def run_until_drained(self, max_ticks: int = 1000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                break
        return done

    # -- async decode (double-buffered ticks) ---------------------------------

    def step_async(self) -> list[Request]:
        """One *pipelined* tick: dispatch tick T on tick T-1's
        device-resident sampled tokens (``sampler.greedy`` runs on the
        device, so the feedback loop never leaves it) and retire tick
        T-1's host copy while T executes.  Requests finish one call later
        than with ``step`` but with identical tokens: ``slot_remaining``
        counts down at dispatch, so slots refill at the same ticks."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if active:
            if self._last_tok is None:
                self._last_tok = self._feed()
            trace = self.obs.trace
            with trace.span("decode_dispatch", active=len(active)):
                t0 = time.perf_counter()
                with trace.span("decode.issue"), self._tally() as tally:
                    logits, self.state = self._decode(
                        self._tick_params, self.state, self._last_tok)
                with trace.span("decode.sample"):
                    toks = self._sample(logits)
                self._last_tok = (toks.map(lambda t: t[:, None])
                                  if isinstance(toks, ShardRows)
                                  else toks[:, None])
                fences = self._fences()
            # bookkeeping happens at dispatch (retirement counts are
            # static), but the token lands at retire, one tick later
            snapshot = []
            for slot in active:
                req = self.slot_req[slot]
                self.slot_remaining[slot] -= 1
                finishing = self.slot_remaining[slot] <= 0
                snapshot.append((slot, req, finishing))
                if finishing:
                    self._release(slot)  # refill next tick
            self._pending.push((toks, snapshot, t0, fences, tally))
        # finishes folded by an epoch barrier (a grow inside _fill_slots,
        # a shrink/rebalance at the tick boundary) surface here
        finished = self._take_barrier_finished()
        # depth-1 pipeline: retire once a newer tick is executing (or when
        # idle, to drain)
        for batch in self._pending.settle(bool(active), max_retire=None):
            finished.extend(batch)
        # structural housekeeping at the same tick boundary as the sync
        # path; a rebalance or shrink here drains the in-flight tick first
        self._tick_barrier()
        return finished

    def _take_barrier_finished(self) -> list[Request]:
        out, self._barrier_finished = self._barrier_finished, []
        return out

    def _retire_tick(self, item, still_in_flight: bool) -> list[Request]:
        """Fence on the oldest in-flight tick and append its host-side
        tokens; emits ``lm_finish`` for requests that completed there."""
        toks, snapshot, t0, fences, tally = item
        trace = self.obs.trace
        with trace.span("decode_retire", n=len(snapshot)), \
                trace.span("decode.fence"):
            for ev in fences:
                ev.synchronize()
            toks_h = toks.cpu().numpy()  # fence + one copy a device
            self._fold_tally(tally)
        self._decode_hist.record(time.perf_counter() - t0)
        finished = []
        for slot, req, finishing in snapshot:
            req.out_tokens.append(int(toks_h[slot]))
            if finishing:
                req.done = True
                finished.append(req)
                self.obs.events.emit("lm_finish", rid=req.rid, slot=slot,
                                     tokens=len(req.out_tokens))
        return finished

    def shutdown(self) -> list[Request]:
        """Retire every in-flight decode tick (nothing stays unfolded at
        teardown)."""
        finished = self._take_barrier_finished()
        for batch in self._pending.barrier():
            finished.extend(batch)
        self._tick_barrier()
        return finished

    def run_until_drained_async(self, max_ticks: int = 1000
                                ) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step_async())
            if (not self.queue and not self._pending
                    and all(r is None for r in self.slot_req)):
                break
        done.extend(self.shutdown())
        return done
