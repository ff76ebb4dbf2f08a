"""Closed-loop rounds of the KWS stream scheduler
(``repro_torch.stream.StreamScheduler``).

Traffic parameters (``traffic/<mix>.json``): ``streams`` (the pool,
pinned), ``hop_frames``, ``backend``, ``bank_rows`` (the audio bank,
``inputs/kws.py``), ``warm_rounds``, ``trace_rounds``, ``check_streams``
and ``check_hops`` (the sample the check compares).  Set-up makes the
model and the bank from the seed, builds the scheduler, joins every
stream, lands its first push (prime and hop 1) and runs it, then
``warm_rounds`` rounds.  A round is one ``push_audio_batch`` of one hop
for every stream and one ``step_batch``; the window is rounds back to
back.

The check compares a sample of stream-hops drawn from the seed (every
sampled stream at the window's first and last hop and at random hops
between) with the reference run on the whole audio each stream had
consumed: the logits exactly, the posteriors within their limit.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.inputs import kws as kws_inputs

#: the scheduler's phase spans, named as the breakdown names them
PHASES = {"pack": "pack", "dispatch": "dispatch", "device": "fence",
          "detector": "fold", "push_fold": "fold"}


def port_spec(cfg: dict):
    """The program's ``CNN1DSpec`` of a KWS config file."""
    from repro_torch.core.cnn_spec import (CNN1DSpec, Conv1DSpec, FCSpec,
                                           GAPSpec)

    layers = []
    for lay in cfg["layers"]:
        if lay["type"] == "conv":
            layers.append(Conv1DSpec(
                lay["cin"], lay["cout"], k=lay["k"], stride=lay["stride"],
                pad=lay["pad"], pool=lay["pool"], in_bits=lay["in_bits"],
                in_offset=lay["in_offset"], name=lay["name"]))
        elif lay["type"] == "gap":
            layers.append(GAPSpec(lay["channels"], name=lay["name"]))
        else:
            layers.append(FCSpec(lay["cin"], lay["cout"],
                                 in_bits=lay["in_bits"],
                                 in_offset=lay["in_offset"],
                                 out_raw=lay["out_raw"], name=lay["name"]))
    return CNN1DSpec(in_len=cfg["in_len"], in_channels=cfg["in_channels"],
                     in_bits=cfg["in_bits"], layers=tuple(layers),
                     name=cfg["name"])


def hop_samples(cfg: dict, hop_frames: int) -> int:
    """Samples a hop consumes: ``hop_frames`` frames of the last conv,
    each its strides and pools of samples."""
    per = 1
    for lay in cfg["layers"]:
        if lay["type"] == "conv":
            per *= lay["stride"] * lay["pool"]
    return per * hop_frames


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict) -> None:
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.limits = limits
        self.n = traffic["streams"]
        self.hop = hop_samples(config, traffic["hop_frames"])
        self.attempted = self.failed = 0
        self.stats: dict = {}
        self.rng = np.random.default_rng([seed, 3])
        self.sampled = np.sort(self.rng.choice(
            self.n, min(self.n, traffic["check_streams"]), replace=False))
        self.record: dict[int, tuple] = {}   # bank row j -> (logits, post)
        self.round_s: list[float] = []
        self.push_s: list[float] = []
        self.spans: list[tuple[float, float, str]] | None = None
        self._picks: list[tuple[int, int, int]] | None = None

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.stream import StreamScheduler

        cfg, tr, n = self.cfg, self.traffic, self.n
        self.weights, self.thresholds = kws_inputs.random_model(
            cfg["layers"], self.seed, cfg["random_model"])
        self.sched = StreamScheduler(
            port_spec(cfg), self.weights, self.thresholds, capacity=n,
            initial_capacity=n, min_capacity=n,
            hop_frames=tr["hop_frames"], backend=tr["backend"],
            sample_rate=cfg["sample_rate"], device=self.device)
        plan = self.sched.plan
        if plan.hop_samples != self.hop:
            raise RuntimeError(f"the scheduler's hop is {plan.hop_samples} "
                               f"samples, the config's {self.hop}")
        self.prime = plan.prime_samples
        self.bank = kws_inputs.audio_bank(self.seed, tr["bank_rows"],
                                          self.hop)
        self.sids = list(range(n))
        for sid in self.sids:
            self.sched.add_stream(sid)
        self.sched.push_audio_batch(
            self.sids, kws_inputs.first_push(self.bank, n, self.prime))
        hb = self.sched.step_batch()
        if hb is None or len(hb.sids) != n:
            raise RuntimeError("the first hop did not run every stream")
        self.rows = np.empty(n, np.int64)
        self.rows[hb.sids] = np.arange(n)
        self.rows = self.rows[self.sampled]
        self.j = 2
        for _ in range(tr["warm_rounds"]):
            self._round()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _round(self) -> None:
        chunks = list(kws_inputs.round_chunks(self.bank, self.j, self.n))
        t0 = time.perf_counter()
        self.sched.push_audio_batch(self.sids, chunks)
        t1 = time.perf_counter()
        hb = self.sched.step_batch()
        t2 = time.perf_counter()
        self.round_s.append(t2 - t0)
        self.push_s.append(t1 - t0)
        if self.spans is not None:
            self.spans += [(t0, t1, "push"), (t1, t2, "step")]
        done = 0 if hb is None else len(hb.sids)
        self.failed += self.n - done
        if done == self.n:
            if not np.array_equal(hb.sids[self.rows], self.sampled):
                raise RuntimeError("the sampled streams left their rows")
            self.record[self.j] = (hb.logits[self.rows].copy(),
                                   hb.posteriors[self.rows].copy())
        self.j += 1

    # -- the window -----------------------------------------------------------

    def _phase_totals(self) -> dict:
        return {k: v["total_s"]
                for k, v in self.sched.metrics.phase_summary().items()}

    def window(self, seconds: float) -> None:
        from repro_torch.kernels import dispatch

        self.round_s.clear()
        self.push_s.clear()
        self.failed = 0
        self.first_j = self.j
        phases0 = self._phase_totals()
        with dispatch.counting() as launched:
            t_start = time.perf_counter()
            t = t_start
            while t - t_start < seconds:
                self._round()
                t = time.perf_counter()
            counts = launched()
        phases1 = self._phase_totals()
        rounds = self.j - self.first_j
        self.attempted = rounds * self.n
        host = sum(phases1[p] - phases0[p]
                   for p in ("pack", "dispatch", "detector"))
        self.stats = {
            "wall_s": t - t_start, "hops": rounds,
            "stream_hops": rounds * self.n,
            "audio_s": rounds * self.n * self.hop / self.cfg["sample_rate"],
            "hop_latency_s": list(self.round_s), "push_s": list(self.push_s),
            "host_phase_s": host, "launches": sum(counts.values()),
        }
        self.last_window_j = self.j - 1

    def traced(self) -> dict:
        from portbench import trace

        self.spans = []
        tracer = self.sched.obs.trace
        t_mark = time.perf_counter()
        tracer.add("portbench.epoch", t_mark, 0.0)
        epoch = t_mark - tracer.spans("portbench.epoch")[-1]["t0"]

        def host_spans():
            out = list(self.spans)
            for s in tracer.spans():
                name = PHASES.get(s["name"])
                if name is not None:
                    t0 = s["t0"] + epoch
                    out.append((t0, t0 + s["dur_s"], name))
            return out

        try:
            return trace.profile(self._round, self.traffic["trace_rounds"],
                                 host_spans)
        finally:
            self.spans = None

    def context(self) -> dict:
        return {"window": self.stats, "config": self.cfg,
                "traffic": self.traffic,
                "kws": {"layers": self.cfg["layers"], "hop": self.hop,
                        "streams": self.n,
                        "length": self.prime + self.j * self.hop,
                        "hop_kernel": self.traffic["hop_kernel"]}}

    # -- the check ------------------------------------------------------------

    def release(self) -> None:
        del self.sched
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[tuple[int, int, int]]:
        """(row in the sample, sid, bank row j) pairs the check compares:
        each sampled stream at the window's first and last hop and at
        ``check_hops - 2`` hops drawn between.  Drawn once."""
        if self._picks is not None:
            return self._picks
        js = sorted(self.record)
        lo = [j for j in js if self.first_j <= j <= self.last_window_j]
        picks = []
        for r, sid in enumerate(self.sampled.tolist()):
            mid = self.rng.choice(lo, min(len(lo), max(
                0, self.traffic["check_hops"] - 2)), replace=False)
            for j in sorted({lo[0], self.last_window_j, *mid.tolist()}):
                picks.append((r, sid, int(j)))
        self._picks = picks
        return picks

    def check(self, reference, control: bool = False) -> dict:
        """Logits that differ from the reference's (count of stream-hops)
        and the largest posterior error; with ``control`` the reference at
        4-bit inputs stands in the program's place."""
        mismatch, post_err, n = 0, 0.0, 0
        for r, sid, j in self.sample():
            audio = kws_inputs.stream_audio(self.bank, sid, self.n,
                                            self.prime, j)
            want = reference.forward(self.cfg["layers"], self.weights,
                                     self.thresholds, audio,
                                     device=self.device)["logits"]
            if control:
                got = reference.forward(self.cfg["layers"], self.weights,
                                        self.thresholds, audio,
                                        device=self.device,
                                        input_bits=4)["logits"]
                post = reference.posteriors(got)
            else:
                got = self.record[j][0][r]
                post = self.record[j][1][r]
            mismatch += int(not np.array_equal(got, want))
            post_err = max(post_err, float(np.abs(
                post - reference.posteriors(want)).max()))
            n += 1
        self.readings = {"logit_mismatch": mismatch, "post_err": post_err,
                         "compared": n}
        return {"logit_mismatch": {"value": mismatch,
                                   "limit": self.limits["logit_mismatch"]},
                "post_err": {"value": post_err,
                             "limit": self.limits["post_err"]}}
