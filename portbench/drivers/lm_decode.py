"""Decode ticks of the LM serving engine (``repro_torch.serve.engine``).

Traffic parameters (``traffic/<mix>.json``): ``slots`` (the pool, pinned),
``max_seq``, ``prompt_len``, ``max_new`` (so that no request finishes in
a run), ``warm_ticks``, ``trace_ticks``.  Set-up draws the weights on the
device (``inputs/lm.py``), builds the engine, submits one request a
slot with prompts from the seed, and runs one ``Engine.step`` (every
slot filled: each prompt prefilled alone, then the first tick) and
``warm_ticks`` more.  The window is ``Engine.step`` back to back: decode
ticks only, every slot live.

The check runs the reference once over every sequence with its served
tokens, teacher-forced and batched as the ticks were (rows in slot
order, as the engine reports the binding), and takes the widest gap by
which a served token's logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.inputs import lm as lm_inputs


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a DeepSeek-MoE-style config file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        d_head=d // h, d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        moe=MoEConfig(
            n_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            n_shared=cfg["n_shared_experts"],
            d_expert=cfg["moe_intermediate_size"],
            d_shared=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
            every_k=cfg["moe_layer_freq"],
            first_k_dense=cfg["first_k_dense_replace"]),
        source=cfg["source"])


def port_params(raw: dict, n_dense: int) -> dict:
    """The program's parameter tree over the benchmark's tensors (views)."""
    def attn(part, i=slice(None)):
        return {k: raw[f"{part}.{k}"][i] for k in ("wq", "wk", "wv", "wo")}

    head = [{"norm1": raw["dense.attn_norm"][i], "attn": attn("dense", i),
             "norm2": raw["dense.mlp_norm"][i],
             "mlp": {"wi_gate": raw["dense.w_gate"][i],
                     "wi_up": raw["dense.w_up"][i],
                     "wo": raw["dense.w_down"][i]}}
            for i in range(n_dense)]
    block = {"norm1": raw["moe.attn_norm"], "attn": attn("moe"),
             "norm2": raw["moe.mlp_norm"],
             "moe": {"router": raw["moe.router"],
                     "wi_gate": raw["moe.e_gate"], "wi_up": raw["moe.e_up"],
                     "wo": raw["moe.e_down"],
                     "shared": {"wi_gate": raw["moe.s_gate"],
                                "wi_up": raw["moe.s_up"],
                                "wo": raw["moe.s_down"]}}}
    return {"embed": raw["embed"], "out_norm": raw["final_norm"],
            "lm_head": raw["lm_head"], "head_layers": head,
            "blocks": [block]}


def same_layout(got, want, path="params") -> None:
    """Raise unless ``got`` has ``want``'s keys, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_layout(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise ValueError(f"{path}: {len(got)} entries != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_layout(g, w, f"{path}[{i}]")
    elif (tuple(got.shape), got.dtype) != (tuple(want.shape), want.dtype):
        raise ValueError(f"{path}: {tuple(got.shape)} {got.dtype} != "
                         f"{tuple(want.shape)} {want.dtype}")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict) -> None:
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.limits = limits
        self.slots = traffic["slots"]
        self.attempted = self.failed = 0
        self.stats: dict = {}
        self.tick_s: list[float] = []
        self.ticks = 0

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.models import api
        from repro_torch.serve.engine import Engine, Request

        cfg, tr = self.cfg, self.traffic
        self.arch = arch_config(cfg)
        self.raw = lm_inputs.make_weights(cfg, self.seed, self.device)
        params = port_params(self.raw, cfg["first_k_dense_replace"])
        same_layout(params, api.init_params(self.arch, device="meta"))
        self.prompts = lm_inputs.prompts(cfg, self.seed, self.slots,
                                         tr["prompt_len"])
        self.engine = Engine(self.arch, params, batch_slots=self.slots,
                             max_seq=tr["max_seq"])
        self.requests = [Request(rid=i, prompt=self.prompts[i],
                                 max_new_tokens=tr["max_new"])
                         for i in range(self.slots)]
        for r in self.requests:
            self.engine.submit(r)
        for _ in range(1 + tr["warm_ticks"]):
            self._tick()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tick(self) -> None:
        if self.engine.step():
            raise RuntimeError("a request finished inside the run: raise "
                               "max_new in the traffic file")
        self.ticks += 1

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> None:
        live = sum(r is not None for r in self.engine.slot_req)
        first = self.ticks
        t_start = time.perf_counter()
        t = t_start
        while t - t_start < seconds:
            self._tick()
            t_end = time.perf_counter()
            self.tick_s.append(t_end - t)
            t = t_end
        n = self.ticks - first
        self.attempted = n * live
        # the t-th tick (from 1) writes position prompt_len + t - 1 and
        # attends every position up to it
        pl = self.traffic["prompt_len"]
        self.stats = {"wall_s": t - t_start, "ticks": n, "rows": live,
                      "tokens": n * live, "tick_s": list(self.tick_s),
                      "contexts": [pl + first + 1 + i for i in range(n)]}

    def traced(self) -> dict:
        from portbench import trace

        spans: list[tuple[float, float, str]] = []
        tracer = self.engine.obs.trace
        t_mark = time.perf_counter()
        tracer.add("portbench.epoch", t_mark, 0.0)
        epoch = t_mark - tracer.spans("portbench.epoch")[-1]["t0"]

        def step():
            t0 = time.perf_counter()
            self._tick()
            spans.append((t0, time.perf_counter(), "fill"))

        def host_spans():
            out = list(spans)
            for s in tracer.spans("decode"):
                t0 = s["t0"] + epoch
                out.append((t0, t0 + s["dur_s"], "tick"))
            return out

        return trace.profile(step, self.traffic["trace_ticks"], host_spans)

    def context(self) -> dict:
        return {"window": self.stats, "config": self.cfg,
                "traffic": self.traffic}

    # -- the check ------------------------------------------------------------

    def release(self) -> None:
        """Keep what the check judges (each slot's request and its served
        tokens), free the program's state, keep the weights."""
        order = [r.rid for r in self.engine.slot_req]
        self.served = [list(self.requests[rid].out_tokens) for rid in order]
        self.slot_prompts = self.prompts[order]
        del self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sequences(self):
        n = min(len(s) for s in self.served)
        if n != max(len(s) for s in self.served):
            raise RuntimeError("the slots served different token counts")
        served = torch.as_tensor(np.array([s[:n] for s in self.served]),
                                 dtype=torch.long, device=self.device)
        prompts = torch.as_tensor(self.slot_prompts, dtype=torch.long,
                                  device=self.device)
        tokens = torch.cat([prompts, served[:, :-1]], 1)
        return tokens, served

    def check(self, reference, control: bool = False) -> dict:
        """The widest gap of a served token below the reference's best
        (with ``control``, of the token the fp8 reference puts first)."""
        tokens, served = self._sequences()
        pl = self.traffic["prompt_len"]
        cf = self.cfg["assumed"]["capacity_factor"]
        with torch.no_grad():
            h_ref = reference.hidden(self.raw, self.cfg, tokens, pl, cf)
            h_alt = (reference.hidden(self.raw, self.cfg, tokens, pl, cf,
                                      quant="fp8") if control else None)
            g = reference.gaps(self.raw, self.cfg, h_ref, served, pl - 1,
                               h_alt=h_alt, quant="fp8" if control else None)
        self.readings = g
        return {"max_gap": {"value": g["max_gap"],
                            "limit": self.limits["max_gap"]}}
