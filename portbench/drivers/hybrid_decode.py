"""Decode ticks of the LM serving engine on a Jamba hybrid (Mamba,
attention and an MoE layer that holds a share of its experts).

The cell is ``lm_decode``'s: the same traffic parameters, set-up, window,
trace, release and check (the reference's ``hidden`` and ``gaps``).
Only the model differs: the port's ``ArchConfig`` is built from a
Jamba-style config file (``arch_config``), the weights come from
``inputs/jamba.py`` and are handed to the program as views
(``port_params``).  A program whose config has no published Jamba mixer
or no held share of the experts fails at the first step of set-up.
"""
from __future__ import annotations

from portbench.drivers import lm_decode
from portbench.inputs import jamba as jamba_inputs
from portbench.inputs import lm as lm_inputs

MAMBA_LEAVES = ("w_in", "conv_w", "conv_b", "w_x", "dt_norm", "b_norm",
                "c_norm", "w_dt", "dt_b", "a_log", "d_skip", "w_out")


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a Jamba config file: the layer pattern
    from the offset and period keys (one period is the superblock), the
    published Mamba mixer, the MoE over ``published_num_experts`` holding
    ``experts_held``, gates not renormalised.  Raises on a file whose
    settings the port's mixer or layers do not take (its dt rank is
    ``hidden_size // 16``)."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    period = cfg["attn_layer_period"]
    fixed = {"mamba_d_conv": 4, "rms_norm_eps": 1e-6, "hidden_act": "silu",
             "mamba_conv_bias": True, "mamba_proj_bias": False,
             "tie_word_embeddings": False,
             "mamba_dt_rank": max(1, cfg["hidden_size"] // 16)}
    bad = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if bad or cfg["num_hidden_layers"] % period \
            or period % cfg["expert_layer_period"]:
        raise ValueError(f"{cfg['name']}: the port runs {fixed} and whole "
                         f"periods of {period} layers; the file has {bad}")
    lo, hi = cfg["experts_held"]
    if hi - lo != cfg["num_experts"]:
        raise ValueError(f"{cfg['name']}: experts {lo}..{hi - 1} held, "
                         f"num_experts {cfg['num_experts']}")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return ArchConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        d_head=d // h, d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=0.0,
        superblock=tuple("a" if i == cfg["attn_layer_offset"] else "m"
                         for i in range(period)),
        moe=MoEConfig(
            n_experts=cfg["published_num_experts"],
            top_k=cfg["num_experts_per_tok"],
            d_expert=cfg["intermediate_size"],
            every_k=cfg["expert_layer_period"],
            layer_offset=cfg["expert_layer_offset"],
            held=(lo, hi), renorm_topk=False),
        d_state=cfg["mamba_d_state"], ssm_expand=cfg["mamba_expand"],
        mamba_variant="jamba",
        source=cfg["source"])


def port_params(raw: dict, cfg: dict) -> dict:
    """The program's parameter tree over the benchmark's tensors (views):
    superblock position ``pos`` of every period takes the ``j``-th layer
    of its kind in each period, a strided view of the kind's stack."""
    kinds = jamba_inputs.layer_kinds(cfg)[:cfg["attn_layer_period"]]
    per = {k: sum(k in pair for pair in kinds)
           for k in ("attn", "mamba", "dense", "moe")}
    seen = dict.fromkeys(per, 0)

    def take(kind, name):
        return raw[f"{kind}.{name}"][seen[kind]::per[kind]]

    blocks = []
    for mixer, ffn in kinds:
        block = {"norm1": take(mixer, "norm"), "norm2": take(ffn, "norm")}
        if mixer == "attn":
            block["attn"] = {k: take("attn", k)
                             for k in ("wq", "wk", "wv", "wo")}
        else:
            block["mamba"] = {k: take("mamba", k) for k in MAMBA_LEAVES}
        if ffn == "dense":
            block["mlp"] = {"wi_gate": take("dense", "w_gate"),
                            "wi_up": take("dense", "w_up"),
                            "wo": take("dense", "w_down")}
        else:
            block["moe"] = {"router": take("moe", "router"),
                            "wi_gate": take("moe", "e_gate"),
                            "wi_up": take("moe", "e_up"),
                            "wo": take("moe", "e_down")}
        seen[mixer] += 1
        seen[ffn] += 1
        blocks.append(block)
    return {"embed": raw["embed"], "out_norm": raw["final_norm"],
            "lm_head": raw["lm_head"], "head_layers": [], "blocks": blocks}


class Cell(lm_decode.Cell):
    def setup(self) -> None:
        from repro_torch.models import api
        from repro_torch.serve.engine import Engine, Request

        cfg, tr = self.cfg, self.traffic
        self.arch = arch_config(cfg)
        self.raw = jamba_inputs.make_weights(cfg, self.seed, self.device)
        params = port_params(self.raw, cfg)
        lm_decode.same_layout(params, api.init_params(self.arch,
                                                      device="meta"))
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
