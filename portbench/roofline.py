"""The yardstick's arithmetic: the chip's published peaks, and the
operations and bytes of each unit of work, from the configuration files.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
sparsity, at its 700 W limit): 3.35 TB/s of HBM, 1,979 TOP/s int8,
989 TFLOP/s bf16.  A share of a peak is stated against these, with the
card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989e12


# ---------------------------------------------------------------------------
# KWS: one emit hop of the stream model (the hop kernel's work)
# ---------------------------------------------------------------------------

def kws_geometry(layers: list[dict], length: int, hop_samples: int
                 ) -> list[dict]:
    """Per conv layer of a stream that has consumed ``length`` samples, at
    a hop boundary: the positions a hop convolves in steady state
    (``n_conv``), the positions the ghost flush convolves (``flush``: those
    whose window reaches the right pad or a frame the flush itself made),
    and the state a stream carries (``tail`` input frames the next settled
    position needs, ``phase`` settled outputs waiting for their pool
    partner).

    Worked out from the offline model on the prefix: a position is
    settled when its window lies inside the real (settled) input; a
    pooled output is settled when its whole pool window is."""
    out = []
    real, ghost, n_in = length, 0, hop_samples
    for lay in layers:
        if lay["type"] != "conv":
            continue
        k, s, pad, pool = lay["k"], lay["stride"], lay["pad"], lay["pool"]
        total = (real + ghost + 2 * pad - k) // s + 1
        settled = max(0, (real + pad - k) // s + 1)
        n_conv = n_in // s
        out.append(dict(name=lay["name"], k=k, cin=lay["cin"],
                        cout=lay["cout"], n_conv=n_conv,
                        flush=total - settled,
                        tail=real - (settled * s - pad),
                        phase=settled % pool))
        real, ghost = settled // pool, total // pool - settled // pool
        n_in = n_conv // pool
    return out


def kws_state_values(layers: list[dict], length: int,
                     hop_samples: int) -> int:
    """Values a stream's state holds between hops: every layer's tail and
    pending outputs, and the GAP counters."""
    geo = kws_geometry(layers, length, hop_samples)
    gap = sum(l["channels"] for l in layers if l["type"] == "gap")
    return sum(g["tail"] * g["cin"] + g["phase"] * g["cout"]
               for g in geo) + gap


def kws_hop_macs(layers: list[dict], length: int, hop_samples: int,
                 emit: bool = True) -> int:
    """MACs of one stream's hop that ends at ``length`` consumed samples:
    every conv position the hop advances, and with ``emit`` the ghost
    flush's positions and the fc cascade."""
    macs = 0
    for st in kws_geometry(layers, length, hop_samples):
        per = st["k"] * st["cin"] * st["cout"]
        macs += st["n_conv"] * per
        if emit:
            macs += st["flush"] * per
    if emit:
        macs += sum(l["cin"] * l["cout"] for l in layers
                    if l["type"] == "fc")
    return macs


def kws_hop_bytes(layers: list[dict], hop_samples: int, streams: int,
                  state_values: int) -> int:
    """Bytes one emit hop over ``streams`` must move, each read once and
    each written once: the int32 audio and mask in, the int32 state in
    and out (``state_values`` a stream), the model's weights (int8),
    thresholds (float32) and flips (int32), and the int32 logits out."""
    weights = 0
    n_cls = 0
    for lay in layers:
        if lay["type"] == "conv":
            weights += lay["k"] * lay["cin"] * lay["cout"] + 8 * lay["cout"]
        elif lay["type"] == "fc":
            weights += lay["cin"] * lay["cout"] + 8 * lay["cout"]
            n_cls = lay["cout"]
    per_stream = 4 * hop_samples + 4 + 2 * 4 * state_values + 4 * n_cls
    return streams * per_stream + weights


def kws_hop_bound_s(layers: list[dict], length: int, hop_samples: int,
                    streams: int) -> tuple[float, str]:
    """Least time of one emit hop over ``streams`` on the card, each
    ending at ``length`` consumed samples: the larger of its bytes over
    HBM's rate and its int8 operations (2 a MAC) over the int8 peak; and
    which of the two bounds it."""
    t_ops = 2 * kws_hop_macs(layers, length, hop_samples) * streams \
        / INT8_OPS_PER_S
    t_bytes = kws_hop_bytes(layers, hop_samples, streams,
                            kws_state_values(layers, length, hop_samples)) \
        / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# LM: one decode token of a decoder with attention and (MoE) FFNs
# ---------------------------------------------------------------------------

def lm_token_flops(cfg: dict, context: int) -> float:
    """FLOPs (2 a MAC) of one decode token at ``context`` positions
    attended: every projection it uses (the top-k routed and the shared
    experts of a MoE layer, the router, the head) and attention's two
    products over the positions it attends."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    dh = d // heads
    layers = cfg["num_hidden_layers"]
    dense_layers = cfg.get("first_k_dense_replace", layers)
    attn_params = d * heads * dh * 2 + d * kv * dh * 2
    dense_ffn = 3 * d * cfg["intermediate_size"]
    moe_ffn = 3 * d * cfg["moe_intermediate_size"] * (
        cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) \
        + d * cfg["n_routed_experts"]
    params = layers * attn_params + dense_layers * dense_ffn \
        + (layers - dense_layers) * moe_ffn + d * cfg["vocab_size"]
    attn = layers * 2 * heads * dh * context
    return 2.0 * (params + attn)
