"""Recurrent blocks: xLSTM (mLSTM + sLSTM, arXiv:2405.04517) and Mamba (S6).

The port of the reference's ``repro/models/ssm.py``.  All three expose
the entry points the stack uses:
  *_train  : full-sequence
  *_prefill: full-sequence + the final recurrent state
  *_step   : O(1) single-token state update (decode)

mLSTM's prefill is the chunkwise-parallel linear-attention form (matrix
state C = sum_t f..f i_t v_t k_t^T), held against the step-by-step scan
(:func:`mlstm_prefill_sequential`); sLSTM is strictly sequential, a loop
over positions; Mamba's diagonal recurrence is scanned within chunks of
256 positions by a log-depth (Hillis-Steele) scan, and the state carried
across chunks.  The mLSTM and Mamba chunk steps are checkpointed
(``layers.checkpoint``, the reference's ``jax.checkpoint``): under a
gradient each chunk's intermediates are recomputed in the backward.  Every
state is float32.

The Mamba mixer also comes as the published Jamba mixer
(``init_mamba(variant="jamba")``: conv1d and dt_proj biases, RMSNorms on
dt, B and C after the x projection), which its functions apply where the
params hold those leaves; without them they are the reference's mixer op
for op.  Its prefill and step record the spans ``mamba.proj``,
``mamba.scan`` and ``mamba.out`` (``obs.span``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.scan_utils import scan
from repro_torch.obs import span
from repro_torch.sharding import act


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus``; on DTensors under a sharding policy (the dry run)
    the same function from pointwise ops, whose sharding rules keep the
    layout where ``softplus_backward``'s gathers the whole tensor."""
    if act.sharded(x):
        return torch.where(x > 20.0, x,
                           torch.log1p(torch.exp(torch.clamp(x, max=20.0))))
    return F.softplus(x)


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on DTensors, ``-softplus(-x)`` as above
    (``log_sigmoid_forward`` has no sharding rule)."""
    if act.sharded(x):
        return -_softplus(-x)
    return F.logsigmoid(x)


def _up_split(x, w, d_inner: int):
    """The fused up-projection's two halves: ``x @ w`` split at
    ``d_inner``; on DTensors under a policy, ``x`` times each column
    block of ``w`` (``act.split_columns``), so that each half keeps its
    channels over TP where slicing the product would gather it."""
    if act.sharded(x):
        w_a, w_b = act.split_columns(act.gather_dp(w), d_inner)
        return _mm(x, w_a), _mm(x, w_b)
    up = _mm(x, w)
    return up[..., :d_inner], up[..., d_inner:]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16, the reference's ``x.astype(bf16) @ w``."""
    return act.matmul(x, w, layers.matmul_bf16)


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM): linear attention with scalar forget/input gates
# ---------------------------------------------------------------------------

def init_mlstm(generator, d_model: int, n_heads: int, expand: int = 2, *,
               device, lead=()) -> dict:
    d_inner = expand * d_model
    return {
        "w_up": layers.dense_init(generator, d_model, 2 * d_inner,
                                  device=device, lead=lead),
        "w_qkv": layers.dense_init(generator, d_inner, 3 * d_inner,
                                   device=device, lead=lead),
        "w_if": layers.dense_init(generator, d_inner, 2 * n_heads,
                                  device=device, lead=lead,
                                  dtype=torch.float32),
        "w_out": layers.dense_init(generator, d_inner, d_model,
                                   device=device, lead=lead),
        "skip_gamma": layers.ones((*lead, d_inner), device),
    }


def _mlstm_gates(p, xi, n_heads):
    """xi (B,S,Di) -> per-head log input / forget gates (B,S,H) float32."""
    g = act.matmul(xi.to(torch.float32), p["w_if"])
    return g[..., :n_heads], _logsigmoid(g[..., n_heads:])


def _mlstm_qkv(p, x, n_heads, expand):
    """-> q, k, v (B,S,H,dk) float32 (q scaled), the gates, the output
    gate branch zg and d_inner."""
    b, s, d = x.shape
    d_inner = expand * d
    xi, zg = _up_split(x, p["w_up"], d_inner)
    qkv = _mm(xi, p["w_qkv"])
    dk = d_inner // n_heads
    q, k, v = (act.reshape(t, b, s, n_heads, dk).to(torch.float32)
               for t in torch.split(qkv, d_inner, dim=-1))
    q = q / math.sqrt(dk)
    i_log, f_log = _mlstm_gates(p, xi, n_heads)
    return q, k, v, i_log, f_log, zg, d_inner


def _mlstm_out(p, h, zg, d_inner):
    b, s = h.shape[:2]
    h = act.reshape(h, b, s, d_inner).to(COMPUTE_DTYPE)
    h = h * F.silu(zg.to(torch.float32)).to(COMPUTE_DTYPE)
    return _mm(h, p["w_out"])


def _mlstm_cell(c, n, m, qt, kt, vt, il, fl):
    """One stabilised step (xLSTM eq. 15-19): qt/kt/vt (B,H,dk), gates
    (B,H) -> (new c, n, m), out (B,H,dv)."""
    m_new = torch.maximum(fl + m, il)
    decay = torch.exp(fl + m - m_new)
    inp = torch.exp(il - m_new)
    c = c * decay[..., None, None] + inp[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])
    n = n * decay[..., None] + inp[..., None] * kt
    denom = torch.maximum(torch.abs(torch.sum(n * qt, dim=-1)),
                          torch.exp(-m_new))
    out = torch.einsum("bhk,bhkv->bhv", qt, c) / denom[..., None]
    return (c, n, m_new), out


def _mlstm_zero_state(b, h, dk, dv, device):
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h), dtype=torch.float32, device=device))


def _mlstm_scan(q, k, v, i_log, f_log):
    """The recurrent reference: per-step state C (B,H,Dk,Dv), n (B,H,Dk),
    running max m (B,H)."""
    b, s, h, dk = q.shape
    state = _mlstm_zero_state(b, h, dk, v.shape[-1], q.device)
    outs = []
    for t in range(s):
        state, out = _mlstm_cell(*state, q[:, t], k[:, t], v[:, t],
                                 i_log[:, t], f_log[:, t])
        outs.append(out)
    return torch.stack(outs, dim=1), state


def _mlstm_chunk_parallel(q, k, v, i_log, f_log, chunk: int = 256):
    """Chunkwise-parallel mLSTM (GLA-style): intra-chunk quadratic products
    and the inter-chunk matrix-state recurrence, in float32 with the
    running max lifted to chunk granularity; ``-inf`` masks the upper
    triangle of the log-weights.  On DTensors under a sharding policy
    each device scans its own sequences (and heads, where TP divides
    them)."""
    if act.sharded(q):
        bx, _, hx = act.logical_spec(q.shape, "dp", None, "tp")
        pl4 = act.spec_placements(4, bx, None, hx)
        pl3 = act.spec_placements(3, bx, None, hx)
        st = (act.spec_placements(4, bx, hx), act.spec_placements(3, bx, hx),
              act.spec_placements(2, bx, hx))

        def local(*a):
            out, state = _mlstm_chunk_parallel(*a, chunk=chunk)
            return (out, *state)

        out, *state = act.shard_map(
            local, (q, k, v, i_log, f_log), (pl4, pl4, pl4, pl3, pl3),
            (pl4, *st))
        return out, tuple(state)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    if s % c:
        c = s
    n_chunks = s // c

    def resh(t):
        return torch.movedim(t.reshape(b, n_chunks, c, *t.shape[2:]), 1, 0)

    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    tri4 = tri[None, :, :, None]

    def chunk_step(carry, xs):
        C_in, n_in, m_in = carry
        qc, kc, vc, ic, fc = xs
        Fc = torch.cumsum(fc, dim=1)            # inclusive logsum of forgets
        T = Fc[:, -1]                           # (B,H)
        a = Fc + m_in[:, None]                  # inter, per t
        w = Fc[:, :, None] - Fc[:, None, :] + ic[:, None]   # (B,t,s,H)
        w = torch.where(tri4, w, -math.inf)
        u = T[:, None] - Fc + ic                # state update, per s
        m_intra = w.amax(dim=2)
        m_t = torch.maximum(a, m_intra)
        inter_w = torch.exp(a - m_t)
        intra = torch.exp(w - m_t[:, :, None])
        intra = torch.where(tri4, intra, 0.0)
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * intra
        out = torch.einsum("btsh,bshv->bthv", scores, vc)
        out = out + inter_w[..., None] * torch.einsum("bthd,bhdv->bthv", qc,
                                                      C_in)
        nvec = torch.einsum("btsh,bshd->bthd", intra, kc)
        nvec = nvec + inter_w[..., None] * n_in[:, None]
        denom = torch.maximum(
            torch.abs(torch.einsum("bthd,bthd->bth", qc, nvec)),
            torch.exp(-m_t))
        out = out / denom[..., None]
        m_out = torch.maximum(m_in + T, u.amax(dim=1))
        su = torch.exp(u - m_out[:, None])
        carry_decay = torch.exp(m_in + T - m_out)
        C_out = carry_decay[:, :, None, None] * C_in + torch.einsum(
            "bshd,bshv->bhdv", su[..., None] * kc, vc)
        n_out = carry_decay[:, :, None] * n_in + torch.einsum(
            "bsh,bshd->bhd", su, kc)
        return (C_out, n_out, m_out), out

    state0 = _mlstm_zero_state(b, h, dk, dv, q.device)
    state, outs = scan(functools.partial(layers.checkpoint, chunk_step),
                       state0, tuple(
        resh(t) for t in (q, k, v, i_log, f_log)))
    return torch.movedim(outs, 0, 1).reshape(b, s, h, dv), state


def mlstm_prefill(p, x, *, n_heads: int, expand: int = 2, chunk: int = 256):
    q, k, v, i_log, f_log, zg, d_inner = _mlstm_qkv(p, x, n_heads, expand)
    h, state = _mlstm_chunk_parallel(q, k, v, i_log, f_log, chunk=chunk)
    return _mlstm_out(p, h, zg, d_inner), state


def mlstm_train(p, x, *, n_heads: int, expand: int = 2):
    return mlstm_prefill(p, x, n_heads=n_heads, expand=expand)[0]


def mlstm_prefill_sequential(p, x, *, n_heads: int, expand: int = 2):
    """Step-by-step reference (the chunked path is held against it)."""
    q, k, v, i_log, f_log, zg, d_inner = _mlstm_qkv(p, x, n_heads, expand)
    h, state = _mlstm_scan(q, k, v, i_log, f_log)
    return _mlstm_out(p, h, zg, d_inner), state


def mlstm_step(p, x, state, *, n_heads: int, expand: int = 2):
    """x (B,1,D) + state -> (out (B,1,D), new state).  O(1) in context."""
    q, k, v, i_log, f_log, zg, d_inner = _mlstm_qkv(p, x, n_heads, expand)
    state, out = _mlstm_cell(*state, q[:, 0], k[:, 0], v[:, 0],
                             i_log[:, 0], f_log[:, 0])
    return _mlstm_out(p, out[:, None], zg, d_inner), state


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     expand: int = 2, *, device, lead=()):
    """(C (B,H,dk,dk), n (B,H,dk), m (B,H)), zeros, float32."""
    dk = expand * d_model // n_heads
    return tuple(torch.zeros((*lead, *shape), dtype=torch.float32,
                             device=device)
                 for shape in ((batch, n_heads, dk, dk), (batch, n_heads, dk),
                               (batch, n_heads)))


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating)
# ---------------------------------------------------------------------------

def init_slstm(generator, d_model: int, n_heads: int = 0, *, device,
               lead=()) -> dict:
    return {
        "w_in": layers.dense_init(generator, d_model, 4 * d_model,
                                  device=device, lead=lead,
                                  dtype=torch.float32),
        "r_in": layers.dense_init(generator, d_model, 4 * d_model,
                                  device=device, lead=lead,
                                  dtype=torch.float32),
        "w_out": layers.dense_init(generator, d_model, d_model,
                                   device=device, lead=lead),
    }


def slstm_init_state(batch: int, d_model: int, *, device):
    """(c, h, n, m) (B,D) float32: zeros, but n starts at 1e-6."""
    z = [torch.zeros((batch, d_model), dtype=torch.float32, device=device)
         for _ in range(4)]
    z[2] += 1e-6
    return tuple(z)


def _slstm_cell(p, xt, state):
    c, h, n, m = state
    pre = act.matmul(xt.to(torch.float32), p["w_in"]) \
        + act.matmul(h, p["r_in"])                         # (B,4D)
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    i_log, f_log = ii, _logsigmoid(fi)
    m_new = torch.maximum(f_log + m, i_log)
    decay = torch.exp(f_log + m - m_new)
    inp = torch.exp(i_log - m_new)
    c = c * decay + inp * z
    n = n * decay + inp
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, h_new, n, m_new), h_new


def slstm_prefill(p, x, *, n_heads: int = 0):
    b, s, d = x.shape
    state = slstm_init_state(b, d, device=x.device)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, x[:, t], state)
        hs.append(h)
    out = _mm(torch.stack(hs, dim=1), p["w_out"])
    return out, state


def slstm_train(p, x, *, n_heads: int = 0):
    return slstm_prefill(p, x)[0]


def slstm_step(p, x, state, *, n_heads: int = 0):
    state, h = _slstm_cell(p, x[:, 0], state)
    return _mm(h, p["w_out"])[:, None], state


# ---------------------------------------------------------------------------
# Mamba (S6 selective SSM): jamba's recurrent layer
# ---------------------------------------------------------------------------

def init_mamba(generator, d_model: int, d_state: int = 16, d_conv: int = 4,
               expand: int = 2, dt_rank: int | None = None, *, device,
               lead=(), variant: str = "plain") -> dict:
    """``conv_w``, ``w_dt``, ``a_log`` = log(1..N) per channel and
    ``d_skip`` are float32; the three projections bf16.  ``variant``
    ``"jamba"`` adds the published Jamba mixer's leaves, all float32: the
    conv1d bias ``conv_b`` and the dt_proj bias ``dt_b`` (Di,), and the
    gains of the RMSNorms on dt, B and C after ``w_x`` (``dt_norm`` (R,),
    ``b_norm`` / ``c_norm`` (N,)); the mixer's functions apply them where
    the params hold them."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    lead = tuple(lead)
    device = torch.device(device)
    if device.type == "meta":
        a_log = torch.empty((*lead, d_inner, d_state), dtype=torch.float32,
                            device=device)
    else:
        a_log = torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=device)).expand(
                *lead, d_inner, d_state).contiguous()
    p = {
        "w_in": layers.dense_init(generator, d_model, 2 * d_inner,
                                  device=device, lead=lead),
        "conv_w": layers.normal(generator, (*lead, d_conv, d_inner), 0.1,
                                device, torch.float32),
        "w_x": layers.dense_init(generator, d_inner, dt_rank + 2 * d_state,
                                 device=device, lead=lead),
        "w_dt": layers.dense_init(generator, dt_rank, d_inner, device=device,
                                  lead=lead, dtype=torch.float32),
        "a_log": a_log,
        "d_skip": layers.ones((*lead, d_inner), device),
        "w_out": layers.dense_init(generator, d_inner, d_model,
                                   device=device, lead=lead),
    }
    if variant == "jamba":
        # dt_proj's bias about the published init's softplus^-1 of dt in
        # [1e-3, 1e-1]
        p.update(
            conv_b=layers.normal(generator, (*lead, d_inner), 0.1, device,
                                 torch.float32),
            dt_b=layers.normal(generator, (*lead, d_inner), 1.0, device,
                               torch.float32) - 4.0,
            dt_norm=layers.ones((*lead, dt_rank), device),
            b_norm=layers.ones((*lead, d_state), device),
            c_norm=layers.ones((*lead, d_state), device))
    elif variant != "plain":
        raise ValueError(f"unknown Mamba variant {variant!r}")
    return p


def _scan_chunk(da, x_in):
    """Inclusive scan of the recurrence s_t = da_t * s_{t-1} + x_t along
    axis 1 -> (cumulative decay, cumulative input): log2(c) passes of
    ``(a_l, x_l) o (a_r, x_r) = (a_l a_r, x_r + a_r x_l)`` at doubling
    offsets (Hillis-Steele).  The order of combination differs from XLA's
    ``associative_scan``, so the float32 results differ in the last bits."""
    c = da.shape[1]
    off = 1
    while off < c:
        a_r, x_r = da[:, off:], x_in[:, off:]
        a_l, x_l = da[:, :-off], x_in[:, :-off]
        x_in = torch.cat([x_in[:, :off], x_r + a_r * x_l], dim=1)
        da = torch.cat([da[:, :off], a_l * a_r], dim=1)
        off *= 2
    return da, x_in


def _mamba_ssm_scan(u, dt, a, b_in, c_in, d_skip, chunk: int = 256):
    """The selective scan: u (B,S,Di), dt (B,S,Di), a (Di,N), b_in / c_in
    (B,S,N) -> y (B,S,Di), final state (B,Di,N).  Chunks bound the
    materialised (B,chunk,Di,N) decay tensor; the state crosses chunks
    through the cumulative decay.  On DTensors under a sharding policy
    each device scans its own channels (the scan is channel-wise)."""
    if act.sharded(u):
        bx, _, dx = _bsd_axes(u)
        pl_bsd = act.spec_placements(3, bx, None, dx)
        pl_bsn = act.spec_placements(3, bx)
        pl_dn = act.spec_placements(2, dx)
        pl_d = act.spec_placements(1, dx)
        pl_bdn = act.spec_placements(3, bx, dx)
        return act.shard_map(
            functools.partial(_mamba_ssm_scan, chunk=chunk),
            (u, dt, a, b_in, c_in, d_skip),
            (pl_bsd, pl_bsd, pl_dn, pl_bsn, pl_bsn, pl_d), (pl_bsd, pl_bdn))
    b, s, di = u.shape
    c = min(chunk, s)
    if s % c:
        c = s
    nc = s // c

    def resh(t):
        return torch.movedim(t.reshape(b, nc, c, *t.shape[2:]), 1, 0)

    def chunk_step(state, xs):
        u_c, dt_c, b_c, c_c = xs
        da = torch.exp(dt_c[..., None] * a[None, None])          # (B,c,Di,N)
        x_in = dt_c[..., None] * b_c[:, :, None, :] * u_c[..., None]
        cum_a, cum_x = _scan_chunk(da, x_in)
        xs_full = cum_x + cum_a * state[:, None]
        y = torch.einsum("bcdn,bcn->bcd", xs_full, c_c)
        return xs_full[:, -1], y

    state0 = torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                         device=u.device)
    state, ys = scan(functools.partial(layers.checkpoint, chunk_step),
                     state0, tuple(resh(t) for t in (u, dt, b_in, c_in)))
    y = torch.movedim(ys, 0, 1).reshape(b, s, di)
    return y + u * d_skip[None, None], state


def _bsd_axes(u):
    """(batch, None, channel) mesh axes for a (B, S, Di) activation under
    the policy: the batch over DP and the channels over TP, each where it
    divides."""
    return act.logical_spec(u.shape, "dp", None, "tp")


def _mamba_proj(p, xc, d_state):
    """xc (..., Di) float32 -> dt (softplus, float32), B, C (float32).
    The published Jamba mixer (``dt_norm`` in ``p``) RMS-normalises dt's
    low-rank part, B and C and adds the dt_proj bias before the softplus.
    Under a sharding policy the small projection is summed over TP
    (``w_x`` is row-parallel) and dt keeps the channels over TP."""
    proj = act.constrain(_mm(xc, p["w_x"]), "dp", None, None)
    dt_rank = p["w_dt"].shape[0]
    dt_r = proj[..., :dt_rank].to(torch.float32)
    b_in = proj[..., dt_rank:dt_rank + d_state].to(torch.float32)
    c_in = proj[..., dt_rank + d_state:].to(torch.float32)
    dt = act.matmul(_jamba_norm(p, "dt_norm", dt_r), p["w_dt"])
    if "dt_b" in p:
        dt = dt + p["dt_b"]
    dt = _softplus(dt)
    return (act.constrain(dt, "dp", None, "tp"),
            _jamba_norm(p, "b_norm", b_in), _jamba_norm(p, "c_norm", c_in))


def _jamba_norm(p, name, x):
    """The published mixer's RMSNorm ``name`` of x (float32), where the
    params hold its gain; else x."""
    return layers.rmsnorm(x, p[name]) if name in p else x


def _mamba_gate_out(p, y, zg):
    y = y.to(COMPUTE_DTYPE) * F.silu(zg.to(torch.float32)).to(COMPUTE_DTYPE)
    return _mm(y, p["w_out"])


def mamba_prefill(p, x, *, d_state: int = 16, d_conv: int = 4,
                  expand: int = 2):
    """-> out (B,S,D), (final ssm state (B,Di,N), causal-conv tail
    (B,d_conv-1,Di): the last d_conv-1 inputs, zero-padded).  Spans
    ``mamba.proj``, ``mamba.scan``, ``mamba.out``."""
    b, s, d = x.shape
    d_inner = expand * d
    with span("mamba.proj"):
        xi, zg = _up_split(x, p["w_in"], d_inner)
        xc, tail = _causal_conv(xi.to(torch.float32), p["conv_w"], d_conv,
                                p.get("conv_b"))
        dt, b_in, c_in = _mamba_proj(p, xc, d_state)
    with span("mamba.scan"):
        a = -torch.exp(p["a_log"])
        y, ssm_state = _mamba_ssm_scan(xc, dt, a, b_in, c_in, p["d_skip"])
    with span("mamba.out"):
        out = _mamba_gate_out(p, y, zg)
    return out, (ssm_state, tail)


def _causal_conv(xi, conv_w, d_conv, conv_b=None):
    """silu of the depthwise causal conv (d_conv taps, summed tap by tap,
    plus ``conv_b`` where given) of xi (B,S,Di) float32, and the conv tail
    (the last d_conv-1 inputs, zero-padded).  On DTensors under a policy
    each device convolves its own channels."""
    if act.sharded(xi):
        bx, _, dx = _bsd_axes(xi)
        pl = act.spec_placements(3, bx, None, dx)
        bias = () if conv_b is None else (conv_b,)
        return act.shard_map(
            lambda x, w, *bl: _causal_conv(x, w, d_conv, *bl),
            (xi, conv_w, *bias),
            (pl, act.spec_placements(2, None, dx),
             *(act.spec_placements(1, dx) for _ in bias)), (pl, pl))
    s = xi.shape[1]
    xpad = F.pad(xi, (0, 0, d_conv - 1, 0))
    conv = sum(xpad[:, t:t + s] * conv_w[t][None, None]
               for t in range(d_conv))
    if conv_b is not None:
        conv = conv + conv_b
    return F.silu(conv), xpad[:, -(d_conv - 1):]


def mamba_train(p, x, *, d_state: int = 16, d_conv: int = 4,
                expand: int = 2):
    return mamba_prefill(p, x, d_state=d_state, d_conv=d_conv,
                         expand=expand)[0]


def mamba_init_state(batch: int, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, *, device, lead=()):
    """(ssm state (B,Di,N), conv tail (B,d_conv-1,Di)), zeros, float32."""
    d_inner = expand * d_model
    return (torch.zeros((*lead, batch, d_inner, d_state),
                        dtype=torch.float32, device=device),
            torch.zeros((*lead, batch, d_conv - 1, d_inner),
                        dtype=torch.float32, device=device))


def mamba_step(p, x, state, *, d_state: int = 16, d_conv: int = 4,
               expand: int = 2):
    """Single-token Mamba update: O(1) state, the long-context decode.
    Spans ``mamba.proj``, ``mamba.scan``, ``mamba.out``."""
    d_inner = expand * x.shape[-1]
    ssm_state, conv_tail = state
    with span("mamba.proj"):
        xi, zg = _up_split(x, p["w_in"], d_inner)
        window = torch.cat([conv_tail, xi.to(torch.float32)], dim=1)
        conv = torch.einsum("btd,td->bd", window, p["conv_w"])
        if "conv_b" in p:
            conv = conv + p["conv_b"]
        xc = F.silu(conv)
        dt, b_in, c_in = _mamba_proj(p, xc, d_state)
    with span("mamba.scan"):
        a = -torch.exp(p["a_log"])
        da = torch.exp(dt[..., None] * a[None])
        ssm_state = ssm_state * da + dt[..., None] * b_in[:, None, :] * \
            xc[..., None]
        y = torch.einsum("bdn,bn->bd", ssm_state, c_in) + \
            xc * p["d_skip"][None]
    with span("mamba.out"):
        out = _mamba_gate_out(p, y, zg[:, 0])[:, None]
    return out, (ssm_state, window[:, 1:])
