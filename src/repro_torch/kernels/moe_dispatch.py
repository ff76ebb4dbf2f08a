"""The decode-sized dropping MoE dispatch of one layer as CUDA kernels on
Hopper: route and rank, the held experts' gate/up and down products on
their buckets, and the combine, in four launches and one host call.

It replaces no Pallas kernel: the JAX package's MoE
(``repro/models/moe.py``) is plain ``jnp``, which XLA fuses on the TPU,
while eager PyTorch ran the same dispatch as ~200 launches a layer, and
the LM decode tick waited on the host's issue.  On the card the layer is
bound by its weights' bytes: every held expert's ``wi_gate``, ``wi_up``
and ``wo`` is read once a call, whatever the routing (E_held x 3 x D x F
bf16), against at most ``MAX_ROWS`` bucket rows, far below the
operations a byte at which the tensor cores would bound it.  The design
answers that in ``csrc/moe_dispatch.cu``: each weight tile streams once
through a ``cp.async`` ring in shared memory, the bucket rows are padded
to the MMA's 16 and multiplied by ``mma.sync`` (bf16 products, float32
accumulators), and the routing, ranking and combine, a few kilobytes,
take one kernel before and one after.

The kernels run on CUDA tensors alone, on the current stream; a build
or launch failure raises, there is no fallback.  The pure host function
:func:`plan` picks what the launch takes from ``(E_held, C, D, F,
N*K)``; the C call derives every grid and shared-memory size from it.
Every call that :func:`engages` refuses, the CPU's among them, keeps
``models/moe.py``'s ``route`` and ``dispatch_dropping`` (the plain
version), unchanged.

The kernels compute what ``moe.apply_moe`` computes with
``impl="dropping"`` on local tensors: the router in float32 with no
TF32, the top-k of a stable descending sort, capacity positions
slot-major over all E, a share ``held=(lo, hi)`` of the experts, the
experts in bf16 with float32 accumulation rounded where ``moe._swiglu``
rounds, the combine in float32 in slot order, and the shared experts by
``layers.apply_mlp``.  Their results differ from the plain version's by
the GEMMs' order of accumulation alone; the routing, positions, keep
masks and counts are equal.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.obs import span

SOURCE = "moe_dispatch"
KERNEL = "moe_dispatch"
#: N*K pairs the single-pass ranking takes (one warp over them, their
#: experts in shared memory); covers N <= 682 tokens at K = 6
MAX_PAIRS = 4096
#: bucket rows C: four 16-row MMA tiles
MAX_ROWS = 64
#: experts E the router takes (one thread an expert)
MAX_EXPERTS = 256
#: D rows one route block sums, and its threads
ROUTE_ROWS = 256
ROUTE_THREADS = 256
#: the workspace's buffers in the launch function's order, and each
#: buffer's start rounded up to this many bytes
_WS = ("xb", "partial", "probs", "gate", "idx", "pos", "keep", "counts",
       "table", "aux", "h", "y")
_ALIGN = 256
_WEIGHTS = ("router", "wi_gate", "wi_up", "wo")


# ---------------------------------------------------------------------------
# The launch plan (pure host functions)
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """What one layer call's launch takes: ``mt`` 16-row MMA tiles a
    bucket (the GEMMs' template); the route kernel's D rows a block, its
    blocks a token (the workspace's partial sums) and its shared memory
    (bytes)."""
    mt: int
    route_rows: int
    route_splits: int
    route_smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(e_held: int, cap: int, d: int, f: int, pairs: int) -> Plan:
    """What the launch takes for a call with ``e_held`` experts, capacity
    ``cap``, model width ``d``, expert width ``f`` and ``pairs`` = N*K
    (token, slot) pairs.  Raises ``ValueError`` outside the limits the
    kernels take."""
    if not 1 <= cap <= MAX_ROWS:
        raise ValueError(f"capacity {cap}: the buckets take 1-{MAX_ROWS} "
                         "rows")
    if not 1 <= pairs <= MAX_PAIRS:
        raise ValueError(f"{pairs} (token, slot) pairs: the ranking takes "
                         f"1-{MAX_PAIRS}")
    if d % 8 or f % 8:
        raise ValueError(f"D={d}, F={f}: the kernels copy rows 8 bf16 at a "
                         "time")
    mt = _cdiv(cap, 16)
    rows = min(ROUTE_ROWS, d)
    # the route blocks' rows and partial sums, or the ranking's experts,
    # counts and partial sums
    smem = 4 * max(rows, pairs + MAX_EXPERTS) + 4 * ROUTE_THREADS
    return Plan(mt, rows, _cdiv(d, rows), smem)


@functools.lru_cache(maxsize=None)
def _layout(n: int, d: int, f: int, e: int, k: int, cap: int, held: int,
            splits: int) -> tuple[dict, int]:
    """-> (each workspace buffer's byte offset, the workspace's bytes)."""
    sizes = dict(xb=n * d * 2, partial=n * splits * e * 4, probs=n * e * 4,
                 gate=n * k * 4, idx=n * k * 8, pos=n * k * 8, keep=n * k,
                 counts=e * 8, table=held * cap * 4, aux=4,
                 h=held * cap * f * 2, y=held * cap * d * 2)
    offsets, at = {}, 0
    for name in _WS:
        offsets[name] = at
        at += _cdiv(sizes[name], _ALIGN) * _ALIGN
    return offsets, at


def capacity(n: int, top_k: int, e: int, capacity_factor: float) -> int:
    """The dropping dispatch's static capacity, as
    ``moe.dispatch_dropping`` computes it."""
    return max(1, int(n * top_k / e * capacity_factor))


# ---------------------------------------------------------------------------
# Which calls take the kernels
# ---------------------------------------------------------------------------

def _on_card(*ts) -> bool:
    """Whether every tensor lies on one CUDA device."""
    dev = ts[0].device
    return dev.type == "cuda" and all(t.device == dev for t in ts)


def engages(p: dict, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25) -> bool:
    """Whether ``moe.apply_moe``'s local dropping dispatch of ``x`` runs
    as the kernels: every tensor on one card, none requiring grad, the
    kernels' dtypes (``x`` float32 or bf16, a float32
    router, bf16 contiguous expert stacks), and shapes within
    :func:`plan`'s limits (N*K <= ``MAX_PAIRS``, C <= ``MAX_ROWS``, E <=
    ``MAX_EXPERTS``, D and F multiples of 8).  Everything else (training,
    autograd, other dispatches, oversized N) keeps the plain code;
    ``apply_moe`` sends a DTensor ``x`` to its sharded path before it
    asks."""
    ws = [p[k] for k in _WEIGHTS]
    ts = (x, *ws)
    if not _on_card(*ts) or any(t.requires_grad for t in ts):
        return False
    router, wi_gate = ws[0], ws[1]
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or router.dtype != torch.float32
            or any(w.dtype != torch.bfloat16 or not w.is_contiguous()
                   for w in ws[1:])
            or not router.is_contiguous() or router.dim() != 2
            or wi_gate.dim() != 3):
        return False
    n, d = x.shape[0] * x.shape[1], x.shape[-1]
    e, f = router.shape[-1], wi_gate.shape[-1]
    cap = capacity(n, top_k, e, capacity_factor)
    return (n * top_k <= MAX_PAIRS and cap <= MAX_ROWS
            and e <= MAX_EXPERTS and d % 8 == 0 and f % 8 == 0)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_moe_ready", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.moe_dispatch_launch.argtypes = [P] * 19 + [I] * 15 + [P]
        lib.moe_dispatch_launch.restype = I
        lib._moe_ready = True
    return lib


#: each (device, stream)'s arrival counters of the route kernel (tokens
#: finished, then each token's blocks finished): zero between launches
#: (the blocks that read them last reset them), so kernels on two streams
#: never share them
_arrivals: dict = {}


def _arrival(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _arrivals.get(key)
    if t is None:
        t = _arrivals[key] = torch.zeros(1 + MAX_PAIRS, dtype=torch.int32,
                                         device=dev)
    return t


class Launch(NamedTuple):
    """A launch's output (B, S, D) in ``x``'s dtype (the routed experts'
    part, no shared experts), its workspace and the workspace's layout
    (:func:`views` reads it)."""
    out: torch.Tensor
    ws: torch.Tensor
    layout: dict
    n: int
    d: int
    f: int
    e: int
    k: int
    cap: int
    held: int

    @property
    def counts(self) -> torch.Tensor:
        """The (E,) int64 assignment counts over all E experts."""
        return _view(self.ws, self.layout, "counts", torch.int64, (self.e,))

    @property
    def aux(self) -> torch.Tensor:
        """The load-balance loss, a float32 scalar."""
        return _view(self.ws, self.layout, "aux", torch.float32, ())


def _view(ws, layout, name: str, dtype, shape) -> torch.Tensor:
    size = torch.Size(shape).numel() * dtype.itemsize
    at = layout[name]
    return ws[at:at + size].view(dtype).view(shape)


def views(r: Launch) -> dict:
    """The launch's intermediates: gates (N, K) float32, experts, capacity
    positions (0 where dropped) (N, K) int64, keep masks (N, K) bool,
    counts (E,) int64, the slot -> token table (E_held, C) int32 (-1
    empty), the aux loss, the bf16 buckets' hidden rows h (E_held, C, F)
    and outputs y (E_held, C, D)."""
    ws, lay, n, k = r.ws, r.layout, r.n, r.k
    return dict(
        gate=_view(ws, lay, "gate", torch.float32, (n, k)),
        idx=_view(ws, lay, "idx", torch.int64, (n, k)),
        pos=_view(ws, lay, "pos", torch.int64, (n, k)),
        keep=_view(ws, lay, "keep", torch.uint8, (n, k)).bool(),
        counts=r.counts,
        table=_view(ws, lay, "table", torch.int32, (r.held, r.cap)),
        aux=r.aux,
        h=_view(ws, lay, "h", torch.bfloat16, (r.held, r.cap, r.f)),
        y=_view(ws, lay, "y", torch.bfloat16, (r.held, r.cap, r.d)))


def _launch(p: dict, x: torch.Tensor, *, top_k: int, cap: int,
            share: tuple[int, int] | None, renorm: bool) -> Launch:
    """The four kernels on the current stream."""
    b, s, d = x.shape
    n = b * s
    router, wi_gate, wi_up, wo = (p[k] for k in _WEIGHTS)
    e = router.shape[-1]
    held, _, f = wi_gate.shape
    lo, hi = share or (0, e)
    dev = x.device
    pl = plan(held, cap, d, f, n * top_k)
    layout, nbytes = _layout(n, d, f, e, top_k, cap, held, pl.route_splits)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((b, s, d), dtype=x.dtype, device=dev)
    xc = x.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    base = ws.data_ptr()
    rc = _lib().moe_dispatch_launch(
        xc.data_ptr(), router.data_ptr(), wi_gate.data_ptr(),
        wi_up.data_ptr(), wo.data_ptr(), *(base + layout[b_] for b_ in _WS),
        out.data_ptr(), _arrival(dev, stream).data_ptr(), n, d, f, e, top_k,
        cap, lo, hi, int(renorm), int(x.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16), pl.route_rows, pl.route_smem,
        pl.mt, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    return Launch(out, ws, layout, n, d, f, e, top_k, cap, held)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def moe_dispatch(p: dict, x: torch.Tensor, *, top_k: int,
                 quant_mode: str = "none", capacity_factor: float = 1.25,
                 held: tuple[int, int] | None = None, renorm: bool = True):
    """The dropping dispatch of one MoE layer on the card, route through
    combine, then the shared experts: x (B, S, D) -> (out, aux).  The four
    kernels, one host call, no host sync; an open ``moe.expert_tally``
    gains the same ``(counts, capacity, held)`` entry as the plain
    dispatch's.  Each call is counted as one launch of ``KERNEL`` and,
    in an open tally, as fused.  ``moe.apply_moe`` calls it where
    :func:`engages` says so."""
    from repro_torch.models import moe

    e = p["router"].shape[-1]
    share = moe._share(p, held)
    cap = capacity(x.shape[0] * x.shape[1], top_k, e, capacity_factor)
    with span("moe.fused"):
        r = _launch(p, x, top_k=top_k, cap=cap, share=share, renorm=renorm)
    dispatch.record(KERNEL)
    moe.note_fused((r.counts, cap, share or (0, e)))
    return moe._shared(p, x, r.out, quant_mode), r.aux
