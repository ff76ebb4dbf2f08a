"""Roofline terms of a dry-run cell, from the dry run's own counters.

The port of the reference's ``repro/launch/roofline.py``.  The reference
reads a compiled XLA program: ``cost_analysis()`` for per-partition FLOPs
and bytes and the post-SPMD HLO text for its collectives.  The port runs
the step itself on DTensors of fake tensors (``launch/dryrun.py``) under
:class:`CostCounter`, a ``FakeTensorMode`` that sees each device's *local*
ops (the DTensor dispatch unwraps to them) and counts:

  * FLOPs of each local op (``torch.utils.flop_counter``'s formulas);
  * HBM bytes: every input read and every output written once per local
    op, views and factories excluded (no fusion, so an upper bound where
    XLA's count is after fusion);
  * every functional collective that a redistribution issues, with its
    local operand and result bytes (:func:`collectives_from_ops`);
  * the live bytes of the device's storages, their peak, and what was
    live when the backward began.

Hardware constants, per card, of an NVIDIA H100 SXM5 80 GB cluster.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column: 989 TFLOP/s
# bf16 Tensor Core, dense (the 1979 there is with 2:4 sparsity)
PEAK_FLOPS = 989e12
# same datasheet, H100 SXM: 3.35 TB/s HBM3
HBM_BW = 3.35e12
# NVIDIA ConnectX-7 / Quantum-2 NDR InfiniBand: 400 Gb/s per port, one
# port per GPU (DGX H100 reference architecture).  A 16-wide mesh axis
# spans two 8-GPU NVLink nodes, so a ring's slowest hop is this link.
LINK_BW = 50e9

# functional collective -> the reference's HLO collective kind
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no bytes of their own: metadata, aliases and allocations
_NO_BYTES = {
    "empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "device", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_to_copy_noop",
}


@dataclasses.dataclass
class Collective:
    kind: str
    operand_bytes: int
    result_bytes: int

    @property
    def moved_bytes(self) -> int:
        """Per-device link bytes under ring algorithms."""
        if self.kind == "all-gather":
            return max(self.result_bytes - self.operand_bytes, 0)
        if self.kind == "reduce-scatter":
            return max(self.operand_bytes - self.result_bytes, 0)
        if self.kind == "all-reduce":
            return 2 * self.operand_bytes
        return self.operand_bytes  # all-to-all / collective-permute


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def collectives_from_ops(ops) -> list[Collective]:
    """The :class:`Collective` list of a record of functional collectives:
    (op name, local operand bytes, local result bytes) per call, as
    :class:`CostCounter` keeps them in ``collective_ops``."""
    return [Collective(_COLLECTIVE_KINDS[name], ob, rb)
            for name, ob, rb in ops]


class CostCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts the local work of one device.

    DTensor ops reach this mode twice: as the global op that sharding
    propagation runs for output shapes (not counted: DTensor enters it
    through ``ShardingPropagator._fake_mode_lock``, which :meth:`track`
    points at this mode's pause) and as the local op on the device's
    shards (counted).  Counting runs only inside :meth:`track`; memory is
    tracked there too, starting from the ``args`` given."""

    def __init__(self, **kw):
        kw.setdefault("allow_non_fake_inputs", True)
        super().__init__(**kw)
        self._paused = 0
        self._depth = 0
        self._on = False
        #: the DTensor attribute that :meth:`track` hooks to pause
        #: counting during sharding propagation (it differs by torch
        #: version; recorded in each dry-run cell)
        self.propagation_hook = None
        self.reset()

    # -- counters --------------------------------------------------------
    def reset(self) -> None:
        self.flops = 0
        self.hbm_bytes = 0
        self.collective_ops: list[tuple[str, int, int]] = []
        self.by_op: dict[str, list] = {}   # op -> [calls, flops, bytes]
        self._live: dict[int, tuple[int, str]] = {}  # storage -> (n, op)
        self.live_bytes = 0
        self.peak_bytes = 0
        # live bytes when the first backward op ran (None: no backward),
        # and those bytes by the op that made each storage
        self.live_at_backward = None
        self.live_by_op_at_backward: dict[str, int] = {}

    def _hold(self, t: torch.Tensor, op: str = "input") -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, op)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, (0, ""))[0]

    # -- the pause sharding propagation enters ---------------------------
    class _Pause:
        def __init__(self, mode):
            self.mode = mode

        def __enter__(self):
            self.mode._paused += 1

        def __exit__(self, *exc):
            self.mode._paused -= 1
            return False

    class _Track:
        def __init__(self, mode, args):
            self.mode, self.args = mode, args

        def __enter__(self):
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator

            m = self.mode
            m.reset()
            pause = CostCounter._Pause(m)
            if hasattr(ShardingPropagator, "_fake_mode_lock"):
                self._attr = "_fake_mode_lock"
                self._prev = ShardingPropagator._fake_mode_lock
                ShardingPropagator._fake_mode_lock = pause
            else:  # a torch without the lock: wrap the propagation itself
                self._attr = "_propagate_tensor_meta_non_cached"
                self._prev = prev = ShardingPropagator.__dict__[self._attr]

                def propagate(*a, **kw):
                    with pause:
                        return prev(*a, **kw)
                setattr(ShardingPropagator, self._attr, propagate)
            m.propagation_hook = self._attr
            for t in _tensors(self.args):
                m._hold(getattr(t, "_local_tensor", t))
            m.args_bytes = m.live_bytes
            m._on = True
            return m

        def __exit__(self, *exc):
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator

            self.mode._on = False
            setattr(ShardingPropagator, self._attr, self._prev)
            return False

    def track(self, args=()):
        """Counting on for the block, from zero; ``args`` (a tree of the
        step's inputs, DTensors or fake tensors) are live from the start."""
        return CostCounter._Track(self, args)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # ops that the fake mode's decompositions issue inside an op are
        # the op's own work: only the outermost op counts
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or not self._on or self._paused \
                or self._depth:
            return out
        if self.live_at_backward is None and \
                torch._C._current_autograd_node() is not None:
            self.live_at_backward = self.live_bytes
            for n, op in self._live.values():
                self.live_by_op_at_backward[op] = \
                    self.live_by_op_at_backward.get(op, 0) + n
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            if name in _COLLECTIVE_KINDS:
                ib = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                ob = sum(_nbytes(t) for t in _tensors(out))
                self.collective_ops.append((name, ib, ob))
                for t in _tensors(out):
                    self._hold(t, name)
            return out
        if func.is_view or name in _NO_BYTES:
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        from torch.utils.flop_counter import flop_registry

        fn = flop_registry.get(func._overloadpacket)
        flops = int(fn(*args, **(kwargs or {}), out_val=out)) if fn else 0
        in_ids = {t.untyped_storage()._cdata for t in ins}
        moved = sum(_nbytes(t) for t in ins)
        for t in outs:
            if t.untyped_storage()._cdata not in in_ids:  # not in place
                moved += _nbytes(t)
                self._hold(t, name)
        self.flops += flops
        self.hbm_bytes += moved
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        return out


@dataclasses.dataclass
class Roofline:
    flops: float              # per device
    hbm_bytes: float          # per device
    coll_bytes: float         # per device, ring-adjusted
    collectives: dict         # kind -> (count, bytes)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: dominant term (perfect overlap model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s_lower_bound": self.step_s,
            "collectives": self.collectives,
        }


def aggregate(colls: list[Collective]) -> tuple[dict, int]:
    """-> ({kind: (count, moved bytes)}, total moved bytes)."""
    agg: dict[str, list] = {}
    total = 0
    for c in colls:
        k = agg.setdefault(c.kind, [0, 0])
        k[0] += 1
        k[1] += c.moved_bytes
        total += c.moved_bytes
    return {k: tuple(v) for k, v in agg.items()}, total


def analyze(counter: CostCounter) -> Roofline:
    """The roofline of what ``counter`` counted in its last ``track``."""
    agg, total = aggregate(collectives_from_ops(counter.collective_ops))
    return Roofline(
        flops=float(counter.flops),
        hbm_bytes=float(counter.hbm_bytes),
        coll_bytes=float(total),
        collectives=agg,
    )


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_active_params * tokens


def model_flops_infer(n_active_params: int, tokens: int) -> float:
    return 2.0 * n_active_params * tokens
