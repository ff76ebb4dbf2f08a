"""repro_torch.stream — always-on multi-stream keyword-spotting runtime.

The port of the reference's ``repro.stream``: audio arrives chunk by chunk
on many concurrent streams, each hop only computes the receptive-field
tail of every conv layer, and all active streams share one batched step —
ONE launch of the hand-written CUDA hop kernel on the ``"megakernel"``
backend — that also returns every slot's finalized logits.  The streaming
math is bit-exact with the reference (tests/test_torch_*.py).

Modules:
  frontend   incremental PCM -> 8-bit offset-binary model frames (thin
             per-stream facade over the shared RingArena)
  state      stream plan, ring buffers + shared RingArena, the numpy
             per-stream reference (StreamState) and the batched primer
  scheduler  elastic continuous-batching scheduler (megakernel,
             per-stage kernels or dense torch backend, finalization in
             the step)
  detector   posterior smoothing + hysteresis/refractory event logic
  metrics    fleet counters split host-pack vs device per hop + EnergyLedger
  async_plane  not ported yet (queue item A.7)

Quickstart (on the H100; pass ``device="cpu"`` to run the plain version):

    import numpy as np
    from repro_torch.models import kws
    from repro_torch.stream import StreamScheduler

    spec = kws.build_kws_smoke_spec()
    # weights/thresholds: the numpy dicts an exported model provides
    sched = StreamScheduler(spec, weights, thresholds, capacity=64)
    sid = sched.add_stream()
    mic = np.zeros(16000, np.uint8) + 128         # 1 s of silence codes
    for i in range(0, len(mic), 160):
        sched.push_audio(sid, mic[i : i + 160])   # feed ~10 ms chunks
        for sid_, frame, logits, event in sched.step():
            if event is not None:
                print("keyword", event.cls, "on stream", sid_)
    result = sched.close_stream(sid)              # flush; slot pool shrinks
"""
from repro_torch.stream.async_plane import AsyncStreamScheduler
from repro_torch.stream.detector import (
    BatchedDetector,
    Detection,
    DetectorConfig,
    PosteriorDetector,
)
from repro_torch.stream.frontend import AudioFrontend, quantize_pcm
from repro_torch.stream.metrics import StreamMetrics, plan_hop_ledger
from repro_torch.stream.scheduler import (
    HopBatch,
    StreamResult,
    StreamScheduler,
    param_cache_stats,
    prepared_model_params,
)
from repro_torch.stream.state import (
    FrameRing,
    RingArena,
    SlotPlacement,
    StreamPlan,
    StreamState,
    plan_stream,
    prime_batch,
)

__all__ = [
    "AsyncStreamScheduler",
    "AudioFrontend",
    "param_cache_stats",
    "prepared_model_params",
    "BatchedDetector",
    "Detection",
    "DetectorConfig",
    "FrameRing",
    "HopBatch",
    "PosteriorDetector",
    "RingArena",
    "SlotPlacement",
    "StreamMetrics",
    "StreamPlan",
    "StreamResult",
    "StreamScheduler",
    "StreamState",
    "plan_hop_ledger",
    "plan_stream",
    "prime_batch",
    "quantize_pcm",
]
