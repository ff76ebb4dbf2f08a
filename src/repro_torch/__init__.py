"""PyTorch port of the PSCNN streaming keyword-spotting runtime.

A second package beside ``repro`` (the JAX reference), laid out like it:
``core`` (model spec, energy model), ``models`` (KWS spec builders),
``obs`` (metrics, trace, events), ``runtime`` (slot pool), ``stream``
(ingest, plan, scheduler, detector, metrics), ``kernels`` (the
hand-written CUDA hop kernel and its plain PyTorch version) and
``utils``.  It imports torch, numpy and the standard library only.
"""
