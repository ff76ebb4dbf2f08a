"""The paper's own model: binary KWS 1-D CNN (Fig. 7 reconstruction).

Not an LM — exposed through repro_torch.models.kws + the core
compiler/executor.
This config module provides the spec builders and compile hints so the
launcher can treat it uniformly (--arch pscnn-kws).
"""
from repro_torch.models.kws import (
    ROTATE_HINTS,
    ROWSPLIT_HINTS,
    build_kws_smoke_spec,
    build_kws_spec,
)

CONFIG = build_kws_spec()
SMOKE = build_kws_smoke_spec()

__all__ = ["CONFIG", "SMOKE", "ROTATE_HINTS", "ROWSPLIT_HINTS",
           "build_kws_spec", "build_kws_smoke_spec"]
