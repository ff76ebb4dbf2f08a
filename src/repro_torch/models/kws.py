"""The paper's binary keyword-spotting model (Fig. 7): its spec builders.

Only the topology is ported so far: ``build_kws_spec`` (the Fig. 7
reconstruction at full width, 64) and the reduced ``build_kws_smoke_spec``
with their constants.  The QAT graph and ``export_kws`` stay in the
reference package until the training slice is ported; the streaming
runtime takes the exported numpy ``weights``/``thresholds`` dicts as they
are.

  input   16,000 samples (1 s @ 16 kHz), 8-bit offset-binary
  l0   conv( 1->64,  K19, S8, pad9) bitser-8      out 2000
  b1   conv(64->128, K3,  S1, pad1) +pool2        out 1000
  b2   conv(128->256,K5,  S1, pad2) +pool2        out  500
  b3   conv(256->352,K3,  S1, pad1) +pool2        out  250
  gap  250x352 -> 8-bit counts
  fc1  352->512, bitser-8, SA binary
  fc2  512->12, raw logits
"""
from __future__ import annotations

from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec

N_CLASSES = 12
IN_LEN = 16000
IN_OFFSET = 128

ROTATE_HINTS = ("b3.c1", "b3.c2", "fc1.c2", "fc1.c3")
ROWSPLIT_HINTS = {"fc2": 2}


def build_kws_spec(
    in_len: int = IN_LEN,
    width: int = 64,
    n_classes: int = N_CLASSES,
) -> CNN1DSpec:
    """The Fig. 7 reconstruction.  ``width`` scales channels (64 = paper)."""
    w = width
    return CNN1DSpec(
        in_len=in_len,
        in_channels=1,
        in_bits=8,
        name="pscnn_kws",
        layers=(
            Conv1DSpec(1, w, k=19, stride=8, pad=9, in_bits=8,
                       in_offset=IN_OFFSET, name="l0"),
            Conv1DSpec(w, 2 * w, k=3, stride=1, pad=1, pool=2, name="b1"),
            Conv1DSpec(2 * w, 4 * w, k=5, stride=1, pad=2, pool=2, name="b2"),
            Conv1DSpec(4 * w, int(5.5 * w), k=3, stride=1, pad=1, pool=2, name="b3"),
            GAPSpec(int(5.5 * w), name="gap"),
            FCSpec(int(5.5 * w), 8 * w, in_bits=8, name="fc1"),
            FCSpec(8 * w, n_classes, out_raw=True, name="fc2"),
        ),
    )


def build_kws_smoke_spec() -> CNN1DSpec:
    """Reduced config for CPU smoke tests (same family, tiny)."""
    return build_kws_spec(in_len=800, width=16)
