"""Shared inputs of the port's parity tests (``tests/test_torch_*.py``):
the reference's exported models, seeded random streamable geometries, and
spec conversion between the two packages.  Everything crosses between JAX
and PyTorch as numpy."""
import dataclasses
import functools

import jax
import numpy as np

from repro.core import cnn_spec as ref_cs
from repro.models import kws
from repro_torch.core import cnn_spec as port_cs


def port_spec(spec: ref_cs.CNN1DSpec) -> port_cs.CNN1DSpec:
    """The same spec built from the port's classes."""
    layers = tuple(
        getattr(port_cs, type(lay).__name__)(
            **{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)})
        for lay in spec.layers
    )
    return port_cs.CNN1DSpec(in_len=spec.in_len,
                             in_channels=spec.in_channels,
                             in_bits=spec.in_bits, layers=layers,
                             name=spec.name)


@functools.lru_cache(maxsize=None)
def exported(spec: ref_cs.CNN1DSpec, seed: int = 0):
    """The reference's exported model: numpy int8 ternary weights and
    (float64 thresholds, bool flips) per layer, cached per (spec, seed):
    callers must not mutate it."""
    params = kws.init_kws_params(jax.random.PRNGKey(seed), spec)
    weights, thresholds = kws.export_kws(params, spec)
    weights = {k: np.asarray(v) for k, v in weights.items()}
    thresholds = {k: (np.asarray(t), np.asarray(f))
                  for k, (t, f) in thresholds.items()}
    return weights, thresholds


def random_spec(seed: int):
    """A small random streamable spec (the generator of
    ``tests/test_megakernel.py::_random_spec``): bit-serial first layer
    with random k/stride/pad, 1-2 conv blocks with random k/pad/pool, GAP,
    binary fc, raw fc.  Returns ``(spec, hop_frames)`` or None when no
    hop_frames reaches a steady state."""
    from repro.stream.state import plan_stream

    rng = np.random.default_rng(seed)
    k0 = int(rng.integers(3, 13))
    s0 = int(rng.choice([2, 4, 8]))
    c0 = int(rng.choice([4, 8]))
    bits0 = int(rng.choice([4, 8]))
    layers = [
        ref_cs.Conv1DSpec(1, c0, k=k0, stride=s0,
                          pad=int(rng.integers(0, k0)), in_bits=bits0,
                          in_offset=1 << (bits0 - 1), name="l0"),
    ]
    cin = c0
    for j in range(int(rng.integers(1, 3))):
        k = int(rng.choice([3, 5]))
        cout = int(rng.choice([4, 8]))
        layers.append(
            ref_cs.Conv1DSpec(cin, cout, k=k, stride=1,
                              pad=int(rng.integers(0, k // 2 + 1)),
                              pool=int(rng.choice([1, 2, 2, 4])),
                              name=f"b{j + 1}")
        )
        cin = cout
    layers += [
        ref_cs.GAPSpec(cin, name="gap"),
        ref_cs.FCSpec(cin, 8, in_bits=8, name="fc1"),
        ref_cs.FCSpec(8, kws.N_CLASSES, out_raw=True, name="fc2"),
    ]
    spec = ref_cs.CNN1DSpec(in_len=int(rng.integers(500, 900)),
                            in_channels=1, in_bits=layers[0].in_bits,
                            layers=tuple(layers), name=f"rand{seed}")
    for hf in (1, 2, 3, 4, 6, 8, 12):
        try:
            plan = plan_stream(spec, hop_frames=hf)
        except ValueError:
            continue
        if spec.in_len >= plan.prime_samples + 3 * plan.hop_samples:
            return spec, hf
    return None


#: seeds of random_spec that reach a steady state (checked by the tests)
RANDOM_SEEDS = (0, 1, 2, 3)
