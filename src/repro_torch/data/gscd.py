"""Synthetic Google-Speech-Commands-like corpus (offline stand-in).

The port's copy of the reference's ``repro/data/gscd.py``, numpy only:
the same ``(seed, step)`` gives the same bytes.  GSCD itself does not
ship with the repository (DESIGN.md §9.1); this generator produces 12
classes with the same interface: 1 s @ 16 kHz, quantized to 8-bit
offset-binary — class 10 = 'unknown', 11 = 'silence'.

Each keyword class is a distinct formant pattern: 2-3 harmonic chirps with
class-specific base frequencies, amplitude envelopes and onset timing, plus
pink-ish noise.  The classes are well-separated enough for a binary CNN to
learn, but not trivially (additive noise, random shifts, speed jitter).
"""
from __future__ import annotations

import numpy as np

N_CLASSES = 12
SR = 16000

# class-specific formant recipes (f0, f1, chirp rate, envelope)
_RECIPES = [
    (220, 880, 0.0), (330, 1320, 0.2), (440, 660, -0.2), (550, 1100, 0.1),
    (660, 990, -0.1), (290, 1450, 0.3), (370, 740, -0.3), (490, 1470, 0.15),
    (610, 915, -0.15), (260, 1560, 0.25),
]


def _keyword(rng: np.random.Generator, cls: int, n: int = SR) -> np.ndarray:
    """Class signature = formants + *envelope structure* (syllable count,
    AM rate, onset/duration band).  Binary-activation features see signal
    duty-cycles/envelopes far better than carrier phase, so the temporal
    structure is what makes the synthetic task learnable by a BNN — the
    spectral recipe still separates the classes for full-precision models.
    """
    f0, f1, chirp = _RECIPES[cls]
    t = np.arange(n) / SR
    jitter = rng.uniform(0.9, 1.1)
    n_syll = 1 + cls % 3                       # 1-3 "syllables"
    syl_rate = 2.5 + 0.9 * (cls % 4)           # envelope AM rate (Hz)
    onset = 0.05 + 0.02 * (cls % 5) + rng.uniform(0, 0.04)
    dur = (0.30 + 0.05 * (cls % 4)) * rng.uniform(0.9, 1.1)
    env = np.zeros_like(t)
    for s_i in range(n_syll):
        c = onset + dur * (s_i + 0.5) / n_syll
        env += np.exp(-0.5 * ((t - c) / (dur / (2.5 * n_syll))) ** 2)
    env *= 0.75 + 0.25 * np.sin(2 * np.pi * syl_rate * t)
    phase0 = rng.uniform(0, 2 * np.pi)
    f_t0 = f0 * jitter * (1 + chirp * t)
    f_t1 = f1 * jitter * (1 - 0.5 * chirp * t)
    sig = env * (
        np.sin(2 * np.pi * np.cumsum(f_t0) / SR + phase0)
        + 0.6 * np.sin(2 * np.pi * np.cumsum(f_t1) / SR)
        + 0.3 * np.sin(2 * np.pi * np.cumsum(2.1 * f_t0) / SR)
    )
    noise = rng.standard_normal(n) * 0.05
    return sig + noise


def _unknown(rng: np.random.Generator, n: int = SR) -> np.ndarray:
    """Babble: random mixture of two keyword recipes at low coherence."""
    a, b = rng.integers(0, 10, 2)
    return 0.5 * _keyword(rng, a, n) + 0.5 * _keyword(rng, b, n)[::-1]


def _silence(rng: np.random.Generator, n: int = SR) -> np.ndarray:
    return rng.standard_normal(n) * rng.uniform(0.01, 0.06)


def sample(rng: np.random.Generator, cls: int, n: int = SR) -> np.ndarray:
    if cls < 10:
        sig = _keyword(rng, cls, n)
    elif cls == 10:
        sig = _unknown(rng, n)
    else:
        sig = _silence(rng, n)
    # normalize + 8-bit offset-binary quantization (paper: 8-bit fixed point)
    if cls == 11:
        sig = np.clip(sig, -1, 1)  # silence stays quiet (no AGC boost)
    else:
        peak = np.max(np.abs(sig)) + 1e-6
        sig = sig / peak * rng.uniform(0.5, 0.95)
    q = np.clip(np.round(sig * 127) + 128, 0, 255)
    return q.astype(np.uint8)


def batch(seed: int, step: int, batch_size: int, n: int = SR
          ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (x (B, n) uint8, y (B,) int32) for a global step."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ys = rng.integers(0, N_CLASSES, batch_size)
    xs = np.stack([sample(rng, int(c), n) for c in ys])
    return xs, ys.astype(np.int32)


def dataset(seed: int, n_batches: int, batch_size: int, n: int = SR):
    for step in range(n_batches):
        yield batch(seed, step, batch_size, n)
