"""Synthetic multi-window traffic traces for the discrete-event loop.

Counterpart of ``repro/runtime/traces.py``, copied as it is (numpy and the
stdlib only).

Each trace is a ``[windows, n, n]`` float64 array of per-pair bytes — one
demand matrix per orchestration window (one all-to-all round).  Three
workload shapes cover the runtime's acceptance scenarios:

  * :func:`balanced_trace` — uniform all-pairs traffic with multiplicative
    jitter: the "NIMBLE must match the static baseline" regime;
  * :func:`drifting_skew_trace` — a receive hotspot that *moves* between
    destinations over the trace, with a linear crossfade so the drift is
    gradual (the unanticipated-cross-traffic regime the congestion
    literature identifies as the dominant latency source);
  * :func:`skew_burst_trace` — balanced background with a sudden persistent
    burst on a few pairs (the estimator's fast-attack scenario).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

MB = float(1 << 20)


def _spread(n: int, hot: Optional[int], hot_frac: float,
            bytes_per_src: float) -> np.ndarray:
    """One demand matrix: ``hot_frac`` of every source's bytes to ``hot``."""
    D = np.zeros((n, n))
    for s in range(n):
        others = [d for d in range(n) if d != s]
        if hot is None or hot == s:
            for d in others:
                D[s, d] = bytes_per_src / len(others)
            continue
        cold = [d for d in others if d != hot]
        D[s, hot] = bytes_per_src * hot_frac
        for d in cold:
            D[s, d] = bytes_per_src * (1.0 - hot_frac) / len(cold)
    return D


def balanced_trace(
    n: int,
    windows: int,
    bytes_per_src: float = 256 * MB,
    jitter: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Uniform all-pairs traffic with per-entry multiplicative jitter."""
    rng = np.random.default_rng(seed)
    base = _spread(n, None, 0.0, bytes_per_src)
    out = np.empty((windows, n, n))
    for w in range(windows):
        noise = 1.0 + jitter * rng.standard_normal((n, n))
        out[w] = base * np.clip(noise, 0.25, 4.0)
        np.fill_diagonal(out[w], 0.0)
    return out


def drifting_skew_trace(
    n: int,
    windows: int,
    bytes_per_src: float = 256 * MB,
    hot_frac: float = 0.7,
    dwell: int = 10,
    ramp: int = 3,
    hot_seq: Optional[Sequence[int]] = None,
    jitter: float = 0.02,
    seed: int = 0,
) -> np.ndarray:
    """Receive hotspot that migrates between destinations.

    The hotspot dwells on one destination for ``dwell`` windows, then
    crossfades linearly onto the next over ``ramp`` windows.  The default
    ``hot_seq`` alternates node groups (assuming group size ~4) so each
    migration re-routes inter-group rails, the paper's worst case.
    """
    rng = np.random.default_rng(seed)
    if hot_seq is None:
        half = max(n // 2, 1)
        hot_seq = [i % 2 * half + (i // 2) % half for i in range(windows)]
    n_phases = (windows + dwell - 1) // dwell
    hots = [hot_seq[p % len(hot_seq)] for p in range(n_phases)]
    out = np.empty((windows, n, n))
    for w in range(windows):
        phase, off = divmod(w, dwell)
        cur = _spread(n, hots[phase], hot_frac, bytes_per_src)
        if 0 < phase and off < ramp:
            # crossfade from the previous hotspot
            mix = (off + 1) / (ramp + 1)
            prev = _spread(n, hots[phase - 1], hot_frac, bytes_per_src)
            cur = mix * cur + (1.0 - mix) * prev
        noise = 1.0 + jitter * rng.standard_normal((n, n))
        out[w] = cur * np.clip(noise, 0.25, 4.0)
        np.fill_diagonal(out[w], 0.0)
    return out


def skew_burst_trace(
    n: int,
    windows: int,
    bytes_per_src: float = 256 * MB,
    burst_window: int = 5,
    burst_pairs: Optional[Sequence[tuple]] = None,
    burst_mult: float = 8.0,
    seed: int = 0,
) -> np.ndarray:
    """Balanced background; selected pairs jump ``burst_mult x`` at
    ``burst_window`` and stay hot for the rest of the trace."""
    out = balanced_trace(n, windows, bytes_per_src, jitter=0.03, seed=seed)
    if burst_pairs is None:
        burst_pairs = [(s, (s + n // 2) % n) for s in range(0, n, 2)]
    for w in range(burst_window, windows):
        for s, d in burst_pairs:
            if s != d:
                out[w, s, d] *= burst_mult
    return out
