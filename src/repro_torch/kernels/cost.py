"""The work of a scan kernel, for the dry run's counters.

On ``meta`` tensors (the pod dry run, ``launch/dryrun.py``) a scan's
wrapper (``wkv6``, ``rg_lru``, and Griffin's serving loop) stands in for
its kernel: it makes the outputs and scratch the kernel makes and notes
the kernel's operations and bytes here, where the dry run's counter
adds them.  The plain versions walk the time axis a step at a time in
Python, tens of thousands of ops a call, which on meta would take hours
and count nothing the formula does not.  Without a listener a note is
dropped.

The formulas count what the function needs, each input read and each
output written once: ``wkv6_ops`` is ``chip_smoke.py``'s (the WKV6
bounds), the backward's products follow the same reading.
"""

from __future__ import annotations

from typing import Callable, List

_SINKS: List[Callable] = []

CHUNK = 16   # steps per sub-chunk of the chunked WKV6 kernels


def listen(sink: Callable):
    """Add ``sink(what, flops, nbytes)``; returns a function that removes
    it."""
    _SINKS.append(sink)
    return lambda: _SINKS.remove(sink)


def note(what: str, flops: float, nbytes: float) -> None:
    for sink in _SINKS:
        sink(what, flops, nbytes)


def wkv6_ops(b, t, h, hs, path) -> int:
    """Operations of one WKV6 forward in the form ``path`` computes:
    recurrent, per step and head 5·hs² + 5·hs; chunked, per sub-chunk of
    16 steps and head (r E) S and (k F)ᵀ V, A V over A's lower triangle
    and A's 136 entries."""
    if path == "recurrent":
        return (5 * hs * hs + 5 * hs) * b * h * t
    per_sub = 4 * CHUNK * hs * hs + CHUNK * (CHUNK + 1) * hs \
        + CHUNK * (CHUNK + 1) // 2 * 2 * hs
    return per_sub * b * h * -(-t // CHUNK)


def wkv6_bytes(b, t, h, hs, elem) -> int:
    """r, k, v, w read and y written (``elem`` bytes each), u read, the
    f32 state read and written."""
    return 5 * b * t * h * hs * elem + 2 * b * h * hs * hs * 4 + h * hs * 4


def wkv6_backward_ops(b, t, h, hs, path) -> int:
    """Operations of one WKV6 backward: chunked, per sub-chunk of 16
    steps and head five products of 16 x hs x hs, dA and Aᵀ dY over A's
    136 entries and A itself, the diagonal block's gradient; recurrent,
    per step and head the state's gradient (w·dS + rᵀdy, 3·hs²), dr from
    S (2·hs²), dk and dv from dS (4·hs²), dw from S ⊙ dS (2·hs²) and the
    u terms (10·hs)."""
    if path == "recurrent":
        return (11 * hs * hs + 10 * hs) * b * h * t
    per_sub = 5 * 2 * CHUNK * hs * hs + 3 * 136 * 2 * hs + 6 * 120 * hs
    return per_sub * b * h * -(-t // CHUNK)


def wkv6_backward_bytes(b, t, h, hs, elem) -> int:
    """r, k, v, w, dy read and dr, dk, dv, dw written; u, s0 and ds_last
    read, du and ds0 written."""
    return 9 * b * t * h * hs * elem + 4 * b * h * hs * hs * 4 \
        + 2 * h * hs * 4


def rg_lru_ops(b, s, ld, backward=False) -> int:
    """h_t = a_t·h_{t−1} + g_t: a product and a sum a step and channel;
    the backward's H_t = dh_t + a_{t+1} H_{t+1} and da_t = H_t h_{t−1}
    (dg_t = H_t): three."""
    return (3 if backward else 2) * b * s * ld


def rg_lru_bytes(b, s, ld, backward=False) -> int:
    """f32: a and g read and h written (forward); a, h and dh read, da and
    dg written (backward); h0 or dh0 besides."""
    return (5 if backward else 3) * b * s * ld * 4 + 2 * b * ld * 4
