"""Logical axis names (the JAX package's ``sharding/rules.py``, in part).

Only ``parse_axes`` is ported: ``ServeLoop`` reads each cache leaf's
"batch" dimension from its axes string.  The rule table, ``spec_for`` and
``constrain`` map logical axes onto a device mesh; a single card has none
(``constrain`` is the identity there), and meshes come with the
multi-device item of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Optional, Tuple


def parse_axes(axes) -> Tuple[Optional[str], ...]:
    """Axes are spelled as a space-separated string; '.' = None.
    e.g. "embed heads head_dim"."""
    if isinstance(axes, str):
        return tuple(None if a == "." else a for a in axes.split())
    return tuple(axes)
