"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``) and the single-card kernel roofline
(``launch.roofline``)."""

from . import roofline  # noqa: F401
