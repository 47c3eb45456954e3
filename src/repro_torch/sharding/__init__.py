"""Logical-axis names of parameters and caches (``rules.parse_axes``)."""
