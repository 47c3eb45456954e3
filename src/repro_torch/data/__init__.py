"""The deterministic synthetic data pipeline."""
from .pipeline import SyntheticCorpus, make_iterator  # noqa: F401
