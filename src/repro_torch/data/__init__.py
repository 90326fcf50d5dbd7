"""Deterministic synthetic data pipeline."""

from repro_torch.data.synthetic import SyntheticLM, make_batch_iterator  # noqa: F401
