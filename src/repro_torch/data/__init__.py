"""The seeded synthetic token stream of the training path."""

from repro_torch.data.pipeline import ShardInfo, SyntheticLM  # noqa: F401
