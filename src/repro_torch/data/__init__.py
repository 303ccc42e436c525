"""The seeded synthetic token stream of the training path, and the packing
offsets of ragged sequences."""

from repro_torch.data.pipeline import ShardInfo, SyntheticLM, packing_offsets  # noqa: F401
