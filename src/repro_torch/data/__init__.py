"""The token sources of the training path (the seeded synthetic stream and
the packed-token file reader), their prefetch, and the packing offsets of
ragged sequences."""

from repro_torch.data.pipeline import (  # noqa: F401
    MemmapTokens,
    Prefetcher,
    ShardInfo,
    SyntheticLM,
    packing_offsets,
)
