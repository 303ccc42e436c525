from repro_torch.kernels.cross_entropy.ops import (  # noqa: F401
    cross_entropy,
    cross_entropy_bwd,
    cross_entropy_partial,
    cross_entropy_partial_plain,
    cross_entropy_plain,
    merge_partials,
)
