from repro_torch.kernels.matmul_stats.ops import (  # noqa: F401
    matmul_stats,
    matmul_stats_plain,
    matmul_stats_ref,
)
