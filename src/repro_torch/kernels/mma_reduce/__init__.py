from repro_torch.kernels.mma_reduce.ops import (  # noqa: F401
    PARTS_KERNEL_MAX,
    mma_sum_parts,
    mma_sum_parts_plain,
    parts_layout,
)
