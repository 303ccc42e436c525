from repro_torch.kernels.mma_reduce.ops import (  # noqa: F401
    PARTS_KERNEL_MAX,
    combine_lane_partials,
    default_num_lanes,
    lane_geometry,
    mma_sum_fused,
    mma_sum_fused_plain,
    mma_sum_parts,
    mma_sum_parts_plain,
    parts_layout,
)
