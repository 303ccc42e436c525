from repro_torch.kernels.row_moments.ops import (  # noqa: F401
    layernorm_np,
    layernorm_np_plain,
    rmsnorm,
    rmsnorm_plain,
)
