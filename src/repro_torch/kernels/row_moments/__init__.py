from repro_torch.kernels.row_moments.ops import (  # noqa: F401
    ROUTE_ELEMENT,
    ROUTE_VECTOR,
    launch_plan,
    layernorm_np,
    layernorm_np_plain,
    plan_for,
    rmsnorm,
    rmsnorm_plain,
)
