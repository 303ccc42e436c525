"""The reduction engine: ``reduce`` (full and row reductions, with the
precision policy), ``reduce_many`` (N arrays in one pass), ``reduce_tree``
(one statistic over many arrays, with the in-launch census) and ``scan``
(prefix sums), over the ``torch`` / ``mma_torch`` / ``cuda_hier`` /
``cuda_fused`` backends and the ``segmented`` auto route; the memoized
planner with ``autotune``, and the launch meter of ``reduce.inspect``."""

from repro_torch.reduce.api import KINDS, reduce, reduce_many, reduce_tree, tree_leaves  # noqa: F401
from repro_torch.reduce.backends import (  # noqa: F401
    Backend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.reduce.inspect import (  # noqa: F401
    assert_census_free,
    assert_epilogue_free,
    assert_staging_free,
    census_ops,
    count_kernel_launches,
    epilogue_ops,
    launch_records,
    measured_hbm_bytes,
    staging_ops,
)
from repro_torch.reduce.plan import (  # noqa: F401
    BACKEND_ENV,
    ReducePlan,
    ScanPlan,
    autotune,
    backend_for_flags,
    default_backend,
    plan_cache_clear,
    plan_cache_info,
    plan_for,
    quarantine_backend,
    quarantined_backends,
    reinstate_backend,
    scan_plan_cache_info,
    scan_plan_for,
    segmented_backend_for,
    set_default_backend,
)
from repro_torch.reduce.scan import SCAN_KINDS, scan  # noqa: F401
