"""The reduction engine: ``reduce`` (full and row reductions, with the
precision policy) and ``reduce_tree`` (one statistic over many arrays, with
the in-launch census), over the ``torch`` / ``mma_torch`` / ``cuda_hier`` /
``cuda_fused`` backends."""

from repro_torch.reduce.api import reduce, reduce_tree, tree_leaves  # noqa: F401
from repro_torch.reduce.backends import (  # noqa: F401
    Backend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.reduce.plan import (  # noqa: F401
    ReducePlan,
    backend_for_flags,
    default_backend,
    plan_for,
    quarantine_backend,
    quarantined_backends,
    reinstate_backend,
    set_default_backend,
)
