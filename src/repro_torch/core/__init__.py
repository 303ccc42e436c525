"""The paper's reductions as all-ones MMAs, the cost models and the
precision helpers: ``mma_reduce``, ``cost_model`` (the step model, the
kernels' bytes and the card's roofline), ``collectives`` and
``precision``. The public entry point is ``repro_torch.reduce``.

As in the reference's ``repro.core``, the older per-path names stay
importable from here as thin deprecation shims (``mma_sum``, ``mma_mean``,
``mma_sum_axis``, ``mma_sum_diff``, ``classic_tree_sum``, ``row_sum_mma``,
``row_moments_mma``, ``global_norm_sq_mma``): each warns and calls
``core.mma_reduce``'s function. They, ``DEFAULT_M``, ``ReductionTrace``,
the submodules and ``reduce`` resolve on first use, so that importing a
submodule (``core.cost_model``, which the card's bound readers import
without torch's model code) loads nothing else.
"""

import functools as _functools
import importlib as _importlib
import warnings as _warnings

_SHIMS = {
    "mma_sum": 'repro_torch.reduce.reduce(x, kind="sum")',
    "mma_mean": 'repro_torch.reduce.reduce(x, kind="mean")',
    "mma_sum_axis": "repro_torch.reduce.reduce(x, axis=...)",
    "mma_sum_diff": "repro_torch.reduce.reduce (differentiable)",
    "classic_tree_sum": 'repro_torch.reduce.reduce(x, backend="torch") (or '
                        "repro_torch.core.mma_reduce.classic_tree_sum for the "
                        "precision-study tree)",
    "row_sum_mma": "repro_torch.reduce.reduce(x, axis=-1)",
    "row_moments_mma": 'repro_torch.reduce.reduce(x, axis=-1, kind="moments")',
    "global_norm_sq_mma": 'repro_torch.reduce.reduce_tree(tree, kind="sumsq")',
}
_MODULES = ("cost_model", "collectives", "precision", "mma_reduce")


def _deprecated(name: str, fn, hint: str):
    @_functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _warnings.warn(f"repro_torch.core.{name} is deprecated; use {hint}",
                       DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)

    return wrapper


def __getattr__(name):
    if name in _MODULES:
        return _importlib.import_module(f"{__name__}.{name}")
    if name == "reduce":
        return _importlib.import_module("repro_torch.reduce")
    impl = _importlib.import_module(f"{__name__}.mma_reduce")
    if name in ("DEFAULT_M", "ReductionTrace"):
        return getattr(impl, name)
    if name in _SHIMS:
        shim = _deprecated(name, getattr(impl, name), _SHIMS[name])
        globals()[name] = shim  # one wrapper a name
        return shim
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SHIMS) | set(_MODULES)
                  | {"reduce", "DEFAULT_M", "ReductionTrace"})
