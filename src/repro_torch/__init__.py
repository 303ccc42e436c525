"""PyTorch + CUDA port of the ``repro`` MMA-reduction stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package reproduces its
serving and training paths in PyTorch with hand-written ``sm_90a`` CUDA
kernels in place of the Pallas TPU kernels. Module names mirror ``repro``
so each port sits beside its counterpart:

  configs      -- ``ModelConfig``, ``TrainConfig`` and the arch registry
  kernels      -- CUDA kernels (``csrc/``), their ctypes build, and the
                  plain PyTorch version beside each one
  core         -- the all-ones-MMA reductions (rows and the eq. 13 sum)
  reduce       -- the ``reduce`` / ``reduce_many`` / ``reduce_tree`` /
                  ``scan`` engine and its backends (``repro_torch.scan``,
                  ``ScanPlan`` and ``scan_plan_for`` are exported at top
                  level, lazily, as in the reference)
  models       -- parameters, layers, attention, the decoder stack, losses
  optim        -- AdamW with the one-launch clip statistic
  data         -- the seeded synthetic token stream, packing offsets
  runtime      -- chaos injection, metrics, the guarded serving runtime
  launch       -- train/prefill/decode steps, the training and serving CLIs

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or anything of ``repro``. Entry points run on the GPU unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""


_LAZY = {
    "scan": ("repro_torch.reduce.scan", "scan"),
    "ScanPlan": ("repro_torch.reduce.plan", "ScanPlan"),
    "scan_plan_for": ("repro_torch.reduce.plan", "scan_plan_for"),
}


def __getattr__(name):
    # top-level exports resolved on first use, so that ``import
    # repro_torch`` stays light (the reference's lazy exports)
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
