"""PyTorch + CUDA port of the ``repro`` MMA-reduction stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package reproduces its
serving and training paths in PyTorch with hand-written ``sm_90a`` CUDA
kernels in place of the Pallas TPU kernels. Module names mirror ``repro``
so each port sits beside its counterpart:

  configs      -- ``ModelConfig``, ``TrainConfig`` and the arch registry
  kernels      -- CUDA kernels (``csrc/``), their ctypes build, and the
                  plain PyTorch version beside each one
  core         -- the all-ones-MMA reductions (rows and the eq. 13 sum)
  reduce       -- the ``reduce`` / ``reduce_tree`` engine and its backends
  models       -- parameters, layers, attention, the decoder stack, losses
  optim        -- AdamW with the one-launch clip statistic
  data         -- the seeded synthetic token stream
  runtime      -- chaos injection, metrics, the guarded serving runtime
  launch       -- train/prefill/decode steps, the training and serving CLIs

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or anything of ``repro``. Entry points run on the GPU unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
