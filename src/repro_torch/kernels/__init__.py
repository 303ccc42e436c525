"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and with a launch counter (``kernels.common``):

  row_moments     -- layernorm_np / rmsnorm, row statistics as ones-MMAs
  flash_attention -- online-softmax attention, ones-MMA denominator
  cross_entropy   -- online logsumexp over the vocabulary, ones-MMA
                     denominator, exact label logit; its partial variant
                     (cross_entropy_partial) on a slice of a vocabulary
                     cut over ranks
  mma_reduce      -- the striped one-launch full reduction, the paper's
                     level, the one-launch multi-part reduction and the
                     one-launch segmented gather, with census
  scan            -- the triangular-MMA prefix sum
  matmul_stats    -- Y = X @ W with the row sum and sum of squares of the
                     f32 accumulator fused into the epilogue (ones-MMAs)
"""

from repro_torch.kernels.cross_entropy import cross_entropy, cross_entropy_partial  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_diff  # noqa: F401
from repro_torch.kernels.matmul_stats import matmul_stats  # noqa: F401
from repro_torch.kernels.mma_reduce import mma_sum_fused, mma_sum_parts  # noqa: F401
from repro_torch.kernels.row_moments import layernorm_np, rmsnorm  # noqa: F401
