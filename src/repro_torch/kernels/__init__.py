"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and with a launch counter (``kernels.common``):

  row_moments     -- layernorm_np / rmsnorm, row statistics as ones-MMAs
  flash_attention -- online-softmax attention, ones-MMA denominator
  mma_reduce      -- the one-launch multi-part reduction with census
"""

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.mma_reduce import mma_sum_parts  # noqa: F401
from repro_torch.kernels.row_moments import layernorm_np, rmsnorm  # noqa: F401
