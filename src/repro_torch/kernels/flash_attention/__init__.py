from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    attention_ref,
    blocks_for,
    flash_attention,
    flash_attention_diff,
    flash_attention_plain,
    pad_head_dim,
)
