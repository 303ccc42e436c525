"""The optimizer of the training path: AdamW with the one-launch clip."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    apply_updates,
    cosine_lr,
    global_norm,
    global_norm_and_clip,
    init_state,
)
