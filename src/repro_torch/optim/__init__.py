"""The optimizer of the training path: AdamW with the one-launch clip, and
its guarded step (the in-launch census and the bitwise skip)."""

from repro_torch.optim.adamw import (  # noqa: F401
    ADAM_EPS,
    GNORM_EPS,
    AdamWState,
    GuardState,
    apply_updates,
    cosine_lr,
    global_norm,
    global_norm_and_clip,
    guarded_apply_updates,
    init_guard_state,
    init_state,
)
