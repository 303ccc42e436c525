"""The dense decoder (OLMo) of the serving and training paths."""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward_hidden,
    init_params,
    make_caches,
    prefill,
)
