"""The dense decoder (OLMo) of the serving path."""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_params,
    make_caches,
    prefill,
)
