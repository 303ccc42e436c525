"""The decoder of the serving and training paths: the dense archs
(olmo-1b, internlm2-1.8b, deepseek-7b) and the MoE archs
(granite-moe-1b-a400m, dbrx-132b; ``models.moe``).

``init_params`` / ``forward`` / ``prefill`` / ``decode_step`` /
``make_caches`` are the public contract of the launchers, as in the
reference's ``repro.models``; ``losses`` holds the training losses."""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    forward_hidden,
    init_params,
    make_caches,
    prefill,
)
from repro_torch.models import losses  # noqa: F401
