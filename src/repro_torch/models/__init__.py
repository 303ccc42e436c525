"""The decoder of the serving and training paths: the dense archs
(olmo-1b, internlm2-1.8b, deepseek-7b), the MoE archs
(granite-moe-1b-a400m, dbrx-132b; ``models.moe``), MLA (minicpm3-4b), the
SSM (mamba2-780m), the RG-LRU hybrid with local attention
(recurrentgemma-9b; ``models.rglru``) and vision cross-attention
(llama-3.2-vision-11b; ``models.frontends`` makes its context).

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
