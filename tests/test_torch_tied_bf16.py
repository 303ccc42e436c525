"""The tied bf16 embedding gradient: olmo-1b's bf16 run puts its tied
embedding's gradient norm a share under the f32 run's, and the reference
loses the same share.

Both packages take the same bf16 weights (the reference's
``init_params(PRNGKey(0))`` drawn at bf16, carried across by
``params_from_jax``) and one seeded ``SyntheticLM`` batch, once at bf16 and
once upcast to f32 (the same values), through each package's gradient
function (the reference's ``_make_grads_fn``, the port's
``launch.steps.make_grads_fn``). The ratio bf16 / f32 of the embedding
gradient's norm is a package's own loss; the two ratios must agree.

  * ``tiny``: tiny olmo-1b on the kernel route (the reference's Pallas
    kernels in interpret mode, the port's plain versions), 4 x 64 tokens.
    Ratios 0.99989 (reference) and 0.99830 (port): no share to speak of,
    and bf16 noise of a 256 x 64 table between them; limit 2.5e-3.
  * ``wide``: tiny olmo-1b at width 512 (heads of 128, d_ff 2048) with
    olmo-1b's own 50 304-token vocabulary, 4 x 256 tokens, on the
    non-kernel route. Both lose 0.845% (0.991549 and 0.991553); the
    share grows with the width and the tokens (the card's full-width run
    at 4 x 512 reads 3.9%). Limit 5e-4 on the difference, and each ratio
    must show the share (under 0.995). At this width the kernel route
    reads 0.990842 and 0.990835 (the reference's interpret mode takes
    ~3 min, so it is not run here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import reduce as RR
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_arch as ref_arch
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.steps import _make_grads_fn as ref_make_grads_fn
from repro.models import init_params as ref_init_params
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.launch.steps import make_grads_fn
from repro_torch.models.convert import params_from_jax

CASES = {
    # kernels, widths, (batch, seq), limit on |port ratio - reference ratio|
    "tiny": (True, {}, (4, 64), 2.5e-3),
    "wide": (False, dict(vocab_size=50304, d_model=512, d_head=128, d_ff=2048), (4, 256), 5e-4),
}
SHARE_SEEN = 0.995  # "wide": each ratio under this


@pytest.fixture
def kernel_backends():
    RR.set_default_backend("pallas_fused")
    earlier = R.set_default_backend("cuda_fused")
    yield
    RR.set_default_backend(None)
    R.set_default_backend(earlier)


def _embed_grad_norms(kernels: bool, widths: dict, batch: int, seq: int) -> dict:
    """{dtype: (reference's norm, port's norm)} of the embedding gradient."""
    rbase = dataclasses.replace(ref_arch("olmo-1b", tiny=True), use_pallas=kernels, **widths)
    pbase = dataclasses.replace(get_arch("olmo-1b", tiny=True), use_kernels=kernels, **widths)
    assert rbase.tie_embeddings and pbase.tie_embeddings
    weights, _ = ref_init_params(jax.random.PRNGKey(0),
                                 dataclasses.replace(rbase, dtype="bfloat16"))
    tokens = RefSyntheticLM(pbase.vocab_size, seq, batch, seed=0).next()["tokens"]
    out = {}
    for dt in ("bfloat16", "float32"):
        rcfg, pcfg = (dataclasses.replace(c, dtype=dt) for c in (rbase, pbase))
        rparams = jax.tree.map(lambda a: a.astype(dt), weights)
        grads, _ = jax.jit(ref_make_grads_fn(rcfg, RefTrainConfig(), None, None, None))(
            rparams, {"tokens": jnp.asarray(tokens)})
        ref_norm = float(np.linalg.norm(np.asarray(grads["embed"]["table"], np.float64)))
        pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
        leaves = R.tree_leaves(pparams)
        for p in leaves:
            p.requires_grad_(True)
        at = next(i for i, p in enumerate(leaves) if p is pparams["embed"]["table"])
        pgrads, _ = make_grads_fn(pcfg, TrainConfig())(pparams,
                                                        {"tokens": torch.from_numpy(tokens)})
        out[dt] = (ref_norm, float(pgrads[at].double().norm()))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tied_bf16_embedding_share_is_the_references(request, case):
    kernels, widths, (batch, seq), limit = CASES[case]
    if kernels:
        request.getfixturevalue("kernel_backends")
    norms = _embed_grad_norms(kernels, widths, batch, seq)
    ref_ratio = norms["bfloat16"][0] / norms["float32"][0]
    port_ratio = norms["bfloat16"][1] / norms["float32"][1]
    # the f32 runs agree: the ratios' difference is the bf16 runs' own
    assert norms["float32"][1] == pytest.approx(norms["float32"][0], rel=1e-4)
    assert abs(port_ratio - ref_ratio) <= limit, (ref_ratio, port_ratio)
    if case == "wide":
        assert ref_ratio < SHARE_SEEN and port_ratio < SHARE_SEEN, (ref_ratio, port_ratio)
