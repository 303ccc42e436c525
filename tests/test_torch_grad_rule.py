"""Every kernel wrapper of the port keeps the autograd graph or refuses.

A wrapper launches its kernel through ctypes into a fresh output, which
has no ``grad_fn``; on inputs that require grad that would silently cut
the graph. So each wrapper, with grad mode on and an input that requires
grad, either goes through its ``torch.autograd.Function`` (the output's
``grad_fn`` is that Function's node and a gradient flows back) or raises.
On the CPU the plain versions are torch code and would keep a graph of
their own, so the test names the node: the check sits in the wrapper,
before the device rule, and the CPU path here exercises it as the CUDA
path would.
"""

import pytest
import torch

from repro_torch import kernels as K


def _x(*shape):
    return (torch.randn(shape, generator=torch.Generator().manual_seed(0)) + 0.5).requires_grad_(True)


# name -> (call returning (leaf, output), the Function's node)
DIFFERENTIABLE = {
    "layernorm_np": (lambda: ((x := _x(4, 32)), K.layernorm_np(x)), "_LayerNormNPBackward"),
    "rmsnorm": (lambda: ((x := _x(4, 32)), K.rmsnorm(x, torch.ones(32))), "_RMSNormBackward"),
    "rmsnorm_gamma": (lambda: ((g := _x(32)), K.rmsnorm(torch.randn(4, 32), g)),
                      "_RMSNormBackward"),
    "flash_attention": (lambda: ((q := _x(1, 2, 8, 16)), K.flash_attention(q, q, q)),
                        "_FlashAttentionBackward"),
    "flash_attention_diff": (lambda: ((q := _x(1, 2, 8, 16)), K.flash_attention_diff(q, q, q)),
                             "_FlashAttentionBackward"),
    "cross_entropy": (lambda: ((lg := _x(6, 40)), K.cross_entropy(lg, torch.arange(6) * 5)),
                      "_CrossEntropyBackward"),
}


@pytest.mark.parametrize("name", sorted(DIFFERENTIABLE))
def test_wrapper_keeps_the_graph(name):
    call, node = DIFFERENTIABLE[name]
    leaf, out = call()
    assert type(out.grad_fn).__name__ == node
    (g,) = torch.autograd.grad(out.sum(), leaf)
    assert g.shape == leaf.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("name", ["mma_sum_fused", "mma_sum_parts", "matmul_stats"])
def test_reduction_wrappers_refuse_grad(name):
    x = _x(100)
    call = {
        "mma_sum_fused": lambda: K.mma_sum_fused(x),
        "mma_sum_parts": lambda: K.mma_sum_parts([x, torch.ones(3)]),
        "matmul_stats": lambda: K.matmul_stats(x.reshape(10, 10), torch.ones(10, 3))[1],
    }[name]
    with pytest.raises(RuntimeError, match="not differentiable"):
        call()
    with torch.no_grad():
        assert call().grad_fn is None


def test_no_grad_takes_the_plain_forward():
    x = _x(4, 32)
    with torch.no_grad():
        assert K.layernorm_np(x).grad_fn is None
    with torch.inference_mode():
        assert K.cross_entropy(_x(6, 40).detach(), torch.zeros(6, dtype=torch.int64)).shape == (6,)
