"""Parameter initialization: plain dicts of tensors, drawn from an
explicit ``torch.Generator``.

Port of ``repro/models/params.py`` without the logical sharding axes.
Weights keep the reference's layout: a dense weight is (in, out) and is
applied as ``x @ w``. The models draw from one generator in a fixed order,
and each layer is its own entry of a Python list (``models.model``), which
the Python loop over layers replaces ``lax.scan`` with; ``split`` (a
generator split into independent children, the reference's key split) and
``stack_init`` (copies of a module stacked on a leading axis, as the
reference stacks its units) are kept for callers that want either.
"""

from __future__ import annotations

import torch


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale
    return w.to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device, scale=None) -> dict:
    if scale is None:
        scale = in_dim**-0.5
    return {"w": _normal(gen, (in_dim, out_dim), scale, dtype, device)}


def dense_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def split(gen: torch.Generator, n: int) -> list:
    """``n`` generators on ``gen``'s device, each seeded by one draw of
    ``gen``: independent streams, the same for the same ``gen`` state (the
    reference's ``jax.random.split``)."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(int(s)) for s in seeds]


def stack_init(init_fn, gen: torch.Generator, n: int):
    """``n`` copies of a module stacked on a leading axis:
    ``init_fn(generator) -> params`` (a nested dict of tensors) is called
    once per generator of ``split(gen, n)``, and each leaf stacked."""

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack([init_fn(g) for g in split(gen, n)])


def count_params(tree) -> int:
    """Elements of every tensor in a nested dict / list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return sum(count_params(v) for v in tree)


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """Vocab rows padded to a multiple of 256 (50304 -> 50432), as in the
    reference; pad logits are masked and sliced off in ``model._head``."""
    return -(-vocab // multiple) * multiple


def embed_init(gen, vocab: int, dim: int, dtype, device) -> dict:
    return {"table": _normal(gen, (padded_vocab(vocab), dim), dim**-0.5, dtype, device)}


# Tensors ``norm_init`` makes for each kind of norm.
NORM_TENSORS = {"rmsnorm": 1, "layernorm": 2, "layernorm_np": 0}


def norm_init(kind: str, dim: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "layernorm_np":  # OLMo: non-parametric
        return {}
    raise ValueError(f"norm {kind!r} is not ported")

