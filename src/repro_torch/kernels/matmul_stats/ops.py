"""Matmul with its row moments fused into the epilogue: Y = X @ W plus the
per-row sum and sum of squares of Y, in one kernel (K11).

Port of ``repro/kernels/matmul_stats`` (kernel ``_kernel``, launcher
``matmul_stats_call``, oracle ``matmul_stats_ref``):

  matmul_stats        -- the public wrapper (the reference's signature and
                         outputs). CUDA tensors: ONE launch of
                         ``csrc/matmul_stats.cu``; CPU tensors: the plain
                         version below.
  matmul_stats_plain  -- the plain PyTorch version, in the reference
                         kernel's order.
  matmul_stats_ref    -- the oracle: one f32 product, then the row sums.

X and W are rounded to bf16 (f16 input too: the reference rounds to bf16)
and multiplied with f32 accumulation; Y is stored in x's dtype. The
moments are taken from the f32 accumulator, NOT from the stored Y: at bf16
output a sum of the rounded Y is off by far more than the accumulation
noise. The moments feed a following normalization without a second pass
over Y. Not differentiable: the reference has no VJP either.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, common

# The CUDA kernel's fixed CTA tile (csrc/matmul_stats.cu MS_BM / MS_BN).
KERNEL_BM, KERNEL_BN = 128, 128

# How the kernel's producer loads an operand (csrc/matmul_stats.cu Route):
# TMA straight into the swizzled bf16 tile; TMA of the raw tile, then the
# producer's cast to bf16; or element by element.
ROUTE_TMA, ROUTE_CAST, ROUTE_ELEM = 0, 1, 2


def load_route(dtype: torch.dtype, address: int, row_elems: int) -> int:
    """The kernel's route for a row-major operand of ``dtype`` at device
    ``address`` with rows of ``row_elems`` elements: TMA needs a 16-byte
    aligned base and rows a multiple of 16 bytes; bf16 then goes straight
    into the tile, f32 and f16 through the cast. Anything else is loaded
    element by element."""
    if address % 16 or row_elems * dtype.itemsize % 16:
        return ROUTE_ELEM
    return ROUTE_TMA if dtype == torch.bfloat16 else ROUTE_CAST


def load_routes(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """``(route of x, route of w)`` for contiguous x (M, K) and w (K, N)."""
    return (load_route(x.dtype, x.data_ptr(), x.shape[1]),
            load_route(w.dtype, w.data_ptr(), w.shape[1]))


def matmul_stats_ref(x: torch.Tensor, w: torch.Tensor):
    """Oracle: Y = bf16(X) @ bf16(W) in f32, then ``sum(y)`` and
    ``sum(y * y)`` over each row. x (M, K), w (K, N) -> (y (M, N) in x's
    dtype, row_sum (M,) f32, row_sumsq (M,) f32)."""
    y = common.bf16_round(x.to(torch.float32)) @ common.bf16_round(w.to(torch.float32))
    return y.to(x.dtype), torch.sum(y, -1), torch.sum(y * y, -1)


def matmul_stats_plain(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128, bn: int = 256,
                       bk: int = 512):
    """Plain PyTorch version in the reference kernel's order: x and w
    rounded to bf16 and computed in f32; for each ``bn`` column tile the
    product is accumulated over K in ``bk`` blocks, the tile's row sum and
    row sum of squares are taken from the f32 tile and folded into the
    running moments in tile order, and the tile is stored in x's dtype.
    ``bm`` only tiles rows, which are independent; the result does not
    depend on it. On the card the kernel keeps its own fixed tile
    (``KERNEL_BM`` x ``KERNEL_BN``): ``bm``, ``bn`` and ``bk`` set this
    version's fold order only."""
    _check_args(x, w, bm, bn, bk)
    m, k = x.shape
    n = w.shape[1]
    xb = common.bf16_round(x.to(torch.float32))
    wb = common.bf16_round(w.to(torch.float32))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s = torch.zeros((m,), dtype=torch.float32, device=x.device)
    ss = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for n0 in range(0, n, bn):
        acc = torch.zeros((m, min(bn, n - n0)), dtype=torch.float32, device=x.device)
        for k0 in range(0, k, bk):
            acc += xb[:, k0:k0 + bk] @ wb[k0:k0 + bk, n0:n0 + bn]
        y[:, n0:n0 + bn] = acc.to(x.dtype)
        s += torch.sum(acc, -1)
        ss += torch.sum(acc * acc, -1)
    return y, s, ss


def _check_args(x, w, bm, bn, bk) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"matmul_stats takes 2-D x (M, K) and w (K, N); got {tuple(x.shape)} and "
            f"{tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(
            f"matmul_stats: x has K = {x.shape[1]} columns but w has {w.shape[0]} rows")
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype not in common.NATIVE_INGEST_DTYPES:
            raise TypeError(
                f"matmul_stats takes float32, bfloat16 or float16 inputs; {what} is {t.dtype}")
    for b, what in ((bm, "bm"), (bn, "bn"), (bk, "bk")):
        if not isinstance(b, int) or isinstance(b, bool) or b < 1:
            raise ValueError(f"matmul_stats: {what} must be a positive int; got {b!r}")


def _launch(x: torch.Tensor, w: torch.Tensor):
    m, k = x.shape
    n = w.shape[1]
    row_blocks = common.ceil_div(m, KERNEL_BM)
    col_blocks = common.ceil_div(n, KERNEL_BN)
    if row_blocks * col_blocks >= 2**31:
        raise ValueError(f"matmul_stats: ({m}, {n}) is more tiles than one launch takes")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    ss = torch.empty((m,), dtype=torch.float32, device=x.device)
    # (M, column blocks, 2): every CTA writes its rows' partial moments
    ws = torch.empty((m, col_blocks, 2), dtype=torch.float32, device=x.device)
    route_x, route_w = load_routes(x, w)
    stream = build.stream_ptr(x)
    with torch.cuda.device(x.device):
        err = build.library().ms_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), s.data_ptr(), ss.data_ptr(), m, n, k,
            build.dtype_code(x), build.dtype_code(w), route_x, route_w, ws.data_ptr(),
            common.fold_tickets("matmul_stats", x.device, stream, row_blocks).data_ptr(), stream,
        )
    build.check(err, "matmul_stats")
    # x and w in; y and the moments out; every CTA's row partials out and
    # back into its row block's last CTA
    common.record_io(matmul_stats, (common.nbytes(x, w, ws), common.nbytes(y, s, ss, ws)))
    return y, s, ss


@common.counted("matmul_stats")
def matmul_stats(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128, bn: int = 256,
                 bk: int = 512):
    """(Y, row_sum(Y), row_sumsq(Y)) of Y = X @ W, the moments fused into
    the matmul: x (M, K), w (K, N), float32, bfloat16 or float16 -> (y (M,
    N) in x's dtype, s (M,) f32, ss (M,) f32). The moments are those of the
    f32 accumulator, before Y is rounded to x's dtype. CPU tensors: the
    plain version, with ``bm``, ``bn``, ``bk`` as its tiles; CUDA tensors:
    one launch of the kernel, whose tile is fixed (the arguments are
    checked and otherwise unused there). Not differentiable: an input that
    requires grad raises."""
    _check_args(x, w, bm, bn, bk)
    common.refuse_grad("matmul_stats", x, w, entry=None)
    if common.on_cpu(x, w):
        common.record_io(matmul_stats, (common.nbytes(x, w),
                                        x.shape[0] * (w.shape[1] * x.element_size() + 8)),
                         plain=True)
        return matmul_stats_plain(x, w, bm=bm, bn=bn, bk=bk)
    if x.shape[0] == 0 or w.shape[1] == 0:
        return (torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device),
                torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device),
                torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device))
    return _launch(x.contiguous(), w.contiguous())
