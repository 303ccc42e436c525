"""Mamba-2 (SSD, state-space duality) block. [arXiv:2405.21060]

Port of ``repro/models/ssm.py`` (``_dims``, ``ssm_init``, ``_segsum``,
``ssd_chunked``, ``ssm_train``, ``make_ssm_cache``, ``ssm_decode``). The
SSD chunked algorithm is itself reduction by matmul: within a chunk the
output is a masked (C B^T) "attention" product and the chunk state a
decayed sum of outer products, both tensor-core products; the inter-chunk
recurrence is a first-order scan, here a loop over the chunks that emits
each chunk's PREVIOUS state (the reference's ``lax.scan``).

The decay scans (the cumulative sums of dt A inside each chunk) are scans
over batched rows: on every backend of ``repro_torch.scan`` they ride the
triangular product (``reduce.backends``: the scan kernel, K9, takes 1-D
streams only), as the reference's ride its batched triangular einsum; the
backend is ``backend_for_flags(cfg.mma_reductions)``. The gated norm runs
on the engine's route (``layers.norm_apply`` without the kernels), as the
reference's has no ``use_pallas``.

``dt_bias``, ``A_log`` and ``D`` are f32 whatever ``cfg.dtype`` is.

Under the sharded step's tensor parallelism (``ssm_train(tp=)``) the
block's leaves are a rank's heads (``models.parallel.Plan.block``): the
widths below are read off ``norm_scale`` (the rank's channels) and the
rank's xbc columns are its x heads, then all of B and C.

In sharded serving (``ssm_train(sv=)``, ``ssm_decode(sv=)``; a
``models.parallel.Serve``) the conv cache holds the rank's block of the
[x, B, C] channels and the state its heads. The rank's xbc and conv_w
columns are that block: it runs the conv on them alone (per channel, so
bitwise one device's), gathers the outputs over "model" in rank order and
takes its x heads and all of B and C; the SSD then runs its heads. Under
tensor parallelism the gated norm's statistic is summed over "model"
(``tp``); with whole weights the heads' y is gathered before the whole
norm and out.

The decode step does NOT update the recurrent cache in place:
``ssm_decode`` returns new ``conv`` and ``state`` tensors and leaves the
ones it was given untouched. The serving runtime re-issues a failed or
poisoned step from the committed state (``launch.serve.GuardedEngine``);
an in-place ``state = decay * state + ...`` or shift of the conv window
would apply a retried step twice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import reduce as R
from repro_torch.models import layers as L
from repro_torch.models import params as P


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.headdim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def ssm_init(gen, cfg, dtype, device) -> dict:
    """The projections z, xBC, dt and out, the conv weight (K, conv_dim),
    the dt bias (inverse softplus of dt0 drawn log-uniform in [dt_min,
    dt_max], the mamba init), A_log = log U[1, 16), D = 1 and the gated
    norm's scale, drawn from ``gen`` in that order."""
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    params = {
        "z": P.dense_init(gen, d, d_in, dtype, device),
        "xbc": P.dense_init(gen, d, conv_dim, dtype, device),
        "dt": P.dense_init(gen, d, nh, dtype, device),
        "out": P.dense_init(gen, d_in, d, dtype, device),
        "conv_w": P._normal(gen, (s.conv_width, conv_dim), s.conv_width**-0.5, dtype, device),
    }
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    params["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))
    a_init = 1.0 + 15.0 * torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    params["A_log"] = torch.log(a_init)
    params["D"] = torch.ones((nh,), dtype=torch.float32, device=device)
    params["norm_scale"] = torch.ones((d_in,), dtype=dtype, device=device)
    return params


def _segsum(dA: torch.Tensor, backend=None) -> torch.Tensor:
    """(..., q) -> (..., q, q) lower-triangular cumulative-decay exponents
    (-inf above the diagonal)."""
    q = dA.shape[-1]
    cs = R.scan(dA, axis=-1, backend=backend)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, backend=None):
    """SSD scan. x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g,
    n). Returns y (b, l, h, p) in x's dtype and the final state (b, h, p,
    n) f32. A sequence that is not a multiple of the chunk is zero-padded
    (dt = 0 there: no decay, no input)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    hpg = h // g  # heads per group
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    xdt = xc * dtc[..., None]
    dA = dtc * A  # (b, nc, q, h); A negative
    A_cum = R.scan(dA, axis=2, backend=backend)

    # intra-chunk (diagonal blocks): masked attention-like products
    Lmask = torch.exp(_segsum(dA.permute(0, 1, 3, 2), backend=backend))  # (b, nc, h, q, q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    CB = torch.repeat_interleave(CB, hpg, dim=2)                         # g -> h
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", CB * Lmask, xdt)

    # chunk states: decayed outer-product reductions
    decay_to_end = torch.exp(A_cum[:, :, -1:, :] - A_cum)                 # (b, nc, q, h)
    if g == 1:
        states = torch.einsum("bcqin,bcqh,bcqhp->bchpn", Bc, decay_to_end, xdt)
    else:
        Bh = torch.repeat_interleave(Bc, hpg, dim=3)
        states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_to_end, xdt)

    # inter-chunk recurrence: each chunk gets the state before it
    chunk_decay = torch.exp(A_cum[:, :, -1, :])                           # (b, nc, h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c].to(torch.float32)
    prev_states = torch.stack(prev, 1)                                    # (b, nc, h, p, n)

    # off-diagonal contribution: C_t . state_prev, decayed from the chunk start
    state_decay = torch.exp(A_cum)                                        # (b, nc, q, h)
    if g == 1:
        y_off = torch.einsum("bcqin,bchpn,bcqh->bcqhp", Cc, prev_states, state_decay)
    else:
        Ch = torch.repeat_interleave(Cc, hpg, dim=3)
        y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :l]
    return y.to(x.dtype), carry


def _split_xbc(xbc, s, d_in):
    gn = s.n_groups * s.d_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]


def _gate_and_norm(p, y, z, cfg, dtype, tp=None):
    """y * silu(z) in f32, then the gated RMSNorm on the engine's route
    (``tp``: over the ranks' channels, ``layers.norm_apply(tp=)``)."""
    y = y * F.silu(z.to(torch.float32))
    return L.norm_apply("rmsnorm", {"scale": p["norm_scale"]}, y.to(dtype), eps=cfg.norm_eps,
                        mma=cfg.mma_reductions, tp=tp)


def _serve_split(conv: torch.Tensor, cfg, sv, f32: bool = False):
    """The conv's output over the rank's block of channels (``sv.channels``)
    -> its x heads (``sv.q_heads``), B and C: the blocks gathered over
    "model" in rank order, then (in f32 with ``f32``, the decode's) silu."""
    s, d_in, _, conv_dim = _dims(cfg)
    if sv.channels != (0, conv_dim):
        conv = sv.gather(conv, -1)
    xs, Bx, Cx = _split_xbc(F.silu(conv.to(torch.float32) if f32 else conv), s, d_in)
    h0, h1 = sv.q_heads
    return xs[..., h0 * s.headdim:h1 * s.headdim], Bx, Cx


def ssm_train(p, x, cfg, return_state: bool = False, tp=None, sv=None):
    """The Mamba-2 block, train/prefill. x: (B, L, d) -> (B, L, d), or with
    ``return_state`` (out, cache): the conv window (the last K-1 pre-conv
    inputs, zero-filled in front of a short prompt) and the SSD's final
    state, the prefill -> decode handoff. ``tp`` (``models.parallel.TP``):
    the leaves hold a rank's heads (the module doc); x goes through
    ``tp.enter`` (Megatron's f), the conv, the SSD and the gate run on
    those heads with the whole B and C, the gated norm's statistic is
    summed over the ranks both ways, and out is row-parallel, its partial
    sums through ``tp.exit`` (g). ``sv`` (``models.parallel.Serve``, the
    sharded prefill): the module doc; the conv window returned is the
    rank's block of channels and the state its heads'."""
    s = cfg.ssm
    if tp is not None:
        x = tp.enter(x)
    b, l, _ = x.shape
    z = P.dense_apply(p["z"], x)
    xbc_raw = P.dense_apply(p["xbc"], x)
    dt_raw = P.dense_apply(p["dt"], x).to(torch.float32)
    conv = L.causal_conv1d(xbc_raw, p["conv_w"])
    if sv is None:
        xs, Bx, Cx = _split_xbc(F.silu(conv), s, p["norm_scale"].shape[0])
    else:
        xs, Bx, Cx = _serve_split(conv, cfg, sv)
    nh = xs.shape[-1] // s.headdim
    xh = xs.reshape(b, l, nh, s.headdim)
    Bh = Bx.reshape(b, l, s.n_groups, s.d_state).to(torch.float32)
    Ch = Cx.reshape(b, l, s.n_groups, s.d_state).to(torch.float32)
    dt = F.softplus(dt_raw + p["dt_bias"])                                # (b, l, nh)
    A = -torch.exp(p["A_log"])                                            # (nh,)
    y, final_state = ssd_chunked(xh.to(torch.float32), dt, A, Bh, Ch, s.chunk,
                                 backend=R.backend_for_flags(cfg.mma_reductions))
    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = L.gather_outputs(y.reshape(b, l, nh * s.headdim), sv)
    out = P.dense_apply(p["out"], _gate_and_norm(p, y, z, cfg, x.dtype, tp))
    if tp is not None:
        out = tp.exit(out)
    if not return_state:
        return out
    k = s.conv_width
    tail = F.pad(xbc_raw, (0, 0, max(0, (k - 1) - l), 0))[:, -(k - 1):]
    return out, {"conv": tail, "state": final_state}


def make_ssm_cache(batch: int, cfg, dtype, device) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, s.headdim, s.d_state), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(p, x_t, cache: dict, cfg, tp=None, sv=None):
    """One decode step. x_t: (B, 1, d) -> (out (B, 1, d), a NEW cache): the
    conv window shifted by one and the state decayed and added to, both
    new tensors; ``cache`` is left as it was (see the module doc). ``tp``
    and ``sv``: the sharded decode (the module doc): the rank steps its
    block of the conv window and its heads' state, the gated norm's
    statistic summed over "model" under ``tp`` and out row-parallel."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b = x_t.shape[0]
    xt = x_t[:, 0]
    z = P.dense_apply(p["z"], xt)
    xbc_t = P.dense_apply(p["xbc"], xt)
    dt_raw = P.dense_apply(p["dt"], xt).to(torch.float32)
    conv_state, y_conv = L.conv1d_step(cache["conv"], xbc_t, p["conv_w"])
    if sv is None:
        xs, Bx, Cx = _split_xbc(F.silu(y_conv.to(torch.float32)), s, d_in)
    else:
        xs, Bx, Cx = _serve_split(y_conv, cfg, sv, f32=True)
        nh = xs.shape[-1] // s.headdim
    xh = xs.reshape(b, nh, s.headdim)
    Bh = Bx.reshape(b, s.n_groups, s.d_state)
    Ch = Cx.reshape(b, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw + p["dt_bias"])                                # (b, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                             # (b, nh)
    # state <- decay * state + dt * x (outer) B  (the first group's B, as
    # the reference's broadcast takes it)
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bh,bhp,bin->bhpn", dt, xh.to(torch.float32), Bh[:, :1, :])
    y = torch.einsum("bin,bhpn->bhp", Ch, state)                          # C . state
    y = y + p["D"][None, :, None] * xh.to(torch.float32)
    y = L.gather_outputs(y.reshape(b, nh * s.headdim), sv)
    out = P.dense_apply(p["out"], _gate_and_norm(p, y, z, cfg, x_t.dtype, tp))
    if tp is not None:
        out = tp.exit(out)
    return out[:, None, :], {"conv": conv_state, "state": state}
