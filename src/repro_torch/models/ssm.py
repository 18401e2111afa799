"""Mamba2 mixer with the SSD (state-space duality) chunked scan
[arXiv:2405.21060].

Sequence mode walks the chunks of length ``Q`` in order (the
reference's ``lax.scan`` over chunks is a Python loop here): within a
chunk the quadratic, attention-like form computes the intra-chunk
contribution, and a (state -> state) recurrence carries the inter-chunk
SSM state. Decode mode is the O(1) single-step recurrence over the
carried state and the causal-conv ring of the last ``W - 1`` PRE-conv
inputs.

The input projection is split into separate matrices (z, x, B, C, dt),
as in the reference. Plain PyTorch on both devices: the reference
computes the mixer in plain ``jnp`` outside any Pallas kernel.

``ssm_prefill`` and ``ssm_decode`` write the carried state and the conv
ring into the ``cache`` they are given IN PLACE (the decoder stack
passes a layer's slice of its stacked cache tree) and return it.

Over a model axis (``axis=``, ``launch.model_parallel``) a rank holds a
block of whole heads: its columns of ``w_z`` / ``w_x`` / ``conv_wx`` /
``conv_bx`` / ``gate_norm`` and rows of ``w_out``, and the SSM state of
its heads. ``w_B``, ``w_C``, their convs and the per-head ``w_dt`` /
``dt_bias`` / ``A_log`` / ``D`` replicate; the rank slices its heads out
of the per-head ones. The gated norm's mean over d_inner is the axis's
sum of squares over the global d_inner, ``w_out`` is row-parallel
(its f32 partial sums summed over the axis), and the conv ring
replicates: each rank holds all of it, the new x channels gathered from
the ranks before each write. Every replicated tensor the rank's heads
read — ``x`` into the rank's products, the post-conv B and C, the
per-head slices, the summed mean square — crosses ``mp.to_ranks``, so
its cotangent is the ranks' sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import model_parallel as mp
from repro_torch.models.common import dense_init, silu, to_storage


def ssm_init(cfg, generator: torch.Generator, device="cuda", lead=()):
    """``lead`` prepends stacking axes (the period axis) to every leaf."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    n = s.d_state
    k = len(lead)

    def w(shape):
        return dense_init(lead + shape, generator, k, device=device)

    def const(t):
        return t.to(device).expand(lead + t.shape).clone()

    def zeros(m):
        return torch.zeros(lead + (m,), device=device)

    return {
        "w_z": w((d, di)),
        "w_x": w((d, di)),
        "w_B": w((d, n)),
        "w_C": w((d, n)),
        "w_dt": w((d, nh)),
        # depthwise causal conv over x, B, C (split per group: a depthwise
        # conv factors exactly across channel groups)
        "conv_wx": w((s.conv_width, di)) * 0.1,
        "conv_bx": zeros(di),
        "conv_wB": w((s.conv_width, n)) * 0.1,
        "conv_bB": zeros(n),
        "conv_wC": w((s.conv_width, n)) * 0.1,
        "conv_bC": zeros(n),
        "dt_bias": zeros(nh),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": const(torch.ones(nh)),
        "gate_norm": const(torch.ones(di)),
        "w_out": w((di, d)),
    }


def _local(params, cfg, axis):
    """The rank's view of the mixer's params: the per-head replicated
    leaves (``w_dt``'s columns, ``dt_bias``, ``A_log``, ``D``) cut to
    its heads; the params themselves without an axis."""
    if not mp.active(axis):
        return params
    nh = cfg.ssm.num_heads(cfg.d_model)
    if nh % axis.size:
        raise ValueError(f"{nh} SSM heads do not split over a model axis "
                         f"of {axis.size}")
    h = nh // axis.size
    return {**params, "w_dt": mp.rank_block(params["w_dt"], axis, -1, h),
            **{k: mp.rank_block(params[k], axis, 0, h)
               for k in ("dt_bias", "A_log", "D")}}


def _project_in(params, x, axis=None):
    """x (..., D) -> (z, xr, Br, Cr, dt_raw) pre-conv projections: the
    rank's own products (z, x, dt over its heads) take ``x`` through
    ``mp.to_ranks``, the replicated B and C take it directly."""
    dt = x.dtype
    xr = mp.to_ranks(x, axis)
    return tuple((x if k in ("w_B", "w_C") else xr) @ params[k].to(dt)
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _causal_conv(seq, w, b):
    """seq (B, S, C), w (W, C): depthwise causal conv + silu."""
    width, s = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(width))
    return silu(out + b)


def _gated_out(params, y, z, x_dtype, axis=None, d_inner=None):
    """The gated RMS norm over d_inner and the output projection; over a
    model axis the mean square is the axis's sum of squares over the
    global ``d_inner``, and the projection's partial sums, in f32, are
    summed and rounded once."""
    dt = y.dtype
    g = y * silu(z)
    if mp.active(axis):
        # summed over the ranks, then read by each rank's channels: the
        # backward sums the ranks' cotangents of the mean square
        var = mp.to_ranks(mp.from_ranks(torch.sum(
            torch.square(g.float()), dim=-1, keepdim=True), axis),
            axis) / d_inner
    else:
        var = torch.mean(torch.square(g.float()), dim=-1, keepdim=True)
    g = (g.float() * torch.rsqrt(var + 1e-6) * params["gate_norm"]).to(dt)
    if not mp.active(axis):
        return (g @ params["w_out"].to(dt)).to(x_dtype)
    part = g.float() @ params["w_out"].to(dt).float()   # f32 partial sums
    return mp.sum_partials(part, axis, x_dtype)


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_forward(params, cfg, x, axis=None):
    """x (B, S, D) -> (B, S, D). S is right-padded to the chunk multiple."""
    out, _ = _ssm_forward_with_state(params, cfg, x, axis)
    return out


def _ssm_forward_with_state(params, cfg, x, axis=None):
    """Chunked SSD scan -> (out (B, S, D), final carried state (B, H, N,
    P) f32; over a model axis, the rank's heads)."""
    s_cfg = cfg.ssm
    params = _local(params, cfg, axis)
    orig_len = x.shape[1]
    q = min(s_cfg.chunk, orig_len)
    if orig_len % q:                         # causal: right-pad then trim
        x = F.pad(x, (0, 0, 0, q - orig_len % q))
    b, slen, _ = x.shape
    m = mp.size(axis)
    di = s_cfg.d_inner(cfg.d_model) // m
    nh = s_cfg.num_heads(cfg.d_model) // m
    n, p = s_cfg.d_state, s_cfg.head_dim
    dev = x.device

    z, xr, br, cr, dt_raw = _project_in(params, x, axis)
    xc = _causal_conv(xr, params["conv_wx"].to(x.dtype),
                      params["conv_bx"].to(x.dtype))
    # the replicated B and C, read by the rank's heads
    bmat = mp.to_ranks(_causal_conv(br, params["conv_wB"].to(x.dtype),
                                    params["conv_bB"].to(x.dtype)), axis)
    cmat = mp.to_ranks(_causal_conv(cr, params["conv_wC"].to(x.dtype),
                                    params["conv_bC"].to(x.dtype)), axis)
    xs = xc.reshape(b, slen, nh, p)
    dt = _softplus(dt_raw.float() + params["dt_bias"])          # (B,S,H)
    a = -torch.exp(params["A_log"])                             # (H,)
    la = dt * a                                 # per-step log decay (B,S,H)

    iidx = torch.arange(q, device=dev)
    causal = (iidx[:, None] >= iidx[None, :])[None, :, :, None]
    h = torch.zeros((b, nh, n, p), dtype=torch.float32, device=dev)
    ys = []
    for c in range(slen // q):
        rows = slice(c * q, (c + 1) * q)
        xk = xs[:, rows].float()                                # (B,Q,H,P)
        bk, ck = bmat[:, rows].float(), cmat[:, rows].float()   # (B,Q,N)
        dtk = dt[:, rows]                                       # (B,Q,H)
        cum = torch.cumsum(la[:, rows], dim=1)                  # (B,Q,H)
        # intra-chunk (dual / quadratic) term
        scores = torch.einsum("bin,bjn->bij", ck, bk)           # (B,Q,Q)
        decay = cum[:, :, None, :] - cum[:, None, :, :]         # (B,Qi,Qj,H)
        # mask BEFORE exp: non-causal entries have decay > 0, and
        # where(c, exp(big), 0) leaks NaN through the gradient (inf * 0)
        lmat = torch.exp(torch.where(causal, decay, -1e30))
        dtx = dtk[..., None] * xk                               # (B,Q,H,P)
        # the reference's einsum bij,bijh,bjhp->bihp as a weight
        # (B,Q,Q,H) times a batched matmul: never a (B,Q,Q,H,P) product
        y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * lmat, dtx)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bin,bhnp->bihp", ck, h) \
            * torch.exp(cum)[..., None]
        # new carried state
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)          # (B,Q,H)
        state_upd = torch.einsum("bjn,bjhp->bhnp", bk,
                                 (decay_to_end * dtk)[..., None] * xk)
        h = torch.exp(cum[:, -1, :])[..., None, None] * h + state_upd
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(b, slen, di).to(x.dtype)
    out = _gated_out(params, y, z, x.dtype, axis, s_cfg.d_inner(cfg.d_model))
    return out[:, :orig_len], h


def ssm_prefill(params, cfg, x, cache, axis=None):
    """Forward + populate the decode cache in place: the final state and
    the conv ring's last ``W - 1`` PRE-conv channel values of [x, B, C].
    Returns (out, cache).

    The ring rows are the reference's slice ``[S - (W - 1), S)`` with
    Python's reading of a negative start: a prompt shorter than the ring
    gives fewer rows (one, for ``W = 4``), which the reference's masked
    cache write broadcasts over the whole ring, and so does this one.
    That broadcast is a defect of the reference, kept on purpose so the
    port's sessions give the reference's tokens: the causal conv of the
    model's own forward reads zeros before the prompt, so the right ring
    of a 2-token prompt is [0, x0, x1], not [x1, x1, x1], and the next
    decode step disagrees with a full forward over the same tokens. It
    reaches every ring prefill of an SSM layer under S < W - 1 (decode
    sessions, the launcher's prefill); ROADMAP Queue 3 keeps it open.
    Over a model axis the ring's x channels of those rows are gathered
    from the ranks (the ring replicates)."""
    out, state = _ssm_forward_with_state(params, cfg, x, axis)
    _, xr, br, cr, _ = _project_in(params, x)
    ring = cache["conv"]
    s = x.shape[1]
    rows = slice(s - ring.shape[1], s)
    if mp.active(axis):        # the x channels of those rows, gathered
        tail = torch.cat([mp.all_gather(xr[:, rows], axis, -1), br[:, rows],
                          cr[:, rows]], dim=-1)
    else:
        tail = torch.cat([xr, br, cr], dim=-1)[:, rows]
    ring[:] = to_storage(tail, ring.dtype)
    cache["state"].copy_(state)
    return out, cache


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device="cuda",
                   lead=(), axis=None):
    """One layer's decode cache (``lead`` prepends stacking axes): the
    carried state, f32 whatever ``dtype``, and the conv ring in
    ``dtype``; over a model axis the state of the rank's heads and the
    whole ring."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model) // mp.size(axis)
    conv_ch = di + 2 * s.d_state
    return {
        "state": torch.zeros(lead + (batch, nh, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, cfg, x, cache, axis=None):
    """One-token recurrence. x (B, 1, D) -> (out (B, 1, D), cache), the
    state and conv ring updated in place."""
    s_cfg = cfg.ssm
    params = _local(params, cfg, axis)
    b = x.shape[0]
    m = mp.size(axis)
    di = s_cfg.d_inner(cfg.d_model)            # the ring's x channels
    nh = s_cfg.num_heads(cfg.d_model) // m
    n, p = s_cfg.d_state, s_cfg.head_dim
    dl = di // m                               # the rank's x channels
    x0 = mp.index(axis) * dl

    z, xr, br, cr, dt_raw = _project_in(params, x[:, 0, :])
    # causal conv over the ring of the last (W - 1) inputs + the current
    ring = cache["conv"]
    cur = to_storage(torch.cat([mp.all_gather(xr, axis, -1), br, cr],
                               dim=-1)[:, None, :], ring.dtype)
    hist = torch.cat([ring, cur], dim=1)

    def conv1(seq, w, b_):
        out = torch.einsum("bwc,wc->bc", seq.float(), w.float()) + b_
        return silu(out)

    xh = conv1(hist[..., x0:x0 + dl], params["conv_wx"], params["conv_bx"])
    bvec = conv1(hist[..., di:di + n], params["conv_wB"], params["conv_bB"])
    cvec = conv1(hist[..., di + n:], params["conv_wC"], params["conv_bC"])
    xh = xh.reshape(b, nh, p)
    dt = _softplus(dt_raw.float() + params["dt_bias"])           # (B,H)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a)                                    # (B,H)

    upd = (dt[..., None] * xh)[:, :, None, :] * bvec[:, None, :, None]
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bn,bhnp->bhp", cvec, state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, dl).to(x.dtype)
    out = _gated_out(params, y, z[:, None, :], x.dtype, axis, di)
    ring.copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return out, cache
