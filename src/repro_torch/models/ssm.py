"""Mamba-2 (SSD) blocks: chunked parallel scan for prefill, O(1)
recurrent step for decode.

The SSD form (Dao & Gu, 2024) computes, per head with state size N and
head dim P:

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D · x_t

Prefill and ``forward`` run the scan through ``kernels/ops.py``
(``ssd_scan``: the hand-written kernel on a CUDA device, the plain
:func:`ssd_chunked` on the CPU) and fold the prompt into the decode state
with :func:`_ssd_final_state` beside it, because the kernel, like the TPU
kernel it replaces, takes no initial state and returns no final one. A
decode step runs everything between the two projections through
``kernel_ops.mamba2_step``: the fused decode-step kernel on a CUDA device,
the plain :func:`mamba2_mix` (its state update :func:`ssd_step`) on the CPU.
``ssd_chunked`` with an ``h0`` stays as the oracle. B and C are shared by
every head, ``(B, S, N)`` (one group, the JAX package's layout), or given
per group, ``(B, S, G, N)``: head h reads group ``h // (H / G)``, as
Zamba2-7B's two groups of 56 heads. The one-group path is the JAX
package's arithmetic, unchanged.

The f32 islands are the JAX package's: dt, the decays, the state and the
gated RMS norm. Unlike the JAX functions, which return new state,
:func:`mamba2_forward` writes the state it is given in place.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import by_group
from repro_torch.models.layers import dense_init


def init_mamba2(gen: torch.Generator, d_model: int, d_state: int, dtype,
                expand: int = 2, head_dim: int = 64, conv_width: int = 4,
                lead: Sequence[int] = (), groups: int = 1) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * groups * d_state  # x, B, C all pass the causal conv
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev))
    return {
        # fused input projection: [z, x, B, C, dt]; B and C (G, N) each
        "in_proj": dense_init(gen, d_model, d_inner + conv_dim + n_heads, dtype,
                              lead=lead),
        "conv": (torch.randn((*lead, conv_width, conv_dim), generator=gen, device=dev)
                 * 0.1).to(dtype),
        "conv_bias": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "a_log": a_log.expand(*lead, n_heads).clone(),
        "dt_bias": torch.zeros((*lead, n_heads), device=dev),
        "d_skip": torch.ones((*lead, n_heads), device=dev),
        "norm_scale": torch.ones((*lead, d_inner), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, d_model, dtype,
                               scale=1.0 / math.sqrt(d_inner), lead=lead),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': out[..., i, j] = sum_{k=j+1..i} x[..., k], -inf for j>i."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the plain version behind the kernel).

    Shapes: x (B,S,H,P); dt (B,S,H) (already softplus'd, >0); a (H,)
    (negative); b, c (B,S,N) shared across heads, or (B,S,G,N) per group;
    h0 optional (B,H,P,N). Returns (y (B,S,H,P), h_final (B,H,P,N) f32).

    As in the JAX package, the (Q×Q) weights and the state injection are
    rounded to the model dtype before their products, which accumulate in
    f32 (a bf16 × bf16 product is exact in f32).
    """
    if b.dim() == 4:
        return by_group(ssd_chunked, x, dt, a, b, c, chunk=chunk, h0=h0)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = math.ceil(s / chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    f32 = torch.float32
    xf = x.reshape(bs, nc, chunk, h, p).to(f32)
    dtf = dt.to(f32).reshape(bs, nc, chunk, h)
    bf = b.reshape(bs, nc, chunk, n).to(f32)
    cf = c.reshape(bs, nc, chunk, n).to(f32)

    da = dtf * a[None, None, None, :]  # (B,C,Q,H) log-decay per step
    da_cum = torch.cumsum(da, dim=2)  # within-chunk cumulative
    da_total = da_cum[:, :, -1, :]  # (B,C,H)

    # 1) intra-chunk (quadratic) term
    l = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # (B,C,H,Q,Q) f32
    cb = torch.einsum("bzqn,bzkn->bzqk", cf, bf)  # (B,C,Q,Q)
    w = (cb[:, :, None] * l * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]
         ).to(x.dtype).to(f32)  # (B,C,H,Q,Q) — one f32 product, read back at x's dtype
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", w, xf)

    # 2) per-chunk final states: decay from position to chunk end
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cum)  # (B,C,Q,H)
    bw = (bf[:, :, :, None, :] * (decay_to_end * dtf)[..., None]
          ).to(x.dtype).to(f32)  # (B,C,Q,H,N)
    states = torch.einsum("bzqhn,bzqhp->bzhpn", bw, xf)  # (B,C,H,P,N)

    # 3) inter-chunk recurrence (a loop over the chunk axis)
    h_cur = h0.to(f32) if h0 is not None else x.new_zeros((bs, h, p, n), dtype=f32)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h_cur)
        h_cur = h_cur * torch.exp(da_total[:, z])[:, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,C,H,P,N) state entering chunk

    # 4) state-to-output: decay from chunk start to position
    decay_from_start = torch.exp(da_cum)  # (B,C,Q,H)
    y_off = torch.einsum("bzqn,bzqh,bzhpn->bzqhp", cf, decay_from_start, h_prev)

    y = (y_diag + y_off).reshape(bs, nc * chunk, h, p)
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), h_cur


def _ssd_final_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The state after a whole sequence from a zero state (prefill→decode).

    h[b,h,p,n] = Σ_s x[b,s,h,p] · exp(ΣΔ_total − ΣΔ_s) · dt[b,s,h] · B[b,s,n],
    Δ = dt·a, as one batched matmul in f32. ``ΣΔ_total − ΣΔ_s`` is summed
    directly (the sum of Δ after s), so no large cumulative sums cancel.
    x (B,S,H,P); dt (B,S,H) f32; a (H,); b (B,S,N) or (B,S,G,N) →
    (B,H,P,N) f32.
    """
    da = dt.float() * a.float()[None, None, :]  # (B,S,H)
    after = torch.flip(torch.cumsum(torch.flip(da, [1]), 1), [1])  # Σ_{j ≥ s}
    after = F.pad(after[:, 1:], (0, 0, 0, 1))  # Σ_{j > s}
    w = torch.exp(after) * dt.float()  # (B,S,H)
    xw = (x.float() * w[..., None]).permute(0, 2, 3, 1)  # (B,H,P,S)
    if b.dim() == 3:
        return torch.matmul(xw, b.float()[:, None])  # (B,H,P,N)
    bs, h, p, s = xw.shape
    g = b.shape[2]
    bg = b.float().permute(0, 2, 1, 3)[:, :, None]  # (B,G,1,S,N)
    return torch.matmul(xw.reshape(bs, g, h // g, p, s), bg).reshape(bs, h, p, -1)


def ssd_reference(x, dt, a, b, c, h0=None):
    """Sequential per-step oracle (slow; tests only). b, c (B,S,N) or
    (B,S,G,N)."""
    if b.dim() == 4:
        return by_group(ssd_reference, x, dt, a, b, c, h0=h0)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    hstate = (h0.float() if h0 is not None
              else x.new_zeros((bs, h, p, n), dtype=torch.float32))
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()  # (B,H)
        decay = torch.exp(dtt * a[None, :])  # (B,H)
        inject = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].float(), b[:, t].float())
        hstate = hstate * decay[:, :, None, None] + inject
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, c[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), hstate


def ssd_step(hstate, x_t, dt_t, a, b_t, c_t):
    """One decode step, in place. hstate (B,H,P,N) f32; x_t (B,H,P);
    dt_t (B,H); b_t, c_t (B,N), or (B,G,N) per group. Returns
    (y_t (B,H,P) f32, hstate)."""
    bs, h, p, n = hstate.shape
    dtf = dt_t.float()
    hstate.mul_(torch.exp(dtf * a[None, :])[:, :, None, None])
    inject_x = (dtf[..., None] * x_t.float()).reshape(bs * h, p, 1)
    if b_t.dim() == 2:  # one group
        b_t, c_t = b_t[:, None], c_t[:, None]
    g = b_t.shape[1]
    inject_b = b_t.float()[:, :, None, None, :].expand(bs, g, h // g, 1, n).reshape(bs * h, 1, n)
    hstate.view(bs * h, p, n).baddbmm_(inject_x, inject_b)  # h·decay + dt x ⊗ B
    y = torch.matmul(hstate.view(bs, g, h // g, p, n), c_t.float()[:, :, None, :, None])
    return y.reshape(bs, h, p), hstate


# --------------------------------------------------------------- full block
def _causal_conv(seq: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. seq (B,S,C); w (W,C). Returns (out, new_state)
    where state carries the last W-1 inputs for streaming decode. The taps
    sum in the model dtype, in the JAX package's order."""
    width = w.shape[0]
    if state is None:
        full = F.pad(seq, (0, 0, width - 1, 0))
    else:
        full = torch.cat([state.to(seq.dtype), seq], dim=1)
    s = seq.shape[1]
    out = sum(full[:, i:i + s] * w[i][None, None, :] for i in range(width))
    new_state = full[:, -(width - 1):] if width > 1 else None
    return out + bias[None, None, :], new_state


def mamba2_forward(p: dict, x: torch.Tensor, *, d_state: int, head_dim: int = 64,
                   chunk: int = 128, state: Optional[dict] = None,
                   step: bool = False, groups: int = 1,
                   norm_eps: float = 1e-6) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba-2 mixer. x: (B, S, D) → (B, S, D).

    ``state`` ({"h": (B,H,P,N) f32, "conv": (B,W-1,C)}) is overwritten in
    place with the state after x. With ``step`` x is one token that
    continues from that state through ``kernel_ops.mamba2_step`` (the fused
    decode-step kernel on a CUDA device; on the CPU :func:`mamba2_mix`,
    whose state update is :func:`ssd_step`); otherwise x is a
    whole prompt and starts from a zero state and a zero conv prefix,
    reading nothing of ``state`` — so a reused state needs no reset. (The
    JAX function continues from a given state either way.) With
    ``groups`` > 1, B and C are given per group and the gated RMS norm
    normalises each group's ``d_inner / groups`` channels on its own
    (Zamba2's ``Zamba2RMSNormGated``), with ``norm_eps``.
    Returns (out, state).
    """
    if step and (x.shape[1] != 1 or state is None):
        raise ValueError("a decode step takes one token and a state")
    zxbcdt = x @ p["in_proj"]
    if step:
        y = kernel_ops.mamba2_step(zxbcdt, p["conv"], p["conv_bias"], p["dt_bias"],
                                   p["a_log"], p["d_skip"], p["norm_scale"], state["h"],
                                   state["conv"], groups=groups, eps=norm_eps)
    else:
        y = mamba2_mix(p, zxbcdt, d_state=d_state, head_dim=head_dim, chunk=chunk,
                       state=state, groups=groups, norm_eps=norm_eps)
    return y @ p["out_proj"], state


def mamba2_mix(p: dict, zxbcdt: torch.Tensor, *, d_state: int, head_dim: int = 64,
               chunk: int = 128, state: Optional[dict] = None, step: bool = False,
               groups: int = 1, norm_eps: float = 1e-6) -> torch.Tensor:
    """The mixer between the projections: the in_proj output ``zxbcdt``
    (B, S, [z | x | B | C | dt]) → the gated, normalised y (B, S, d_inner)
    in its dtype, which out_proj reads; ``state`` as in
    :func:`mamba2_forward`. With ``step`` it is the plain version of
    ``kernel_ops.mamba2_step`` (``kernels/ref.py``), the CPU path and the
    oracle of the fused decode-step kernel."""
    bsz, s, _ = zxbcdt.shape
    d_inner = p["norm_scale"].shape[0]
    n_heads = p["a_log"].shape[0]
    z = zxbcdt[..., :d_inner]
    gn = groups * d_state
    conv_in = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]  # [x | B | C]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    conv_out, conv_state = _causal_conv(conv_in, p["conv"], p["conv_bias"],
                                        state["conv"] if step else None)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :d_inner]
    b = conv_out[..., d_inner:d_inner + gn]
    c = conv_out[..., d_inner + gn:]
    if groups > 1:  # views (B, S, G, N): the kernel reads strides
        b = b.unflatten(-1, (groups, d_state))
        c = c.unflatten(-1, (groups, d_state))

    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])  # (H,) negative decay rates
    xh = xin.reshape(bsz, s, n_heads, head_dim)  # a view: the kernel reads strides

    if step:
        y, _ = ssd_step(state["h"], xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0])
        y = y[:, None]  # f32, as the JAX step leaves it
    else:
        y = kernel_ops.ssd_scan(xh, dt, a, b, c, chunk=chunk)
        if state is not None:  # prefill that hands off a decode state
            state["h"].copy_(_ssd_final_state(xh, dt, a, b))
    if state is not None:
        state["conv"].copy_(conv_state)
    y = y + xh.to(y.dtype) * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, s, d_inner)

    # gated RMS norm (mamba2's norm-before-out-proj, gated by z)
    yf = (y.float() * F.silu(z.float())).unflatten(-1, (groups, d_inner // groups))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = (yf * torch.rsqrt(var + norm_eps)).flatten(-2) * p["norm_scale"].float()
    return yf.to(zxbcdt.dtype)


def init_mamba2_state(bsz: int, d_model: int, d_state: int, dtype,
                      expand: int = 2, head_dim: int = 64, conv_width: int = 4,
                      lead: Sequence[int] = (), device=None) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return {
        "h": torch.zeros((*lead, bsz, n_heads, head_dim, d_state), device=device),
        "conv": torch.zeros((*lead, bsz, conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }
