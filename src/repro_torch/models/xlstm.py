"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential scan), composed 7:1 as in xLSTM[7:1].

mLSTM parallel form (per head, queries i, keys j ≤ i):

    b_ij = F_i − F_j + log i_j          (F = cumsum of log-sigmoid forget)
    m_i  = max_j b_ij                   (stabilizer)
    ŷ_i  = Σ_j exp(b_ij − m_i) (q_i·k_j/√d) v_j
    n_i  = max(|Σ_j exp(b_ij − m_i)(q_i·k_j/√d)|, exp(−m_i))
    y_i  = ŷ_i / n_i

Prefill and ``forward`` run it through ``kernels/ops.py``
(``mlstm_attention``: the hand-written kernel on a CUDA device,
:func:`_mlstm_parallel` on the CPU); decode runs the recurrent cell with
state (C: d×d matrix, n: d vector, m: scalar) per head. sLSTM is
sequential: a Python loop over time in place of ``lax.scan``.

The f32 islands are the JAX package's: gates, cell state, the per-block
norm and the ``silu(z)`` output gate. Unlike the JAX functions, which
return new state, the blocks write the state they are given in place
(conv prefix, mLSTM cell, sLSTM carry), so a pooled cache is never
reallocated; each returns that same state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import dense_init

NEG_INF = -1e30
State = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               proj_factor: float = 2.0, conv_width: int = 4,
               lead: Sequence[int] = ()) -> dict:
    d_inner = int(proj_factor * d_model)
    hd = d_inner // num_heads
    dev = gen.device

    def headwise():  # block-diagonal per-head projection (H, hd, hd)
        w = torch.randn((*lead, num_heads, hd, hd), generator=gen, device=dev)
        return (w / math.sqrt(hd)).to(dtype)

    b_if = torch.cat([torch.zeros(num_heads, device=dev),
                      3.0 * torch.ones(num_heads, device=dev)])
    return {
        "up_proj": dense_init(gen, d_model, 2 * d_inner, dtype, lead=lead),  # [x | gate z]
        "conv": (torch.randn((*lead, conv_width, d_inner), generator=gen, device=dev)
                 * 0.1).to(dtype),
        "conv_bias": torch.zeros((*lead, d_inner), dtype=dtype, device=dev),
        "wq": headwise(),
        "wk": headwise(),
        "wv": headwise(),
        "w_if": dense_init(gen, d_inner, 2 * num_heads, torch.float32, lead=lead),
        "b_if": b_if.expand(*lead, 2 * num_heads).clone(),
        "norm_scale": torch.ones((*lead, d_inner), dtype=dtype, device=dev),
        "down_proj": dense_init(gen, d_inner, d_model, dtype,
                                scale=1.0 / math.sqrt(d_inner), lead=lead),
    }


def _mlstm_parallel(q, k, v, log_i, log_f, chunk: int = 512) -> torch.Tensor:
    """The plain version. q/k/v: (B,S,H,D); log_i/log_f: (B,S,H) → y
    (B,S,H,D) in q's dtype; f32 inside. Queries go in chunks of ``chunk``
    rows, which bounds the (B, chunk, S, H) temporaries."""
    b, s, h, d = q.shape
    kf = k.float()
    vf = v.float()
    fcum = torch.cumsum(log_f, dim=1)  # (B,S,H) = F_i
    kpos = torch.arange(s, device=q.device)[None, :]

    def attend(q_blk, fcum_q, idx0):
        c = q_blk.shape[1]
        bmat = (fcum_q[:, :, None, :] - fcum[:, None, :, :]
                + log_i[:, None, :, :])  # (B,C,S,H)
        qpos = idx0 + torch.arange(c, device=q.device)[:, None]
        mask = (kpos <= qpos)[None, :, :, None]
        bmat = torch.where(mask, bmat, NEG_INF)
        m = torch.amax(bmat, dim=2)  # (B,C,H)
        dmat = torch.exp(bmat - m[:, :, None, :])
        scores = torch.einsum("bchd,bshd->bcsh", q_blk.float() / math.sqrt(d), kf)
        cmat = scores * dmat
        num = torch.einsum("bcsh,bshd->bchd", cmat, vf)
        den = torch.abs(torch.sum(cmat, dim=2))  # (B,C,H)
        den = torch.maximum(den, torch.exp(-m))
        return num / den[..., None]

    if s <= chunk:
        y = attend(q, fcum, 0)
    else:
        y = torch.cat([attend(q[:, i:i + chunk], fcum[:, i:i + chunk], i)
                       for i in range(0, s, chunk)], dim=1)
    return y.to(q.dtype)


def mlstm_step(state: State, q, k, v, log_i, log_f) -> Tuple[torch.Tensor, State]:
    """Recurrent mLSTM cell, in place. state: {"C": (B,H,D,D), "n": (B,H,D),
    "m": (B,H)} f32; q/k/v: (B,H,D); log_i/log_f: (B,H) → y (B,H,D) f32."""
    b, h, d = q.shape
    qf = q.float() / math.sqrt(d)
    kf = k.float()
    vf = v.float()
    m_new = torch.maximum(log_f + state["m"], log_i)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    i_sc = torch.exp(log_i - m_new)
    c = state["C"]
    c.mul_(f_sc[..., None, None])  # C·f + (i·k) vᵀ, without a second (B,H,D,D)
    c.view(b * h, d, d).baddbmm_((i_sc[..., None] * kf).reshape(b * h, d, 1),
                                 vf.reshape(b * h, 1, d))
    n = state["n"].mul_(f_sc[..., None]).add_(i_sc[..., None] * kf)
    state["m"].copy_(m_new)
    num = torch.matmul(qf[..., None, :], c)[..., 0, :]  # (B,H,D)
    den = torch.maximum(torch.abs(torch.sum(qf * n, dim=-1)), torch.exp(-m_new))
    return num / den[..., None], state


def mlstm_block(p: dict, x: torch.Tensor, num_heads: int,
                state: Optional[dict] = None, chunk: int = 512,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full mLSTM block. x: (B,S,D). A given ``state`` ({"conv", "cell"})
    is read and then overwritten in place with the state after x."""
    b, s, _ = x.shape
    hd = p["wq"].shape[-1]
    d_inner = num_heads * hd

    up = x @ p["up_proj"]
    xi, z = torch.chunk(up, 2, dim=-1)
    # causal conv on the x-branch
    width = p["conv"].shape[0]
    if state is not None:
        padded = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    else:
        padded = F.pad(xi, (0, 0, width - 1, 0))
    xc = sum(padded[:, i:i + s] * p["conv"][i][None, None, :] for i in range(width))
    xc = F.silu(xc + p["conv_bias"][None, None, :])

    xc_h = xc.reshape(b, s, num_heads, hd)
    xi_h = xi.reshape(b, s, num_heads, hd)
    q = torch.einsum("bshd,hde->bshe", xc_h, p["wq"])  # last dim contiguous
    k = torch.einsum("bshd,hde->bshe", xc_h, p["wk"])
    v = torch.einsum("bshd,hde->bshe", xi_h, p["wv"])
    gates = xc.float() @ p["w_if"] + p["b_if"][None, None, :]
    log_i, f_pre = torch.chunk(gates, 2, dim=-1)  # (B,S,H) each
    log_f = F.logsigmoid(f_pre)

    if s == 1 and state is not None:
        y, _ = mlstm_step(state["cell"], q[:, 0], k[:, 0], v[:, 0],
                          log_i[:, 0], log_f[:, 0])
        y = y[:, None]
    else:
        y = kernel_ops.mlstm_attention(q, k, v, log_i, log_f, chunk=chunk)
        if state is not None:  # prefill that must hand off a decode state
            cell = _mlstm_final_state(k, v, log_i, log_f)
            for key, t in cell.items():
                state["cell"][key].copy_(t)
    if state is not None:
        state["conv"].copy_(padded[:, -(width - 1):])
    y = y.reshape(b, s, d_inner)
    # per-block RMS norm + output gating, down-projection
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    yf = yf * F.silu(z.float())
    out = yf.to(x.dtype) @ p["down_proj"]
    return out, state


def _mlstm_final_state(k, v, log_i, log_f) -> State:
    """Fold a whole prefix into the recurrent state (used at prefill→decode)."""
    kf, vf = k.float(), v.float()
    fcum = torch.cumsum(log_f, dim=1)
    ftot = fcum[:, -1]  # (B,H)
    w = ftot[:, None, :] - fcum + log_i  # decay from j to end
    m = torch.amax(w, dim=1)  # (B,H)
    scale = torch.exp(w - m[:, None, :])
    ks = (scale[..., None] * kf).permute(0, 2, 3, 1)  # (B,H,D,S)
    c = torch.matmul(ks, vf.permute(0, 2, 1, 3))  # (B,H,D,E)
    n = torch.einsum("bsh,bshd->bhd", scale, kf)
    return {"C": c, "n": n, "m": m}


def init_mlstm_state(bsz: int, d_model: int, num_heads: int, dtype,
                     proj_factor: float = 2.0, conv_width: int = 4,
                     lead: Sequence[int] = (), device=None) -> dict:
    d_inner = int(proj_factor * d_model)
    hd = d_inner // num_heads
    f32 = torch.float32
    return {
        "conv": torch.zeros((*lead, bsz, conv_width - 1, d_inner), dtype=dtype, device=device),
        "cell": {
            "C": torch.zeros((*lead, bsz, num_heads, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((*lead, bsz, num_heads, hd), dtype=f32, device=device),
            "m": torch.full((*lead, bsz, num_heads), NEG_INF, dtype=f32, device=device),
        },
    }


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               lead: Sequence[int] = ()) -> dict:
    hd = d_model // num_heads
    dev = gen.device
    # fused input weights for z,i,f,o and per-head recurrent weights
    r = torch.randn((*lead, num_heads, hd, 4 * hd), generator=gen, device=dev)
    b = torch.cat([torch.zeros(2 * d_model, device=dev), 3.0 * torch.ones(d_model, device=dev),
                   torch.zeros(d_model, device=dev)])
    return {
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype, lead=lead),
        "r": (r / math.sqrt(hd)).to(dtype),
        "b": b.expand(*lead, 4 * d_model).clone(),
        "norm_scale": torch.ones((*lead, d_model), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_model, d_model, dtype, lead=lead),
    }


def slstm_block(p: dict, x: torch.Tensor, num_heads: int,
                state: Optional[State] = None,
                ) -> Tuple[torch.Tensor, State]:
    """sLSTM block: sequential loop over time. x: (B,S,D). A given
    ``state`` ({"c", "n", "h", "m"}) is the initial carry and is
    overwritten in place with the final one; without it the carry starts
    from ``init_slstm_state`` and the final carry is returned fresh."""
    b, s, d_model = x.shape
    hd = d_model // num_heads
    wx = (x @ p["w_in"]).float()  # (B,S,4D)
    st = state if state is not None else init_slstm_state(b, d_model, num_heads,
                                                          device=x.device)
    rw = p["r"].float()  # (H, hd, 4hd)
    bz, bi, bf, bo = (t.reshape(1, num_heads, hd) for t in torch.chunk(p["b"], 4))

    def rs(a):  # (B, D) -> (B, H, hd)
        return a.reshape(b, num_heads, hd)

    c, n, h, m = st["c"], st["n"], st["h"], st["m"]
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h, rw)  # (B, H, 4hd), [z|i|f|o]
        rz, ri, rf, ro = torch.chunk(rec, 4, dim=-1)
        xz, xi, xf, xo = torch.chunk(wx[:, t], 4, dim=-1)  # each (B, D)
        z = torch.tanh(rs(xz) + rz + bz)
        log_i = rs(xi) + ri + bi
        log_f = F.logsigmoid(rs(xf) + rf + bf)
        o = torch.sigmoid(rs(xo) + ro + bo)
        m_new = torch.maximum(log_f + m, log_i)  # per-unit stabilizer
        i_sc = torch.exp(log_i - m_new)
        f_sc = torch.exp(log_f + m - m_new)
        c = f_sc * c + i_sc * z
        n = f_sc * n + i_sc
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d_model)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = yf.to(x.dtype) @ p["out_proj"]
    final = {"c": c, "n": n, "h": h, "m": m}
    if state is None:
        return out, final
    for key, t in final.items():
        state[key].copy_(t)
    return out, state


def init_slstm_state(bsz: int, d_model: int, num_heads: int,
                     lead: Sequence[int] = (), device=None) -> State:
    hd = d_model // num_heads
    return {key: torch.zeros((*lead, bsz, num_heads, hd), dtype=torch.float32, device=device)
            for key in ("c", "n", "h", "m")}
