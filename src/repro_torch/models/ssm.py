"""Mamba2 — state-space duality (SSD) blocks [arXiv:2405.21060].

The chunked SSD algorithm (intra-chunk quadratic + inter-chunk state
recurrence) for prefill, and the O(1)-state recurrent step for decode. The
SSM state stays f32; B/C projections are grouped with n_groups = 1, as the
JAX package asserts. Mixed-dtype products are promoted to f32 where
``jnp``'s type promotion does, so bf16 runs round where the JAX package's
do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64  # P
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


def init_mamba2(generator, d_model: int, cfg: SSMConfig, dtype=torch.float32,
                device="cuda") -> Dict[str, Tensor]:
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    conv_dim = di + 2 * gn

    def init(shape):
        return dense_init(generator, shape, 0, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in_z": init((d_model, di)),
        "w_in_x": init((d_model, di)),
        "w_bc": init((d_model, 2 * gn)),
        "w_dt": init((d_model, nh)),
        "dt_bias": torch.zeros((nh,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),  # A = -exp(A_log)
        "D_skip": torch.ones((nh,), **f32),
        "conv_w": init((cfg.d_conv, conv_dim)),
        "norm": torch.zeros((di,), **f32),
        "w_out": init((di, d_model)),
    }


def _softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) without a cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(x: Tensor) -> Tensor:
    """(..., T) -> (..., T, T) cumulative segment sums; upper triangle -inf."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(
    x: Tensor,  # (B, S, H, P) — already dt-scaled inputs
    a_dt: Tensor,  # (B, S, H) — dt * A (negative), f32
    b: Tensor,  # (B, S, G, N)
    c: Tensor,  # (B, S, G, N)
    chunk: int,
    h0: Optional[Tensor] = None,  # (B, H, P, N)
) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) f32). The quadratic decay matrix exists for one chunk at a
    time."""
    B, S, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    if G != 1:
        raise ValueError("ssd_chunked supports n_groups=1 (the mamba2 default)")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    xc = x.float().reshape(B, nc, chunk, H, Pd)
    bc_ = b.float().reshape(B, nc, chunk, N)
    cc_ = c.float().reshape(B, nc, chunk, N)
    ac_ = a_dt.float().reshape(B, nc, chunk, H).transpose(2, 3)  # (B,nc,H,l)

    h = h0.float() if h0 is not None else x.new_zeros((B, H, Pd, N), dtype=torch.float32)
    ys = []
    for i in range(nc):
        xk, bk, ck, ak = xc[:, i], bc_[:, i], cc_[:, i], ac_[:, i]
        a_cum = torch.cumsum(ak, dim=-1)  # (B,H,l)
        L = torch.exp(_segsum(ak))  # (B,H,l,l) — one chunk only
        y_diag = torch.einsum("bln,bsn,bhls,bshp->blhp", ck, bk, L, xk)
        # this chunk's inputs into the carried state
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,l)
        contrib = torch.einsum("bln,bhl,blhp->bhpn", bk, decay_states, xk)
        # the carried state into this chunk's outputs
        y_off = torch.einsum("bln,bhpn,bhl->blhp", ck, h, torch.exp(a_cum))
        h = h * torch.exp(a_cum[..., -1])[..., None, None] + contrib
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.stack(ys, 1).reshape(B, S, H, Pd), h


def _split_proj(params, x: Tensor):
    """x: (B,S,D) -> z, xbc (the conv input), dt (pre-activation)."""
    z = torch.einsum("bsd,de->bse", x, params["w_in_z"])
    xi = torch.einsum("bsd,de->bse", x, params["w_in_x"])
    bc = torch.einsum("bsd,de->bse", x, params["w_bc"])
    dt = torch.einsum("bsd,dh->bsh", x, params["w_dt"])
    return z, torch.cat([xi, bc], dim=-1), dt


def _out_proj(params, y: Tensor, z: Tensor, dtype) -> Tensor:
    """Gate by silu(z), norm, project out; in y's dtype promoted with the
    weights' (f32 when y is), cast to ``dtype``."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    w = params["w_out"]
    ct = torch.promote_types(y.dtype, w.dtype)
    return torch.einsum("bse,ed->bsd", y.to(ct), w.to(ct)).to(dtype)


def mamba2_block(
    params,
    x: Tensor,  # (B, S, D)
    cfg: SSMConfig,
    state: Optional[Tuple[Tensor, Tensor]] = None,  # (conv_state, ssm_state)
    return_state: bool = False,
):
    """Prefill forward; ``state`` / ``return_state`` are used by serving."""
    B, S, D = x.shape
    di = cfg.d_inner(D)
    nh = cfg.n_heads(D)
    gn = cfg.n_groups * cfg.d_state

    z, xbc, dt = _split_proj(params, x)
    # causal depthwise conv (kernel d_conv) over the sequence
    if state is not None:
        conv_in = torch.cat([state[0].to(xbc.dtype), xbc], dim=1)
    else:
        conv_in = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    windows = torch.stack([conv_in[:, i: i + S, :] for i in range(cfg.d_conv)], dim=-1)
    xbc = F.silu(torch.einsum("bsck,kc->bsc", windows, params["conv_w"]))
    new_conv_state = conv_in[:, -(cfg.d_conv - 1):, :] if return_state else None

    xi = xbc[..., :di].reshape(B, S, nh, cfg.head_dim)
    bmat = xbc[..., di: di + gn].reshape(B, S, cfg.n_groups, cfg.d_state)
    cmat = xbc[..., di + gn:].reshape(B, S, cfg.n_groups, cfg.d_state)

    dt = _softplus(dt.float() + params["dt_bias"])  # (B,S,H)
    A = -torch.exp(params["A_log"])  # (H,)
    a_dt = dt * A  # (B,S,H)
    x_scaled = (xi.float() * dt[..., None]).to(xi.dtype)

    # pad S up to a chunk multiple: zero inputs and zero decay (a_dt = 0),
    # so outputs and state are exact
    chunk = min(cfg.chunk, S)
    pad = (S + chunk - 1) // chunk * chunk - S
    if pad:
        x_scaled = F.pad(x_scaled, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))

    h0 = state[1] if state is not None else None
    y, h_final = ssd_chunked(x_scaled, a_dt, bmat, cmat, chunk, h0=h0)
    y = y[:, :S]
    y = y + xi * params["D_skip"][None, None, :, None]  # f32 (D_skip is)
    out = _out_proj(params, y.reshape(B, S, di), z, x.dtype)
    if return_state:
        return out, (new_conv_state, h_final)
    return out


def mamba2_decode_step(
    params,
    x: Tensor,  # (B, 1, D)
    cfg: SSMConfig,
    state: Tuple[Tensor, Tensor],  # conv_state (B, d_conv-1, conv_dim), ssm (B,H,P,N)
):
    """Single-token recurrent step: h' = h·exp(dtA) + dt·x ⊗ B ; y = C·h."""
    B, _, D = x.shape
    di = cfg.d_inner(D)
    nh = cfg.n_heads(D)
    gn = cfg.n_groups * cfg.d_state
    conv_state, h = state

    z, xbc, dt = _split_proj(params, x)  # (B,1,*)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,d_conv,cd)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"]))
    new_conv = window[:, 1:, :]

    xi = xbc_t[:, :di].reshape(B, nh, cfg.head_dim)
    rep = nh // cfg.n_groups
    bvec = xbc_t[:, di: di + gn].reshape(B, cfg.n_groups, cfg.d_state).repeat_interleave(rep, 1)
    cvec = xbc_t[:, di + gn:].reshape(B, cfg.n_groups, cfg.d_state).repeat_interleave(rep, 1)

    dt_t = _softplus(dt[:, 0].float() + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt_t * A)  # (B,H)
    x_dt = xi.float() * dt_t[..., None]  # (B,H,P)
    h = h * decay[..., None, None] + torch.einsum("bhp,bhn->bhpn", x_dt, bvec.float())
    y = torch.einsum("bhpn,bhn->bhp", h, cvec.float())
    y = y + xi.float() * params["D_skip"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    return _out_proj(params, y, z, x.dtype), (new_conv, h)


def init_mamba2_state(cfg: SSMConfig, d_model: int, batch: int, dtype=torch.float32,
                      device="cuda"):
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    return (
        torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        torch.zeros((batch, nh, cfg.head_dim, cfg.d_state), dtype=torch.float32, device=device),
    )
