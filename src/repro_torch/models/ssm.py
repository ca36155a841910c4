"""Mamba2 — state-space duality (SSD) blocks [arXiv:2405.21060].

The chunked SSD algorithm (intra-chunk quadratic + inter-chunk state
recurrence) for prefill, and the O(1)-state recurrent step for decode. The
SSM state stays f32; B/C projections are grouped with n_groups = 1, as the
JAX package asserts. Mixed-dtype products are promoted to f32 where
``jnp``'s type promotion does, so bf16 runs round where the JAX package's
do.

Tensor parallelism over a mesh's "model" axis (``mesh`` given, ``params``
this rank's slices under ``mamba2_specs``): the program the JAX package's
GSPMD compiles from those specs. A rank holds its d_inner columns of
``w_in_z``/``w_in_x``/``norm``, its heads of ``w_dt``/``dt_bias``/
``A_log``/``D_skip``, its rows of ``w_out``, and ``w_bc`` and ``conv_w``
whole. It convolves its own x channels (``conv_w``'s matching columns)
and the whole B/C channels, scans its heads, normalises the gated output
over the WHOLE d_inner (each rank's f32 sum of squares summed over
"model" in axis order), and the row-parallel ``w_out`` gives f32 partials
summed over "model" and rounded once. Where the heads do not divide the
axis but d_inner does, the x channels are gathered before the scan, every
rank scans every head, and keeps its columns after it; where d_inner does
not divide, everything is whole and the one-card code runs. The decode
cache keeps ``cache_specs``' layout: the conv window whole on every rank
(each tick gathers the new x column over "model"), the SSM state split
over heads. Under autograd the block's input enters the column-split
projections through ``collectives.enter``; B and C enter the per-head
scan the same way (each rank's heads give a part of their cotangent), and
the x columns of the replicated ``conv_w`` are taken by
``collectives.take_block``, whose backward gathers the whole gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives as C
from .common import MODEL_AX, Spec, dense_init, rms_norm

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


def mamba2_specs(cfg: SSMConfig, d_model: int = 0, tp: int = 1) -> Dict[str, Spec]:
    """The JAX package's TP specs: heads and d_inner over "model" (each
    where it divides); B/C and the mixed conv stay whole."""
    di = cfg.d_inner(d_model) if d_model else 0
    nh = cfg.n_heads(d_model) if d_model else 0
    di_ax = MODEL_AX if tp > 1 and di % tp == 0 and di > 0 else None
    h_ax = MODEL_AX if tp > 1 and nh % tp == 0 and nh > 0 else None
    return {
        "w_in_z": Spec(None, di_ax),
        "w_in_x": Spec(None, di_ax),
        "w_bc": Spec(None, None),
        "w_dt": Spec(None, h_ax),
        "dt_bias": Spec(h_ax),
        "A_log": Spec(h_ax),
        "D_skip": Spec(h_ax),
        "conv_w": Spec(None, None),
        "norm": Spec(di_ax),
        "w_out": Spec(di_ax, None),
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


def _split(mesh, specs) -> Tuple[bool, bool]:
    """(d_inner split over "model", heads split over "model")."""
    if mesh is None or mesh.axis_size(MODEL_AX) == 1:
        return False, False
    return specs["w_in_x"][1] == MODEL_AX, specs["w_dt"][1] == MODEL_AX


def _split_proj(params, x: Tensor, mesh=None, di_sh: bool = False, h_sh: bool = False):
    """x: (B,S,D) -> z, the x channels, B|C, dt (pre-activation); on a
    mesh this rank's columns of each split one."""
    xs = C.enter(mesh, x, MODEL_AX) if di_sh else x  # the column-split region
    z = torch.einsum("bsd,de->bse", xs, params["w_in_z"])
    xi = torch.einsum("bsd,de->bse", xs, params["w_in_x"])
    bc = torch.einsum("bsd,de->bse", x, params["w_bc"])
    dt = torch.einsum("bsd,dh->bsh", xs if h_sh else x, params["w_dt"])
    return z, xi, bc, dt


def _rms_norm_whole(mesh, x: Tensor, scale: Tensor, n: int, eps: float = 1e-6) -> Tensor:
    """``rms_norm`` over a last dimension of ``n`` split over "model": each
    rank's f32 sum of squares summed over the axis in order, each rank
    scaling its own columns by its slice of ``scale``."""
    xf = x.float()
    var = C.all_reduce(mesh, xf.square().sum(-1, keepdim=True), MODEL_AX) / n
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def _out_proj(params, y: Tensor, z: Tensor, dtype, mesh=None, d_inner: int = 0) -> Tensor:
    """Gate by silu(z), norm, project out; in y's dtype promoted with the
    weights' (f32 when y is), cast to ``dtype``. With ``mesh`` (d_inner
    split): the norm over the whole ``d_inner``, and the row-parallel
    ``w_out``'s f32 partials summed over "model" and rounded once."""
    g = y * F.silu(z.float()).to(y.dtype)
    w = params["w_out"]
    if mesh is not None:
        g = _rms_norm_whole(mesh, g, params["norm"], d_inner)
        part = torch.einsum("bse,ed->bsd", g.float(), w.float())
        return C.sum_partials(mesh, part, MODEL_AX).to(dtype)
    g = rms_norm(g, params["norm"])
    ct = torch.promote_types(g.dtype, w.dtype)
    return torch.einsum("bse,ed->bsd", g.to(ct), w.to(ct)).to(dtype)


def mamba2_block(
    params,
    x: Tensor,  # (B, S, D)
    cfg: SSMConfig,
    state: Optional[Tuple[Tensor, Tensor]] = None,  # (conv_state, ssm_state)
    return_state: bool = False,
    mesh=None,
    specs: Optional[Dict[str, Spec]] = None,
):
    """Prefill forward; ``state`` / ``return_state`` are used by serving.
    ``mesh``/``specs``: see the module docstring (the conv state whole,
    the SSM state this rank's heads)."""
    B, S, D = x.shape
    di = cfg.d_inner(D)
    gn = cfg.n_groups * cfg.d_state
    di_sh, h_sh = _split(mesh, specs)

    z, xi, bc, dt = _split_proj(params, x, mesh, di_sh, h_sh)
    di_loc = xi.shape[-1]
    conv_w = params["conv_w"]
    if di_sh:  # this rank's x columns of the replicated conv, and B|C's
        conv_w = torch.cat([C.take_block(mesh, conv_w[:, :di], MODEL_AX, 1), conv_w[:, di:]], 1)
    xbc = torch.cat([xi, bc], dim=-1)
    # causal depthwise conv (kernel d_conv) over the sequence
    if state is not None:
        prev = state[0]
        if di_sh:
            prev = torch.cat([C.take_block(mesh, prev[..., :di], MODEL_AX, 2), prev[..., di:]], -1)
        conv_in = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    else:
        conv_in = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    windows = torch.stack([conv_in[:, i: i + S, :] for i in range(cfg.d_conv)], dim=-1)
    xbc = F.silu(torch.einsum("bsck,kc->bsc", windows, conv_w))
    new_conv_state = None
    if return_state:
        new_conv_state = conv_in[:, -(cfg.d_conv - 1):, :]
        if di_sh:  # whole on every rank, as cache_specs keeps it
            new_conv_state = torch.cat([C.gather(mesh, new_conv_state[..., :di_loc], MODEL_AX, 2),
                                        new_conv_state[..., di_loc:]], -1)

    xi = xbc[..., :di_loc]
    bmat = xbc[..., di_loc: di_loc + gn].reshape(B, S, cfg.n_groups, cfg.d_state)
    cmat = xbc[..., di_loc + gn:].reshape(B, S, cfg.n_groups, cfg.d_state)
    if di_sh and not h_sh:  # whole heads: every rank scans every head
        xi = C.gather(mesh, xi, MODEL_AX, 2)
    if h_sh:  # each rank's heads give a part of B's and C's cotangents
        bmat, cmat = C.enter(mesh, bmat, MODEL_AX), C.enter(mesh, cmat, MODEL_AX)
    nh = xi.shape[-1] // cfg.head_dim
    xi = xi.reshape(B, S, nh, cfg.head_dim)

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
    y = y.reshape(B, S, nh * cfg.head_dim)
    if di_sh and not h_sh:  # back to this rank's columns
        y = C.take_block(mesh, y, MODEL_AX, 2)
    out = _out_proj(params, y, z, x.dtype, mesh if di_sh else None, di)
    if return_state:
        return out, (new_conv_state, h_final)
    return out


def mamba2_decode_step(
    params,
    x: Tensor,  # (B, 1, D)
    cfg: SSMConfig,
    state: Tuple[Tensor, Tensor],  # conv_state (B, d_conv-1, conv_dim), ssm (B,H,P,N)
    mesh=None,
    specs: Optional[Dict[str, Spec]] = None,
):
    """Single-token recurrent step: h' = h·exp(dtA) + dt·x ⊗ B ; y = C·h.
    ``mesh``/``specs``: see the module docstring; the new x column is
    gathered, so every rank convolves the whole window (as one card) and
    keeps its heads."""
    B, _, D = x.shape
    di = cfg.d_inner(D)
    gn = cfg.n_groups * cfg.d_state
    di_sh, h_sh = _split(mesh, specs)
    conv_state, h = state

    z, xi, bc, dt = _split_proj(params, x, mesh, di_sh, h_sh)  # (B,1,*)
    if di_sh:
        xi = C.gather(mesh, xi, MODEL_AX, 2)
    xbc = torch.cat([xi, bc], dim=-1)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,d_conv,cd)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"]))
    new_conv = window[:, 1:, :]

    xi = C.take_block(mesh, xbc_t[:, :di], MODEL_AX, 1) if h_sh else xbc_t[:, :di]
    nh = xi.shape[-1] // cfg.head_dim
    xi = xi.reshape(B, nh, cfg.head_dim)
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
    y = y.reshape(B, 1, nh * cfg.head_dim).to(x.dtype)
    if di_sh and not h_sh:  # this rank's columns
        y = C.take_block(mesh, y, MODEL_AX, 2)
    return _out_proj(params, y, z, x.dtype, mesh if di_sh else None, di), (new_conv, h)


def init_mamba2_state(cfg: SSMConfig, d_model: int, batch: int, dtype=torch.float32,
                      device="cuda"):
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    return (
        torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        torch.zeros((batch, nh, cfg.head_dim, cfg.d_state), dtype=torch.float32, device=device),
    )
