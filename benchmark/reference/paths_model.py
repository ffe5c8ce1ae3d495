"""Plain PyTorch reference of the PATHS hierarchical model, one slide at a
time: no batching, no padding, no kernels, no feature tables.

Parameters are a dict keyed as the flat parameter files of PATHS models
(`procs/<depth>/...`, `lstm/...`), Linear weights stored (in, out). The
reference works everything out again from the raw feature grids: the
level-0 bag (every grid cell, background included), the importance top-K
(ties to the lowest bag index), the x4 children in quadrant order, the
background test on the next grid (an all-zero feature row), the
all-background fallback, and the 2-D positional encoding of grid
coordinates.

Where two importances at the top-K boundary differ by less than `tau`, the
order between them is rounding, not the model: `descend` follows every such
order and returns one result per order, and the judge takes the one nearest
to what it judges (`TIE_TAU`).

It imports nothing of the program under test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# importances within this of each other at the top-K boundary are a tie:
# an f32 program's importance lies within about 1e-6 of the f64 reference's
TIE_TAU = 1e-4
MAX_ORDERS = 16


@dataclass(frozen=True)
class Dims:
    """The sizes the reference needs, from a configuration file's `model`."""
    d: int            # patch_embed_dim
    t: int            # trans_dim
    heads: int
    layers: int
    imp_hidden: int
    ctx_hidden: int   # hierarchical_ctx_mlp_hidden_dim (the LSTM's memory)
    levels: int
    top_k: int
    patch: int
    n_logits: int

    @staticmethod
    def of(model: dict) -> "Dims":
        mc = model["model_config"]
        for key, want in (("lstm", True), ("hierarchical_ctx", True),
                          ("pos_encoding_mode", "2d"),
                          ("slide_ctx_mode", "residual"),
                          ("importance_mode", "mul")):
            if mc[key] != want:
                raise ValueError(f"the reference covers {key}={want!r}")
        if model["task"] != "survival":
            raise ValueError("the reference covers the survival task")
        k = model["top_k_patches"]
        return Dims(d=mc["patch_embed_dim"], t=mc["trans_dim"],
                    heads=mc["trans_heads"], layers=mc["trans_layers"],
                    imp_hidden=mc["importance_mlp_hidden_dim"],
                    ctx_hidden=mc["hierarchical_ctx_mlp_hidden_dim"],
                    levels=model["num_levels"],
                    top_k=k if isinstance(k, int) else k[0],
                    patch=mc["patch_size"], n_logits=model["nbins"])


def param_specs(dims: Dims) -> Dict[str, tuple]:
    """name -> (shape, init, fan_in): every parameter of the model, in the
    flat layout. init is "uniform" (+-1/sqrt(fan_in)), "normal", "ones" or
    "zeros". The encoder stacks and the cross-attention projections are
    parameters the model holds and never uses (the conditional sequence is
    empty)."""
    specs: Dict[str, tuple] = {}

    def linear(name, n_in, n_out):
        specs[f"{name}/w"] = ((n_in, n_out), "uniform", n_in)
        specs[f"{name}/b"] = ((n_out,), "uniform", n_in)

    def norm(name, n):
        specs[f"{name}/scale"] = ((n,), "ones", 0)
        specs[f"{name}/bias"] = ((n,), "zeros", 0)

    t = dims.t
    for depth in range(dims.levels):
        pre = f"procs/{depth}"
        linear(f"{pre}/classification", t, dims.n_logits)
        linear(f"{pre}/importance_mlp/layers/0", dims.d, dims.imp_hidden)
        linear(f"{pre}/importance_mlp/layers/1", dims.imp_hidden, 1)
        specs[f"{pre}/agg/special_token"] = ((t,), "normal", 0)
        linear(f"{pre}/agg/proj_in", dims.d, t)
        for stack, attns, norms in (("encoder", ("self_attn",), 2),
                                    ("decoder", ("self_attn", "cross_attn"), 3)):
            for i in range(dims.layers):
                lp = f"{pre}/agg/transformer/{stack}/layers/{i}"
                for a in attns:
                    for proj in ("q", "k", "v", "out"):
                        linear(f"{lp}/{a}/{proj}", t, t)
                linear(f"{lp}/ff/lin1", t, 4 * t)
                linear(f"{lp}/ff/lin2", 4 * t, t)
                for j in range(1, norms + 1):
                    norm(f"{lp}/norm{j}", t)
            norm(f"{pre}/agg/transformer/{stack}/norm", t)
    xh = 2 * dims.d
    for gate in ("forget_gate", "remember_gate", "remember_map"):
        linear(f"lstm/{gate}", xh, dims.ctx_hidden)
    linear("lstm/out_select_gate", xh, dims.d)
    linear("lstm/mem_to_out", dims.ctx_hidden, dims.d)
    return specs


# ---------------------------------------------------------------- the model

def _lin(p, name, x):
    return x @ p[f"{name}/w"] + p[f"{name}/b"]


def _norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}/scale"],
                        p[f"{name}/bias"], 1e-5)


def _self_attention(p, name, x, heads):
    n, t = x.shape
    hd = t // heads
    q, k, v = (_lin(p, f"{name}/{w}", x).reshape(n, heads, hd).transpose(0, 1)
               for w in ("q", "k", "v"))
    probs = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
    ctx = (probs @ v).transpose(0, 1).reshape(n, t)
    return _lin(p, f"{name}/out", ctx)


def _aggregate(p, pre, xs, dims: Dims):
    """The decoder stack over [special token, patches]; its output at the
    special token. Cross-attention over the empty conditional sequence
    gives the out-projection's bias."""
    x = torch.cat([p[f"{pre}/special_token"][None], xs], dim=0)
    for i in range(dims.layers):
        lp = f"{pre}/transformer/decoder/layers/{i}"
        x = _norm(p, f"{lp}/norm1", x + _self_attention(p, f"{lp}/self_attn",
                                                         x, dims.heads))
        x = _norm(p, f"{lp}/norm2", x + p[f"{lp}/cross_attn/out/b"])
        ff = _lin(p, f"{lp}/ff/lin2", torch.relu(_lin(p, f"{lp}/ff/lin1", x)))
        x = _norm(p, f"{lp}/norm3", x + ff)
    return _norm(p, f"{pre}/transformer/decoder/norm", x)[0]


def pos_encoding_2d(yx: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal 2-D encoding of integer (y, x) coordinates, (n, dim): y
    fills the first half, x the second; in each half sin in even and cos in
    odd columns over frequencies exp(-j ln(1e4) / dim), j = 0, 2, 4, ..."""
    half = dim // 2
    dt = torch.float64 if yx.device.type != "mps" else torch.float32
    freq = torch.exp(torch.arange(0, half, 2, dtype=dt, device=yx.device)
                     * (-math.log(10000.0) / dim))
    parts = []
    for col in (0, 1):
        ang = yx[:, col].to(dt)[:, None] * freq[None]
        parts.append(torch.stack([ang.sin(), ang.cos()], -1).flatten(1)[:, :half])
    return torch.cat(parts, dim=1)


def level_forward(p, dims: Dims, depth: int, fts, yx, ctx_slide, state):
    """One level on one slide's bag: fts (n, d), yx (n, 2) grid coordinates
    at this level, ctx_slide (t,) or None, state (n, d + ctx_hidden) or
    None. Returns (logits, slide feature, patch context, importance)."""
    n, d = fts.shape
    if state is None:
        hs = fts.new_zeros((n, d))
        cs = fts.new_zeros((n, dims.ctx_hidden))
    else:
        hs, cs = state[:, :d], state[:, d:]
    xh = torch.cat([fts, hs], dim=1)
    cs = (cs * torch.sigmoid(_lin(p, "lstm/forget_gate", xh))
          + torch.sigmoid(_lin(p, "lstm/remember_gate", xh))
          * torch.tanh(_lin(p, "lstm/remember_map", xh)))
    hs = (torch.sigmoid(_lin(p, "lstm/out_select_gate", xh))
          * torch.tanh(_lin(p, "lstm/mem_to_out", cs)))
    y = fts + hs
    pre = f"procs/{depth}"
    hidden = torch.relu(_lin(p, f"{pre}/importance_mlp/layers/0", y))
    imp = torch.sigmoid(_lin(p, f"{pre}/importance_mlp/layers/1", hidden))[:, 0]
    z = y * imp[:, None]
    xs = _lin(p, f"{pre}/agg/proj_in", z) + pos_encoding_2d(yx, dims.t).to(z.dtype)
    sf = _aggregate(p, f"{pre}/agg", xs, dims)
    if ctx_slide is not None:
        sf = sf + ctx_slide
    logits = _lin(p, f"{pre}/classification", sf)
    return logits, sf, torch.cat([hs, cs], dim=1), imp


# ------------------------------------------------------------ the recursion

def topk_orders(imp: torch.Tensor, k: int, tau: float) -> List[torch.Tensor]:
    """The kept indices of every order of the top-k that rounding could
    give, most important first (ties of equal values to the lowest index).
    One entry unless importances within `tau` straddle the boundary."""
    n = imp.shape[0]
    order = torch.sort(imp.detach(), descending=True, stable=True).indices
    k = min(k, n)
    if k == n:
        return [order]
    v = imp.detach()[order].double().cpu().numpy()
    idx = order.cpu().numpy()
    if v[k - 1] - v[k] > tau:
        return [order[:k]]
    lo, hi = v[k] - tau, v[k - 1] + tau
    near = [j for j in range(n) if lo <= v[j] <= hi]
    above = [int(idx[j]) for j in range(n) if v[j] > hi]
    need = k - len(above)
    classes: Dict[float, List[int]] = {}
    for j in near:
        classes.setdefault(float(v[j]), []).append(int(idx[j]))
    groups = [sorted(m) for _, m in sorted(classes.items(), reverse=True)]
    if len(groups) == 1:
        return [order[:k]]
    picks: List[List[int]] = []

    def choose(g, left, taken):
        if len(picks) >= MAX_ORDERS:
            return
        if g == len(groups):
            if left == 0:
                picks.append(taken)
            return
        for c in range(min(left, len(groups[g])), -1, -1):
            choose(g + 1, left - c, taken + groups[g][:c])

    choose(0, need, [])
    key = imp.detach().double().cpu().numpy()
    out = []
    for chosen in picks:
        kept = sorted(above + chosen, key=lambda i: (-key[i], i))
        out.append(torch.tensor(kept, dtype=torch.long, device=imp.device))
    return out


def children(kept: torch.Tensor, yx: torch.Tensor, grid: torch.Tensor,
             nonbg: torch.Tensor, k: int):
    """The next level's bag from the kept patches: the four children of
    each kept patch, quadrant by quadrant ((0,0), (0,1), (1,0), (1,1)), in
    kept order; those inside the next grid and not background stay, in that
    order. With none left, the fallback bag: the first 4k non-background
    cells of the next grid in row-major order, or its first 4k cells when
    all are background. Returns (rows (m, 2) yx, parent index (m,) or None
    for the fallback)."""
    h, w = grid.shape[:2]
    kept_yx = yx[kept]
    cand, parent = [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cand.append(kept_yx * 2 + torch.tensor([dy, dx], device=yx.device))
        parent.append(torch.arange(len(kept), device=yx.device))
    cand = torch.cat(cand)
    parent = torch.cat(parent)
    inside = ((cand[:, 0] >= 0) & (cand[:, 0] < h) & (cand[:, 1] >= 0)
              & (cand[:, 1] < w))
    cy = cand[:, 0].clamp(0, h - 1)
    cx = cand[:, 1].clamp(0, w - 1)
    ok = inside & nonbg[cy, cx]
    if bool(ok.any()):
        return cand[ok], parent[ok]
    s = 4 * k
    flat = torch.nonzero(nonbg.reshape(-1)).reshape(-1)
    if flat.numel() == 0:
        flat = torch.arange(h * w, device=yx.device)
    flat = flat[:s]
    return torch.stack([flat // w, flat % w], dim=1), None


@dataclass
class Result:
    hazards: torch.Tensor                       # (n_logits,)
    logits: torch.Tensor
    rows: List[int] = field(default_factory=list)   # bag length per level


def descend(p, dims: Dims, grids: Sequence[torch.Tensor],
            nonbg: Sequence[torch.Tensor], tau: float = TIE_TAU) -> List[Result]:
    """Every result of the whole recursion on one slide (more than one only
    where a top-K boundary ties within `tau`). grids[i]: level i's (H, W, D)
    features in the compute dtype; nonbg[i]: its (H, W) non-background
    mask."""
    g0 = grids[0]
    h, w = g0.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, device=g0.device),
                            torch.arange(w, device=g0.device), indexing="ij")
    yx0 = torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=1)
    return _descend(p, dims, grids, nonbg, tau, 0, g0.reshape(h * w, -1), yx0,
                    None, None)


def _descend(p, dims, grids, nonbg, tau, depth, fts, yx, ctx_slide, state):
    logits, sf, pctx, imp = level_forward(p, dims, depth, fts, yx,
                                          ctx_slide, state)
    n = fts.shape[0]
    if depth == dims.levels - 1:
        return [Result(torch.sigmoid(logits), logits, [n])]
    out = []
    nxt = grids[depth + 1]
    for kept in topk_orders(imp, dims.top_k, tau):
        rows, parent = children(kept, yx, nxt, nonbg[depth + 1], dims.top_k)
        fts2 = nxt[rows[:, 0], rows[:, 1]]
        if parent is None:
            st = pctx.new_zeros((rows.shape[0], pctx.shape[1]))
        else:
            st = pctx[kept][parent]
        for r in _descend(p, dims, grids, nonbg, tau, depth + 1, fts2, rows,
                          sf, st):
            out.append(Result(r.hazards, r.logits, [n] + r.rows))
            if len(out) >= MAX_ORDERS:
                return out
    return out


def nearest(results: List[Result], target: Optional[torch.Tensor]) -> Result:
    """The result nearest to `target` hazards (the first without one)."""
    if target is None or len(results) == 1:
        return results[0]
    gaps = [float((r.hazards.detach().double() - target.double().to(
        r.hazards.device)).abs().max()) for r in results]
    return results[int(np.argmin(gaps))]


def nll_survival(hazards: torch.Tensor, y: int, c: float,
                 alpha: float = 0.4, eps: float = 1e-7) -> torch.Tensor:
    """The discrete-survival negative log-likelihood of one slide: hazards
    (nbins,), bin y, censorship c (1 = censored)."""
    s = torch.cumprod(1.0 - hazards, dim=0)
    s = torch.cat([hazards.new_ones(1), s])
    s_prev = s[y].clamp_min(eps)
    h_this = hazards[y].clamp_min(eps)
    s_this = s[y + 1].clamp_min(eps)
    unc = -(1.0 - c) * (torch.log(s_prev) + torch.log(h_this))
    cen = -c * torch.log(s_this)
    return (1.0 - alpha) * (cen + unc) + alpha * unc


class AdamW:
    """torch.optim.AdamW's update (decoupled weight decay, bias-corrected
    moments), on a dict of leaves; a leaf without a gradient is left as it
    is and keeps no state."""

    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                       betas[0], betas[1], eps)
        self.state: Dict[str, dict] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]], lr: float) -> None:
        for name, g in grads.items():
            if g is None:
                continue
            st = self.state.setdefault(name, {"t": 0,
                                              "m": torch.zeros_like(g),
                                              "v": torch.zeros_like(g)})
            st["t"] += 1
            t = st["t"]
            p = params[name]
            p.mul_(1.0 - lr * self.wd)
            st["m"].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            st["v"].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (st["v"].sqrt() / math.sqrt(1.0 - self.b2 ** t)).add_(self.eps)
            p.addcdiv_(st["m"], denom, value=-lr / (1.0 - self.b1 ** t))
