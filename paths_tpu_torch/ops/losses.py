"""Loss functions (counterpart of `paths_tpu.ops.losses`).

`nll_survival_loss` is the MCAT-style discrete survival negative
log-likelihood: hazards h(t) are per-bin death probabilities, survival S(t)
is the cumulative product of (1 - h); censored patients contribute
-c*log(S_padded[y+1]), uncensored ones -(1-c)*(log(S_padded[y]) +
log(h[y])); the total is (1-alpha)*neg_l + alpha*uncensored, averaged over
the batch.
"""
from __future__ import annotations

import torch


def _weighted_mean(x: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return x.mean()
    w = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    return (x * w).sum() / w.sum().clamp_min(1e-8)


def nll_survival_loss(hazards: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                      alpha: float = 0.4, eps: float = 1e-7,
                      weights=None) -> torch.Tensor:
    """Discrete survival NLL over (B, nbins) hazards, (B,) bins `y` and
    (B,) censorship `c` (1 = censored). Returns the scalar mean loss."""
    y = torch.as_tensor(y, device=hazards.device).long()
    c = torch.as_tensor(c, device=hazards.device).to(hazards.dtype)
    survival = torch.cumprod(1.0 - hazards, dim=1)
    survival_padded = torch.cat([torch.ones_like(survival[:, :1]), survival], dim=1)
    r = torch.arange(hazards.shape[0], device=hazards.device)
    s_prev = survival_padded[r, y].clamp_min(eps)
    h_this = hazards[r, y].clamp_min(eps)
    s_this = survival_padded[r, y + 1].clamp_min(eps)
    uncensored = -(1.0 - c) * (torch.log(s_prev) + torch.log(h_this))
    censored = -c * torch.log(s_this)
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return _weighted_mean(loss, weights)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights=None) -> torch.Tensor:
    """Mean softmax cross-entropy over int labels."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return _weighted_mean(logz - ll, weights)
