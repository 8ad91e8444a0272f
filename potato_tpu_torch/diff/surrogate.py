"""Score-function (REINFORCE) surrogate for discrete sampling choices.

The dielectric material flips a Bernoulli coin between reflection and
refraction with probability = Schlick reflectance(IOR). The *draw* is
detached (sampled against the detached probability, ops/material.py), so
pathwise gradients see only the continuous dependence of the chosen
direction on IOR; the dependence of the choice probability itself is lost.

The missing term is recovered with the score-function identity

    d/dθ E_b[f(b)] = E_b[f(b) · d/dθ log p_b(θ)] + E_b[d/dθ f(b)]

implemented as a multiplicative weight w = p_b / detach(p_b): its forward
value is exactly 1 (images are unchanged), while its gradient is
d log p_b. Multiplying path throughput by w at each stochastic choice makes
the estimator of d(image)/d(IOR) unbiased across branch flips.
"""

from __future__ import annotations

import torch


def score_weight(prob_true, chose_true):
    """Importance weight for one Bernoulli choice.

    prob_true: (B,) differentiable probability of the branch `chose_true`
        refers to (e.g. Schlick reflectance of the reflect branch).
    chose_true: (B,) bool, the branch actually sampled.

    Returns (B,) weights with value exactly 1.0 and gradient
    d log p_b = d p_b / p_b. Probabilities are clamped away from 0 and 1
    for gradient stability (a branch sampled at probability ~0 cannot
    occur, so the clamp acts on the gradient side only in practice).
    """
    p = torch.clamp(prob_true, 1e-6, 1.0 - 1e-6)
    p_b = torch.where(chose_true, p, 1.0 - p)
    return p_b / p_b.detach()


def bernoulli_expectation_grad(f_true, f_false, prob_true, u):
    """Reference estimator used by tests: the mean over stratified draws u
    of w(b)·f(b) with b = (u < p). Its gradient with respect to the
    parameters of `prob_true` matches d/dθ [p·f_true + (1-p)·f_false]."""
    chose = u < prob_true.detach()
    w = score_weight(prob_true, chose)
    f_true = torch.as_tensor(f_true, dtype=w.dtype, device=w.device)
    f_false = torch.as_tensor(f_false, dtype=w.dtype, device=w.device)
    return torch.mean(w * torch.where(chose, f_true, f_false))
