"""Differentiable rendering: parameter selection, loss functions,
optimisation.

Pixel gradients flow to material albedo, metal fuzziness, dielectric IOR,
emission colours, background colour and texture texels through the path
integral, using reparameterized sampling (fuzz direction) and detached
discrete choices (the dielectric's Bernoulli, with an optional
score-function surrogate, diff/surrogate.py).
"""

from potato_tpu_torch.diff.optimize import (  # noqa: F401
    DIFFERENTIABLE_FIELDS,
    make_render_loss,
    optimize_textures,
)
