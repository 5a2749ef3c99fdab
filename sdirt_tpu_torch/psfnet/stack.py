"""FocalStackLens: a multi-focus DP stack rendered through several
surrogates (PyTorch counterpart of sdirt_tpu/psfnet/stack.py).

One surrogate per focus setting, each fitted with its own refocused
geometry and focus prior, rendered in lens order and concatenated along the
channels: view v of the [N, 6V, H, W] stack is channels [6v, 6v + 6),
(left RGB, right RGB), the layout dfdp/basenet.py:Basenet reads.
"""

from __future__ import annotations

import torch


class FocalStackLens:
    """A list of PSFNetLens (one per focus), rendered as one input stack;
    the shared geometry is the first (primary) lens's."""

    def __init__(self, lenses):
        if not lenses:
            raise ValueError("a focal stack needs at least one lens")
        self.lenses = list(lenses)
        self.kernel_size = self.lenses[0].kernel_size
        self.device = self.lenses[0].device

    @property
    def n_views(self) -> int:
        return len(self.lenses)

    def render(self, img, depth, foc_dist, variant: str | None = None,
               train: bool = False, generator=None, **render_kw):
        """img [N, C, H, W]; depth [N, 1, H, W] mm (negative). Returns
        [N, 2C V, H, W], the views' DP pairs in lens order. ``foc_dist`` is
        ignored, as in the JAX package: each surrogate's focus is fitted in.
        With train=True each view draws its noise from ``generator`` in
        turn (the JAX package splits its key per view; those draws cannot
        be reproduced in torch)."""
        outs = [lens.render(img, depth, foc_dist, variant, train=train,
                            generator=generator, **render_kw)
                for lens in self.lenses]
        return torch.cat(outs, dim=1)
