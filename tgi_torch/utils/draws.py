"""Random draws shaped like ``jax.random``'s key tree.

``tgi`` threads a PRNG key through the trainer and splits it at each
stage (``tgi/train/gan.py``, ``tgi/train/augment.py``). The port's
training code draws through a *draw source* with the same three
operations, so its code mirrors ``tgi``'s splits line for line:

* ``split(n)`` -> n child sources;
* ``uniform(shape)``, ``normal(shape)``, ``randint(shape, lo, hi)`` ->
  float32 / int64 tensors on the source's device.

:class:`TorchDraws` draws every value from one ``torch.Generator`` in
call order (``split`` returns the source itself n times). A test hands
the same code another source whose leaves are ``tgi``'s own key splits,
so each draw is ``tgi``'s draw given as a tensor (ROADMAP, "Randomness
crosses as tensors").
"""

from __future__ import annotations

import torch


class TorchDraws:
    """Draws from ``generator`` (on its own device), placed on
    ``device`` (the generator's device when None)."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = torch.device(device if device is not None
                                   else generator.device)

    def split(self, n: int):
        return [self] * n

    def _place(self, t):
        return t.to(self.device)

    def uniform(self, shape):
        return self._place(torch.rand(tuple(shape), generator=self.generator,
                                      device=self.generator.device))

    def normal(self, shape):
        return self._place(torch.randn(tuple(shape), generator=self.generator,
                                       device=self.generator.device))

    def randint(self, shape, lo: int, hi: int):
        return self._place(torch.randint(lo, hi, tuple(shape),
                                         generator=self.generator,
                                         device=self.generator.device))


def as_draws(rng, device):
    """A draw source from ``rng``: a ``torch.Generator`` (wrapped in
    :class:`TorchDraws`, its draws placed on ``device``) or a source
    already."""
    if isinstance(rng, torch.Generator):
        return TorchDraws(rng, device)
    return rng


class RowDraws:
    """A draw source for one rank of a data-parallel step: each draw of
    rank >= 1 is ``draws``' draw at the global batch (axis 0 times
    ``ranks``) cut to this rank's rows, and a 0-d draw is the batch-wide
    one, so every rank draws what the unsharded step draws for its rows
    and every rank's source advances alike. Axis 0 of every draw of the
    training step is its batch axis, or the batch flattened image-major
    (the importance uniforms ``[N * M, S]``)."""

    def __init__(self, draws, rank: int, ranks: int):
        self.draws, self.rank, self.ranks = draws, rank, ranks

    def split(self, n: int):
        return [RowDraws(d, self.rank, self.ranks)
                for d in self.draws.split(n)]

    def _rows(self, draw, shape, *args):
        shape = tuple(shape)
        if not shape:
            return draw(shape, *args)
        full = draw((shape[0] * self.ranks,) + shape[1:], *args)
        return full[self.rank * shape[0]:(self.rank + 1) * shape[0]]

    def uniform(self, shape):
        return self._rows(self.draws.uniform, shape)

    def normal(self, shape):
        return self._rows(self.draws.normal, shape)

    def randint(self, shape, lo: int, hi: int):
        return self._rows(self.draws.randint, shape, lo, hi)
