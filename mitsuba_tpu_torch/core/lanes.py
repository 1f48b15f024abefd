"""Host loops over the lanes still at work.

The reference's `while any(alive)` loops run every lane in every
iteration, in fixed shapes for the TPU.  The port's loops check their
exit every EXIT_CHECK_EVERY iterations and run on the lanes still at
work, gathered anew at each check (`LiveLanes`): a lane that is done
changes nothing the result reads, and a lane's work depends on its own
state only, so the subset computes what the whole batch would.
"""

from __future__ import annotations

import torch

EXIT_CHECK_EVERY = 8  # iterations between host checks of a loop's exit


def _rows(x, keep):
    if isinstance(x, dict):
        return {k: v[keep] for k, v in x.items()}
    return x[keep]


class LiveLanes:
    """The rows of a batch of n lanes that a loop still works on (`ids`,
    into the whole batch)."""

    def __init__(self, n, device):
        self.ids = torch.arange(n, device=device)

    def write(self, outs, subs):
        """Write each working tensor of subs into the rows `ids` of the
        whole-batch tensor of outs beside it."""
        for out, sub in zip(outs, subs):
            if sub is not out:  # a tensor no iteration has replaced yet
                out[self.ids] = sub

    def narrow(self, live, *xs):
        """Keep the rows where `live` (over the working rows) holds: of
        each x (a tensor or a dict of tensors over the working rows) and
        of `ids`.  Returns the narrowed xs, or None where no row is left
        (a host sync)."""
        keep = torch.nonzero(live).squeeze(1)
        if keep.numel() == 0:
            return None
        if keep.numel() == live.shape[0]:
            return xs
        self.ids = self.ids[keep]
        return tuple(_rows(x, keep) for x in xs)
