"""Film accumulator (port of mitsuba_tpu/film/film.py, the dense path).

The film carries (weighted RGB sum, weight sum) per pixel; with filter
importance sampling every sample adds weight 1 to its own pixel, so a
render pass accumulates with dense adds and no scatter."""

from __future__ import annotations

import torch


def new_film(height, width, device):
    """(weighted rgb, weight) accumulator [H, W, 4]."""
    return torch.zeros((height, width, 4), dtype=torch.float32, device=device)


def develop(film):
    """Weighted average -> final image [H, W, 3]."""
    w = film[..., 3:4]
    return torch.where(w > 1e-8, film[..., :3] / torch.clamp(w, min=1e-8), 0.0)
