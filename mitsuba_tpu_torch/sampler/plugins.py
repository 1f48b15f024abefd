"""Sample generators (port of mitsuba_tpu/sampler/plugins.py): the
`independent` sampler, a pure function of (pixel lane, sample index,
slot) through the counter hash."""

from __future__ import annotations

from dataclasses import dataclass

from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.scene.registry import register

INDEPENDENT = 0  # sampler kind, as numbered in the reference


@dataclass
class SamplerRecord:
    kind: int = INDEPENDENT
    sample_count: int = 4
    seed: int = 0

    def _seed(self):
        # sampler-owned draws live in their own stream (core/rng.py)
        return rng.stream_seed(self.seed, rng.STREAM_CAMERA)

    def pixel_sample(self, lane, sample_idx, spp):
        """2D sample in [0,1)^2 used for the film-position jitter."""
        if self.kind != INDEPENDENT:
            raise NotImplementedError(f"sampler kind {self.kind} not yet ported")
        return rng.rand2(lane, sample_idx, 0, self._seed())

    def lens_sample(self, lane, sample_idx):
        """2D aperture sample."""
        if self.kind != INDEPENDENT:
            raise NotImplementedError(f"sampler kind {self.kind} not yet ported")
        return rng.rand2(lane, sample_idx, 1009, self._seed())


def ld_decision4(sampler, lane, sample_idx, dslot, fallback, seed):
    """Integrator decision draw: low-discrepancy samplers route it
    through Sobol' dimensions; the independent sampler keeps the counter
    hash draw `fallback`."""
    if sampler is not None and sampler.kind != INDEPENDENT:
        raise NotImplementedError(f"sampler kind {sampler.kind} not yet ported")
    return fallback


@register("sampler", "independent")
class Independent:
    kind = INDEPENDENT

    def __init__(self, props):
        self.record = SamplerRecord(
            kind=self.kind,
            sample_count=props.get_int("sampleCount", 4),
            seed=props.get_int("seed", 0),
        )
