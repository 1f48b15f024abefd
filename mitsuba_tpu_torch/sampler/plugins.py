"""Sample generators (port of mitsuba_tpu/sampler/plugins.py, reference
src/samplers/*) in stateless form: a sampler is a pure function of
(pixel lane, sample index, slot).

The pixel-position and lens samples use each sampler's pattern; the
integrator's decisions go through the counter hash, except under the
low-discrepancy samplers (`ld_decision4`), which route them through
padded Sobol' dimensions while the table lasts.

* independent: the counter hash everywhere (reference independent.cpp)
* stratified: a jittered grid per pixel (stratified.cpp)
* ldsampler, sobol: the scrambled (0,2)-sequence for the pixel, Sobol'
  dims 2-3 for the lens (ldsampler.cpp, sobol.cpp)
* halton, hammersley: Faure-permuted radical inverses with a per-pixel
  rotation (halton.cpp, hammersley.cpp)

Lanes and sample indices are uint32 words in int64 tensors (core/rng.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mitsuba_tpu_torch.core import rng, sobol
from mitsuba_tpu_torch.scene.registry import register

# sampler kinds, as numbered in the reference
INDEPENDENT = 0
STRATIFIED = 1
LDSAMPLER = 2
SOBOL = 3
HALTON = 4
HAMMERSLEY = 5
_LD_KINDS = (LDSAMPLER, SOBOL)


def _lane_hash(lane, b, c, seed):
    """pcg4d of the words (lane, b, c, seed), one row per lane."""
    lane = rng._u32(torch.as_tensor(lane))
    return rng.pcg4d(torch.stack(
        [lane, torch.full_like(lane, b), torch.full_like(lane, c),
         torch.full_like(lane, int(seed) & rng._MASK)], dim=-1,
    ))


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
        if self.kind == STRATIFIED:
            # spp as a near-square grid, jittered within its cells
            nx = int(max(1, round(spp ** 0.5)))
            ny = max(1, spp // nx)
            idx = rng._u32(torch.as_tensor(sample_idx)) % (nx * ny)
            jit = rng.rand2(lane, sample_idx, 0, self._seed())
            cx = (idx % nx).to(torch.float32)
            cy = (idx // nx).to(torch.float32)
            return torch.stack([(cx + jit[..., 0]) / nx, (cy + jit[..., 1]) / ny], dim=-1)
        if self.kind in _LD_KINDS:
            scr = _lane_hash(lane, 0, 77, self.seed)
            return rng.sobol_2d_scrambled(sample_idx, scr[..., 0], scr[..., 1])
        if self.kind in (HALTON, HAMMERSLEY):
            # base-2 Faure is the identity permutation
            i = rng._u32(torch.as_tensor(sample_idx))
            rot = rng.rand2(lane, 0, 991, self._seed())
            if self.kind == HAMMERSLEY and spp > 0:
                # dim 0 of Hammersley enumerates i/N
                x = torch.remainder((i % spp).to(torch.float32) / spp + rot[..., 0], 1.0)
            else:
                x = sobol.halton_faure(i, 0, rot[..., 0])
            return torch.stack([x, sobol.halton_faure(i, 1, rot[..., 1])], dim=-1)
        return rng.rand2(lane, sample_idx, 0, self._seed())

    def lens_sample(self, lane, sample_idx):
        """2D aperture sample: Sobol' dims 2-3 for the low-discrepancy
        samplers, Faure-permuted Halton bases 5 and 7 for halton and
        hammersley, the counter hash otherwise."""
        if self.kind in (HALTON, HAMMERSLEY):
            i = rng._u32(torch.as_tensor(sample_idx))
            rot = rng.rand2(lane, 0, 992, self._seed())
            return torch.stack([sobol.halton_faure(i, 2, rot[..., 0]),
                                sobol.halton_faure(i, 3, rot[..., 1])], dim=-1)
        if self.kind in _LD_KINDS:
            scr = _lane_hash(lane, 1009, 23, self.seed)
            return sobol.sobol_01(sample_idx, (2, 3), scr[..., :2])
        return rng.rand2(lane, sample_idx, 1009, self._seed())

    def next2d(self, lane, sample_idx, slot):
        return rng.rand2(lane, sample_idx, slot, self._seed())


def ld_decision4(sampler, lane, sample_idx, dslot, fallback, seed):
    """Integrator decision draw.  The low-discrepancy samplers map
    decision slot `dslot` (per lane) to Sobol' dimensions 4 + 4 dslot ..
    +3 under a per-(pixel, slot) XOR scramble ("padded Sobol"); slots
    past the direction table (dim0 + 3 >= N_DIMS) keep the counter-hash
    draw `fallback`, as the reference samplers hand out uniform floats
    once their arrays run out (sampler.cpp next1D/next2D).  Every other
    sampler keeps `fallback`."""
    if sampler is None or sampler.kind not in _LD_KINDS:
        return fallback
    lane_u = rng._u32(torch.as_tensor(lane))
    dslot = torch.as_tensor(dslot, device=lane_u.device)
    dim0 = 4 + 4 * dslot.to(torch.int32)
    dims = dim0[..., None] + torch.arange(4, dtype=torch.int32, device=lane_u.device)
    scr = rng.pcg4d(torch.stack([
        lane_u, rng._u32(dslot).expand(lane_u.shape), torch.full_like(lane_u, 0x50B0),
        torch.full_like(lane_u, (sampler.seed ^ seed) & rng._MASK),
    ], dim=-1))
    ld = sobol.sobol_01_dyn(sample_idx, dims, scr)
    use = (dim0 + 3 < sobol.N_DIMS).expand(lane_u.shape)
    return torch.where(use[..., None], ld, fallback)


class _SamplerBase:
    kind = INDEPENDENT

    def __init__(self, props):
        self.record = SamplerRecord(
            kind=self.kind,
            sample_count=props.get_int("sampleCount", 4),
            seed=props.get_int("seed", 0),
        )


@register("sampler", "independent")
class Independent(_SamplerBase):
    kind = INDEPENDENT


@register("sampler", "stratified")
class Stratified(_SamplerBase):
    kind = STRATIFIED


@register("sampler", "ldsampler")
class LowDiscrepancy(_SamplerBase):
    kind = LDSAMPLER


@register("sampler", "sobol")
class Sobol(_SamplerBase):
    kind = SOBOL


@register("sampler", "halton")
class Halton(_SamplerBase):
    kind = HALTON


@register("sampler", "hammersley")
class Hammersley(_SamplerBase):
    kind = HAMMERSLEY
