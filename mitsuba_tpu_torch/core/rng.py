"""Counter-based, stateless RNG: the port of mitsuba_tpu/core/rng.py.

Every random number is a pure hash of its logical coordinates (pixel
lane, sample index, decision slot, seed), so the port draws exactly the
reference's numbers.  PyTorch has no uint32 add or shift, so words are
held in int64 tensors and masked to 32 bits after every operation that
can carry past bit 31; the results are bit-identical to uint32
arithmetic.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF

# global RNG stream partition (values as in the reference; the other
# streams arrive with the slices that draw from them)
STREAM_PATH = 0  # integrator bounce loops: slot = bounce * 4 + decision
STREAM_CAMERA = 1  # sampler-owned draws: film jitter, lens
STREAM_MEDIUM_DIST = 2  # heterogeneous delta tracking (sample_distance)
STREAM_MEDIUM_TRANS = 3  # shadow-ray ratio tracking (transmittance)
STREAM_LIGHT = 4  # light-subpath walks (ptracer / bdpt light paths)
STREAM_MLT = 5  # pssmlt/mlt/erpt chain mutations and control decisions
STREAM_SSS = 6  # subsurface irradiance points, single scattering, irrcache
STREAM_WEAVE = 7  # irawan weave noise: a texture hash keyed on lattice indices


def _u32(x):
    """Int tensor -> int64 tensor holding its uint32 words."""
    return x.to(torch.int64) & _MASK


def stream_seed(seed, stream):
    """Seed word for an independent stream: tag in bits 28-31.  A python
    int for an int seed, else an int64 tensor of words."""
    tag = (int(stream) << 28) & _MASK
    if isinstance(seed, torch.Tensor):
        return _u32(seed) ^ tag
    return (int(seed) & _MASK) ^ tag


def _rotl(x, k):
    return ((x << k) | (x >> (32 - k))) & _MASK


def _quarter(a, b, c, d):
    """ChaCha quarter round on uint32 words held in int64."""
    a = (a + b) & _MASK
    d = _rotl(d ^ a, 16)
    c = (c + d) & _MASK
    b = _rotl(b ^ c, 12)
    a = (a + b) & _MASK
    d = _rotl(d ^ a, 8)
    c = (c + d) & _MASK
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def pcg4d(v):
    """4-in/4-out counter hash (three ChaCha quarter rounds).
    v: int tensor [..., 4] of uint32 words -> int64 [..., 4] words."""
    v = _u32(v)
    a, b, c, d = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    a = a ^ 0x9E3779B9
    b = (b + 0x85EBCA6B) & _MASK
    c = c ^ 0xC2B2AE35
    d = (d + 0x27D4EB2F) & _MASK
    a, b, c, d = _quarter(a, b, c, d)
    b, c, d, a = _quarter(b, c, d, a)
    a, b, c, d = _quarter(a, b, c, d)
    return torch.stack([a, b, c, d], dim=-1)


def _to_float01(bits):
    """uint32 words -> float32 in [0, 1) with 24 bits of entropy."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rand4(lane, sample_idx, slot, seed=0):
    """4 uniforms in [0,1) keyed on (lane, sample, slot, seed).
    Arguments (tensors or python ints) broadcast against each other;
    returns float32 [..., 4] on the device of the tensor arguments."""
    args = (lane, sample_idx, slot, seed)
    tensors = sorted(
        (x for x in args if isinstance(x, torch.Tensor)), key=lambda t: -t.dim()
    )
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    device = tensors[0].device if tensors else None
    words = [
        _u32(x.to(device)).expand(shape) if isinstance(x, torch.Tensor)
        else torch.full(shape, int(x) & _MASK, dtype=torch.int64, device=device)
        for x in args
    ]
    words[3] = words[3] ^ 0x9E3779B9
    return _to_float01(pcg4d(torch.stack(words, dim=-1)))


def rand2(lane, sample_idx, slot, seed=0):
    return rand4(lane, sample_idx, slot, seed)[..., :2]


def rand1(lane, sample_idx, slot, seed=0):
    return rand4(lane, sample_idx, slot, seed)[..., 0]


def _mul32(a, b):
    """(a * b) mod 2^32 of uint32 words in int64, in 16-bit halves of b
    so that no product passes 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d_mult(v):
    """The multiply-based PCG4D hash (Jarzynski & Olano), the
    reference's own implementation kept beside the ChaCha-style pcg4d.
    v: int tensor [..., 4] of uint32 words -> int64 [..., 4] words."""
    v = (_mul32(_u32(v), 1664525) + 1013904223) & _MASK
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x, y, z, w = _mult_round(x, y, z, w)
    x, y, z, w = (t ^ (t >> 16) for t in (x, y, z, w))
    x, y, z, w = _mult_round(x, y, z, w)
    return torch.stack([x, y, z, w], dim=-1)


def _mult_round(x, y, z, w):
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


# --- low-discrepancy helpers -------------------------------------------------

def _reverse_bits(bits):
    """Bit reversal of uint32 words held in int64."""
    bits = _u32(bits)
    bits = ((bits << 16) | (bits >> 16)) & _MASK
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    return ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)


def radical_inverse_base2(bits):
    """Van der Corput radical inverse in base 2 (reference qmc.h:40)."""
    return _to_float01(_reverse_bits(bits))


def _words(x, like):
    """A python int or int tensor as uint32 words broadcast to `like`."""
    if isinstance(x, torch.Tensor):
        return _u32(x.to(like.device)).expand(like.shape)
    return torch.full(like.shape, int(x) & _MASK, dtype=torch.int64, device=like.device)


def sobol_2d_scrambled(index, scramble_x, scramble_y):
    """The first two dimensions of the Sobol' (0,2)-sequence with
    per-lane uint32 XOR scrambles (reference ldsampler.cpp sample02):
    the radical inverse, and dimension 1's direction numbers
    v_{k+1} = v_k ^ (v_k >> 1) from core/sobol.py's byte tables.
    Returns float32 [..., 2]."""
    from mitsuba_tpu_torch.core.sobol import sobol_bits

    index = _u32(torch.as_tensor(index))
    x_bits = _reverse_bits(index) ^ _words(scramble_x, index)
    y_bits = sobol_bits(index, (1,))[..., 0] ^ _words(scramble_y, index)
    return torch.stack([_to_float01(x_bits), _to_float01(y_bits)], dim=-1)


def sobol_2d(index, scramble_x=0, scramble_y=0):
    """First two dimensions of the Sobol' (0,2)-sequence with scalar XOR
    scrambles (reference src/samplers/ldsampler.cpp sample02): the radical
    inverse of index ^ scramble_x, and dimension 1 XOR scramble_y.
    index: uint32 words -> float32 [..., 2]."""
    from mitsuba_tpu_torch.core.sobol import sobol_bits

    index = _u32(torch.as_tensor(index))
    x = radical_inverse_base2(index ^ (int(scramble_x) & _MASK))
    y_bits = sobol_bits(index, (1,))[..., 0] ^ (int(scramble_y) & _MASK)
    return torch.stack([x, _to_float01(y_bits)], dim=-1)
