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
