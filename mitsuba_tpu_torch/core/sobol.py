"""High-dimensional Sobol' points and Faure-permuted Halton (port of
mitsuba_tpu/core/sobol.py).

The direction numbers are computed, not shipped (the reference's
src/samplers/sobolseq.cpp holds 108k generated lines): dim 0 is van der
Corput, dim 1 its (0,2)-sequence partner, dims 2..9 the Joe-Kuo heads,
and dims 10+ primitive polynomials over GF(2) found by search, with odd
initial direction numbers from a fixed splitmix hash
(`direction_matrices`, numpy, the reference's construction unchanged).

A point is the XOR of the direction numbers of its index's set bits.
XOR is linear over those bits, so the port draws from byte tables,
T[dim, j, b] = the XOR of V[dim][8j + k] over the set bits k of b, and a
32-bit index costs 4 gathers and 3 XORs, where the reference's loop runs
one masked XOR per bit (`byte_tables`; tests/test_torch_samplers.py
holds the two equal).  Words are uint32 values in int64 tensors, as in
core/rng.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_DIMS = 160
N_BITS = 32

# Joe-Kuo table head: (degree s, coeff a, [m_1..m_s]) for dims 2..9
# (public new-joe-kuo-6 data, first rows)
_JOE_KUO_HEAD = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
]


def _gf2_mulmod(a: int, b: int, p: int, s: int) -> int:
    """(a*b) mod p over GF(2)[x]; p has degree s."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> s & 1:
            a ^= p
    return r


def _prime_factors(n: int):
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _x_pow(e: int, p: int, s: int) -> int:
    """x^e mod p over GF(2)."""
    r, b = 1, 2  # 1, x
    while e:
        if e & 1:
            r = _gf2_mulmod(r, b, p, s)
        b = _gf2_mulmod(b, b, p, s)
        e >>= 1
    return r


def _is_primitive(p: int, s: int) -> bool:
    order = (1 << s) - 1
    if _x_pow(order, p, s) != 1:
        return False
    for q in _prime_factors(order):
        if _x_pow(order // q, p, s) == 1:
            return False
    return True


def _primitive_polys(count: int):
    """First `count` primitive polynomials (as (s, a) pairs) in degree
    order; `a` encodes the interior coefficients a_1..a_{s-1}."""
    out = []
    s = 1
    while len(out) < count:
        # polynomial = x^s + a_1 x^{s-1} + ... + a_{s-1} x + 1; the
        # returned `a` uses the Joe-Kuo convention (a_1 = MSB), matching
        # the recurrence in direction_matrices()
        for cand in range(1 << max(s - 1, 0)):
            p = (1 << s) | 1
            a_msb = 0
            for i in range(s - 1):
                if cand >> i & 1:
                    p |= 1 << (s - 1 - i)  # a_{i+1} set
                    a_msb |= 1 << (s - 2 - i)
            if _is_primitive(p, s):
                out.append((s, a_msb))
                if len(out) >= count:
                    break
        s += 1
    return out


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


@functools.lru_cache(maxsize=1)
def direction_matrices() -> np.ndarray:
    """[N_DIMS, N_BITS] uint32; V[d][k] = direction number for bit k."""
    V = np.zeros((N_DIMS, N_BITS), np.uint64)

    # dim 0: identity (radical inverse)
    for k in range(N_BITS):
        V[0, k] = 1 << (31 - k)

    # dim 1: v_{k+1} = v_k ^ (v_k >> 1)  (matches rng.sobol_2d)
    v = 1 << 31
    for k in range(N_BITS):
        V[1, k] = v
        v = v ^ (v >> 1)

    polys = _primitive_polys(N_DIMS + 16)  # generous; head skips some
    head = list(_JOE_KUO_HEAD)
    pi = 0
    for d in range(2, N_DIMS):
        if head:
            s, a, m = head.pop(0)
        else:
            # skip polynomials already consumed by the head table
            while pi < len(polys) and polys[pi][0] <= 5:
                pi += 1
            s, a = polys[pi]
            pi += 1
            m = [
                (_splitmix(d * 97 + k) % (1 << k)) | 1
                for k in range(1, s + 1)
            ]
        mm_ = list(m)
        for k in range(s, N_BITS):
            new = mm_[k - s] ^ (mm_[k - s] << s)
            for i in range(1, s):
                if a >> (s - 1 - i) & 1:
                    new ^= mm_[k - i] << i
            mm_.append(new & 0xFFFFFFFF)
        for k in range(N_BITS):
            V[d, k] = (mm_[k] << (31 - k)) & 0xFFFFFFFF
    return V.astype(np.uint32)


@functools.lru_cache(maxsize=1)
def byte_tables() -> np.ndarray:
    """[N_DIMS, 4, 256] int64, read-only: T[d, j, b] = XOR of direction
    numbers V[d][8j + k] over the set bits k of b."""
    V = direction_matrices().astype(np.int64).reshape(N_DIMS, 4, 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1  # [256, 8]
    T = np.zeros((N_DIMS, 4, 256), np.int64)
    for k in range(8):
        T ^= np.where(bits[None, None, :, k] == 1, V[:, :, k:k + 1], 0)
    T.setflags(write=False)
    return T


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(the byte tables flat on `device`, [N_DIMS * 4 * 256] int64 with
    entry d * 1024 + j * 256 + b; the byte shifts 8j [4]; the byte
    offsets 256j [4]).  One read-only copy per device."""
    j = torch.arange(4, dtype=torch.int64)
    return tuple(t.to(device) for t in (torch.as_tensor(byte_tables().reshape(-1).copy()), 8 * j,
                                        256 * j))


@functools.lru_cache(maxsize=None)
def _dim_bases(dims: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor([1024 * d for d in dims], dtype=torch.int64, device=device)


def _index_bytes(index, shifts, offsets):
    """uint32 words [...] -> their 4 bytes [..., 4] int64, byte j offset
    by 256j into a dimension's 1024 entries."""
    idx = index.to(torch.int64) & 0xFFFFFFFF
    return ((idx[..., None] >> shifts) & 0xFF) + offsets


def _xor4(t):
    """XOR over the last axis of length 4."""
    return (t[..., 0] ^ t[..., 1]) ^ (t[..., 2] ^ t[..., 3])


def sobol_bits(index, dims):
    """Sobol' integer samples: index [...] (uint32 words), dims a static
    tuple of dimensions -> [..., len(dims)] words (int64)."""
    index = torch.as_tensor(index)
    tab, shifts, offsets = _device_tables(index.device)
    base = _dim_bases(tuple(dims), index.device)
    ids = base[:, None] + _index_bytes(index, shifts, offsets)[..., None, :]  # [..., n, 4]
    return _xor4(tab[ids])


def _to_float01(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def sobol_01(index, dims, scramble=None):
    """float32 in [0,1): Sobol' points with optional XOR scrambling;
    scramble: words broadcastable to [..., len(dims)]."""
    bits = sobol_bits(index, dims)
    if scramble is not None:
        bits = bits ^ (scramble.to(torch.int64) & 0xFFFFFFFF)
    return _to_float01(bits)


def sobol_bits_dyn(index, dim_idx):
    """Sobol' integer samples with per-lane dimensions: index [...]
    (uint32 words), dim_idx int [..., n] (clipped to [0, N_DIMS)) ->
    [..., n] words, broadcast against index[..., None]."""
    index = torch.as_tensor(index)
    tab, shifts, offsets = _device_tables(index.device)
    dims = torch.clamp(torch.as_tensor(dim_idx, device=index.device).to(torch.int64),
                       0, N_DIMS - 1)
    ids = (dims * 1024)[..., None] + _index_bytes(index, shifts, offsets)[..., None, :]
    return _xor4(tab[ids])


def sobol_01_dyn(index, dim_idx, scramble=None):
    bits = sobol_bits_dyn(index, dim_idx)
    if scramble is not None:
        bits = bits ^ (scramble.to(torch.int64) & 0xFFFFFFFF)
    return _to_float01(bits)


# --- Faure-permuted Halton (reference src/libcore/qmc.cpp, faure.cpp) ---

_FAURE_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


@functools.lru_cache(maxsize=1)
def faure_permutations():
    """Digit permutations sigma_b of the first len(_FAURE_PRIMES) prime
    bases (Faure 1992's recursive construction; the reference
    precomputes them in faure.cpp).  [n_primes, max_b] int32, rows padded
    with the identity tail."""

    @functools.lru_cache(maxsize=None)
    def sigma(b):
        if b == 2:
            return (0, 1)
        if b % 2 == 0:
            h = sigma(b // 2)
            return tuple(2 * x for x in h) + tuple(2 * x + 1 for x in h)
        h = sigma(b - 1)
        c = (b - 1) // 2
        h2 = [x + 1 if x >= c else x for x in h]
        return tuple(h2[:c]) + (c,) + tuple(h2[c:])

    max_b = max(_FAURE_PRIMES)
    out = np.tile(np.arange(max_b, dtype=np.int32), (len(_FAURE_PRIMES), 1))
    for i, p in enumerate(_FAURE_PRIMES):
        out[i, :p] = sigma(p)
    return out


@functools.lru_cache(maxsize=None)
def _device_faure(device: torch.device) -> torch.Tensor:
    """faure_permutations() as float32 digits on `device`."""
    return torch.as_tensor(faure_permutations().astype(np.float32), device=device)


def halton_faure(index, prime_slot, rot=None):
    """Faure-permuted radical inverse in base _FAURE_PRIMES[prime_slot]
    (a static slot); index: uint32 words [...]; rot: an optional
    Cranley-Patterson rotation in [0,1) (reference qmc.h
    scrambledRadicalInverse).  Accumulates in float32 with the
    reference's float32 digit weights 1/p, 1/p/p, ..."""
    p = _FAURE_PRIMES[prime_slot]
    v = torch.as_tensor(index).to(torch.int64) & 0xFFFFFFFF
    perm = _device_faure(v.device)[prime_slot]
    n_digits = int(np.ceil(32.0 / np.log2(p)))
    x = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    f = np.float32(1.0 / p)
    for _ in range(n_digits):
        x = x + perm[v % p] * float(f)
        v = v // p
        f = np.float32(f / np.float32(p))
    if rot is not None:
        x = torch.remainder(x + rot, 1.0)
    return x
