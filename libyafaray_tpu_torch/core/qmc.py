"""QMC sampling — hash-based Owen-scrambled Sobol (0,2) pairs, lane-wise.

Port of libyafaray_tpu/core/qmc.py; the stream is bit-identical to it.

The reference computes in uint32.  torch has no `>>` for uint32 on the
CPU, so the words are held in **int32**, where `+`, `*`, `^`, `&`, `|` and
`<<` wrap exactly like uint32.  A logical right shift is emulated as
`(x >> k) & ((1 << (32 - k)) - 1)` (`_srl`), and a word is widened to
int64 with `& 0xFFFFFFFF` only to convert it to float.  Constants above
2^31 - 1 are written as their int32 two's-complement value (`i32`).

Dimension allocation (same as the reference):
  dims 0,1  pixel AA offset        (pair)
  dims 2,3  lens / DOF             (pair)
  per bounce b, block of DIMS_PER_BOUNCE starting at 4 + 6b:
    +0,+1  bsdf u,v                (pair)
    +2,+3  light u,v               (pair)
    +4     light pick
    +5     russian roulette
"""
from __future__ import annotations

import torch

DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1
DIM_LENS_U = 2
DIM_LENS_V = 3
BOUNCE_DIMS_START = 4
DIMS_PER_BOUNCE = 6
SLOT_BSDF_U = 0
SLOT_BSDF_V = 1
SLOT_LIGHT_U = 2
SLOT_LIGHT_V = 3
SLOT_LIGHT_PICK = 4
SLOT_RR = 5


def i32(v: int) -> int:
    """uint32 constant -> the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32 word by a static k in 1..31."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _sobol2_dirs() -> tuple:
    """Direction numbers of the second Sobol dimension:
    v_k = v_{k-1} ^ (v_{k-1} >> 1)."""
    v = [0x80000000]
    for _ in range(1, 32):
        v.append(v[-1] ^ (v[-1] >> 1))
    return tuple(i32(x) for x in v)


_SOBOL2_DIRS = _sobol2_dirs()


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in a wider int tensor -> int32 words (same bits)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def u32_to_float(x: torch.Tensor) -> torch.Tensor:
    """The uint32 word's value as float32 (round to nearest, as XLA's
    u32 -> f32 convert)."""
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash (Chris Wellons), uint32 -> uint32."""
    x = x ^ _srl(x, 16)
    x = x * i32(0x7FEB352D)
    x = x ^ _srl(x, 15)
    x = x * i32(0x846CA68B)
    x = x ^ _srl(x, 16)
    return x


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return hash_u32(a ^ (hash_u32(b) + i32(0x9E3779B9)))


def reverse_bits32(n: torch.Tensor) -> torch.Tensor:
    n = (n << 16) | _srl(n, 16)
    n = ((n & i32(0x00FF00FF)) << 8) | _srl(n & i32(0xFF00FF00), 8)
    n = ((n & i32(0x0F0F0F0F)) << 4) | _srl(n & i32(0xF0F0F0F0), 4)
    n = ((n & i32(0x33333333)) << 2) | _srl(n & i32(0xCCCCCCCC), 2)
    n = ((n & i32(0x55555555)) << 1) | _srl(n & i32(0xAAAAAAAA), 1)
    return n


def _sobol2_bits(idx: torch.Tensor) -> torch.Tensor:
    """Second Sobol dimension sample bits for index array idx."""
    out = torch.zeros_like(idx)
    for k in range(32):
        bit = (_srl(idx, k) if k else idx) & 1
        out = out ^ (bit * _SOBOL2_DIRS[k])
    return out


def nested_uniform_scramble(x: torch.Tensor,
                            seed: torch.Tensor) -> torch.Tensor:
    """Hash-based Owen scramble of sample bits x with seed."""
    x = reverse_bits32(x)
    x = x + seed
    x = x ^ (x * i32(0x6C50B47C))
    x = x ^ (x * i32(0xB82F1E52))
    x = x ^ (x * i32(0xC7AFE638))
    x = x ^ (x * i32(0x8D22F6E6))
    return reverse_bits32(x)


def _shuffled_index(sample_idx: torch.Tensor, scramble_key: torch.Tensor,
                    pair_key: int) -> torch.Tensor:
    """Owen-shuffle the sample index per (pixel, dimension pair)."""
    pk = i32((pair_key * 0x9E3779B9 + 0x55AACC33) & 0xFFFFFFFF)
    seed = hash_u32(scramble_key ^ pk)
    return nested_uniform_scramble(sample_idx, seed)


def bounce_dim(bounce: int, slot: int) -> int:
    """Dimension index for a given bounce and slot (static ints)."""
    return BOUNCE_DIMS_START + bounce * DIMS_PER_BOUNCE + slot


def word_like(x: torch.Tensor, v: int) -> torch.Tensor:
    """0-dim int32 word holding uint32 v, on the device of x."""
    return torch.full((), i32(v), dtype=torch.int32, device=x.device)


def sample_dim(sample_idx: torch.Tensor, dim: int,
               scramble_key: torch.Tensor) -> torch.Tensor:
    """One component of the Sobol pair (dim >> 1) at the static `dim`, odd
    or even: the value sample_dim_pair gives for that component."""
    idx = _shuffled_index(sample_idx, scramble_key, dim >> 1)
    bits = _sobol2_bits(idx) if dim % 2 else reverse_bits32(idx)
    u = nested_uniform_scramble(
        bits, hash_combine(scramble_key, word_like(idx, dim)))
    return _srl(u, 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_dim_pair(sample_idx: torch.Tensor, dim: int,
                    scramble_key: torch.Tensor):
    """Both components of the (even, odd) Sobol pair starting at the static
    even `dim`.  sample_idx, scramble_key: int32 words (lanes)."""
    if dim % 2:
        raise ValueError(f"sample_dim_pair: dim {dim} must be even")
    idx = _shuffled_index(sample_idx, scramble_key, dim >> 1)
    b0 = reverse_bits32(idx)
    b1 = _sobol2_bits(idx)
    u0 = nested_uniform_scramble(
        b0, hash_combine(scramble_key, word_like(idx, dim)))
    u1 = nested_uniform_scramble(
        b1, hash_combine(scramble_key, word_like(idx, dim + 1)))
    inv = 1.0 / (1 << 24)
    return (_srl(u0, 8).to(torch.float32) * inv,
            _srl(u1, 8).to(torch.float32) * inv)


def dynamic_sample_dim(sample_idx: torch.Tensor, dim,
                       scramble_key: torch.Tensor) -> torch.Tensor:
    """Deep-bounce sampler: pure hash noise keyed by (key, dim, index).
    `dim` is an int or an int32 tensor."""
    if not isinstance(dim, torch.Tensor):
        dim = word_like(scramble_key, dim)
    h = hash_combine(hash_combine(scramble_key, dim), sample_idx)
    return u32_to_float(h) * 2.3283064365386963e-10
