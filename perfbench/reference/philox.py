"""The edge dropout's keep mask, from its published definition: for graph
g, edge id e (the edge's column in the edge list) and channel c, word
(c/32) % 4 of Philox4x32-10 with counter (c%32 + 32*(c/128), e, g, 0) and
key (seed, 0); the edge is kept where that word is at least
round(p * 2^32).  Integer arithmetic on int64 tensors holding uint32
values."""

import torch

U32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of m * x for uint32 x held in int64, by 16-bit
    halves of m so that nothing overflows."""
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    low = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (low >> 32), low & U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    k0, k1 = k0 & U32, k1 & U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & U32
        k1 = (k1 + PHILOX_W[1]) & U32
    return c0, c1, c2, c3


def edge_keep(seed: torch.Tensor, p: float, g: int, e: int, h: int,
              graph0: int = 0) -> torch.Tensor:
    """(G, E, H) bool keep mask of graphs graph0 .. graph0 + G - 1."""
    dev = seed.device
    c = torch.arange(h, device=dev)
    group = (c % 32 + 32 * (c // 128)).view(1, 1, h)
    word = ((c // 32) % 4).view(1, 1, h)
    eid = torch.arange(e, device=dev).view(1, e, 1)
    gid = (graph0 + torch.arange(g, device=dev)).view(g, 1, 1)
    key = seed.long().reshape(1, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    shape = (g, e, h)
    w = philox4x32(group.expand(shape), eid.expand(shape), gid.expand(shape),
                   zero, key, zero)
    out = torch.where(word == 0, w[0], w[1])
    out = torch.where(word == 2, w[2], out)
    out = torch.where(word == 3, w[3], out)
    return out >= min(int(round(p * 4294967296.0)), U32)
