"""Exact replica of the C library's drand48/srand48 LCG.

The reference's scenes seed with srand48(1) (scenes/balls.c:178) and build
geometry from drand48() draws, so matching the C binary's golden frames
pixel-for-pixel requires reproducing the exact 48-bit sequence:

    X_{n+1} = (0x5DEECE66D * X_n + 0xB) mod 2^48
    srand48(s): X = (s << 16) | 0x330E
    drand48(): X / 2^48 (after advancing)
"""

_A = 0x5DEECE66D
_C = 0xB
_M = 1 << 48


class Drand48:
    def __init__(self, seed=0):
        self.srand48(seed)

    def srand48(self, seed):
        if seed is None:
            # never-seeded stream: glibc leaves X in its zero BSS state
            # (only a and c get set on first use)
            self._x = 0
        else:
            self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def drand48(self) -> float:
        self._x = (_A * self._x + _C) % _M
        return self._x / _M

    def lrand48(self) -> int:
        """Non-negative long: high 31 bits of the next state."""
        self._x = (_A * self._x + _C) % _M
        return self._x >> 17

    def __call__(self) -> float:
        return self.drand48()
