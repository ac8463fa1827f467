"""Dropout masks from one counter-based stream, shared by the CUDA kernels
and their plain PyTorch versions.

The TPU kernels draw their masks from the on-core PRNG
(``pltpu.prng_random_bits``), which nothing off the TPU reproduces.  The
port defines its own stream instead: Philox4x32-10 (Salmon et al., SC'11),
whose device side is ``csrc/philox.cuh`` and whose plain twin is this module.

- **Addressing.**  A mask element is a function of ``(seed, stream, idx)``
  only, where ``idx`` is the element's flat index in its tensor: attention
  addresses ``(b, h, i, j)`` of its ``(B, H, L, L)`` weights; the MLP
  addresses ``(row, col)`` of its ``(M, K)``, ``(M, H)`` and ``(M, N)``
  tensors.  Philox's counter is ``(idx // 4 low word, idx // 4 high word,
  stream, 0)`` and its key the seed's two words; the element takes output
  word ``idx % 4``.  So the forward kernel, the backward kernel and this
  twin draw identical masks, whatever their block layout.
- **Keep rule** (the TPU kernels' ``_dropout_scale``): keep iff the 32 bits
  are ``>= min(floor(rate * 2**32), 2**32 - 1)``; a kept element is scaled
  by ``1 / (1 - rate)`` in float32.  The host computes the threshold and the
  scale once (:func:`threshold_and_scale`) and hands both to the kernels.
- **The product trap.**  Philox multiplies 32-bit words into 64 bits, which
  overflows int64.  :func:`_mulhilo` splits the constant into 16-bit limbs,
  so every intermediate stays below 2**49 and the twin is exact.
- **Seeds in device memory.**  A kernel reads its seed through a
  :class:`SeedRef`: a 0-d int64 base on the device and the call's index
  ``k``, fixed when a CUDA graph records the call.  The call's seed is
  :func:`derive_seed` ``(base, k)``, Philox of counter ``(k, 0,
  STREAM_DERIVE, 0)`` under the key ``base``; ``k < 0`` takes the base
  itself.  A train step draws one 63-bit base (:class:`StepSeeds`), so a
  replayed graph draws fresh masks, and eager and replayed steps draw the
  same masks from the same generator state.  A host int seed is the seed
  itself, as before; the plain versions take either and give the kernels'
  masks bit for bit, the derivation included, without reading the device.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

# stream ids (csrc/philox.cuh Stream)
STREAM_ATTENTION, STREAM_PRE, STREAM_MID, STREAM_POST, STREAM_DERIVE = 0, 1, 2, 3, 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for int64 ``a`` in [0, 2**32)."""
    p_lo = a * (b & 0xFFFF)  # < 2**48
    p_hi = a * (b >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # a * b == (p_hi >> 16) * 2**32 + t
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int]):
    """Philox4x32-10 on int64 tensors holding 32-bit words; returns 4 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


class SeedRef(NamedTuple):
    """A kernel call's seed as the kernel reads it (csrc/philox.cuh
    ``SeedRef``): ``base``, a 0-d int64 tensor on the call's device, and
    ``index``, the call's ``k`` in its step (``< 0``: the base is the seed)."""

    base: torch.Tensor
    index: int


Seed = Union[int, torch.Tensor, SeedRef]  # a host seed, a 0-d int64 tensor, or a SeedRef

_SEED_BITS = 0x7FFFFFFF  # a derived seed keeps 63 bits: its high word's top bit is 0


def derive_seed(base, index: int):
    """``seed(base, k)`` of csrc/philox.cuh, for an int or a 0-d int64
    tensor ``base`` (then a tensor, computed where it lies)."""
    if index < 0:
        return base
    x, y, _, _ = philox4x32((index, 0, STREAM_DERIVE, 0), (base & _MASK32, (base >> 32) & _MASK32))
    return ((y & _SEED_BITS) << 32) | x


def resolve_seed(seed: Seed):
    """The seed a plain version draws its masks from: an int, or a 0-d
    int64 tensor where the seed lives in device memory."""
    if isinstance(seed, SeedRef):
        return derive_seed(seed.base, seed.index)
    return seed if isinstance(seed, torch.Tensor) else int(seed)


def random_bits(seed, stream: int, n: int, device=None) -> torch.Tensor:
    """The first ``n`` 32-bit words of ``(seed, stream)``, as int64 (n,);
    ``seed`` is an int or a 0-d int64 tensor."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32(
        (groups & _MASK32, groups >> 32, zero + stream, zero),
        (seed & _MASK32, (seed >> 32) & _MASK32),
    )
    return torch.stack(words, dim=1).reshape(-1)[:n]


def threshold_and_scale(rate: float) -> Tuple[int, float]:
    """The keep threshold on the 32 bits and the scale of a kept element."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(rate * 2**32), 2**32 - 1), 1.0 / (1.0 - rate)


def keep_scale(
    seed: Seed, stream: int, shape: Sequence[int], rate: float, device=None
) -> torch.Tensor:
    """float32 mask of ``shape``: ``1 / (1 - rate)`` where kept, else 0,
    element ``idx`` of the flattened shape drawn from ``(seed, stream, idx)``
    (``seed`` as :func:`resolve_seed` takes it)."""
    threshold, scale = threshold_and_scale(rate)
    bits = random_bits(resolve_seed(seed), stream, math.prod(int(d) for d in shape), device)
    return ((bits >= threshold).to(torch.float32) * scale).reshape(tuple(shape))


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A fresh 63-bit kernel seed from a CPU ``generator`` (torch's default
    CPU generator when None).  Host only: it never waits on the card."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``: on a card through pinned memory, copied
    without waiting (the allocator keeps the pinned buffer until the copy
    has run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StepSeeds:
    """The seed source of one trainer's kernel calls, shared by its modules
    (``nn.core.set_dropout_generator``).

    A train step draws one 63-bit base from ``generator`` (a CPU
    ``torch.Generator``; torch's default one when None) into a 0-d int64
    tensor on its device (:meth:`draw_tensor`), and runs inside
    :meth:`step`: there the k-th call of :meth:`next` returns ``SeedRef(base,
    k)``.  A CUDA graph records ``k`` and the base's address, so each
    replay draws from whatever base the step copied in.  Outside a step
    (a module called on its own) each call draws a fresh host seed."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.base: Optional[torch.Tensor] = None
        self.calls = 0

    def draw(self) -> int:
        return draw_seed(self.generator)

    def draw_tensor(self, device) -> torch.Tensor:
        return host_to_device(torch.tensor(self.draw(), dtype=torch.int64), device)

    def next(self) -> Seed:
        if self.base is None:
            return self.draw()
        ref = SeedRef(self.base, self.calls)
        self.calls += 1
        return ref

    @contextlib.contextmanager
    def step(self, base: Optional[torch.Tensor]):
        """The calls inside draw from ``base``, numbered from 0."""
        self.base, self.calls = base, 0
        try:
            yield self
        finally:
            self.base, self.calls = None, 0
