"""Small math helpers shared across the package.

Counterpart of `rayfinder_tpu.utils.math`. Semantics follow the reference's
utility headers (src/common/math.hpp:7-17, src/common/r_sequence.hpp:11-22,
src/common/units/angle.hpp:9-36), vectorized over numpy arrays and torch
tensors (where the JAX package takes jax arrays).
"""

from __future__ import annotations

import numpy as np
import torch


def fract(x):
    """Fractional part, rounding toward zero for negative inputs.

    Matches src/common/math.hpp:7-17: x - floor(x) for x >= 0, x - ceil(x)
    otherwise (so fract(-1.25) == -0.25, unlike GLSL's fract). Works on
    numpy arrays and torch tensors alike.
    """
    if isinstance(x, torch.Tensor):
        return torch.where(x >= 0, x - torch.floor(x), x - torch.ceil(x))
    x = np.asarray(x)
    return np.where(x >= 0, x - np.floor(x), x - np.ceil(x))


def gpu_fract(x):
    """GLSL/WGSL fract: x - floor(x), always in [0, 1)."""
    if isinstance(x, torch.Tensor):
        return x - torch.floor(x)
    x = np.asarray(x)
    return x - np.floor(x)


# Plastic-constant additive recurrence (src/common/r_sequence.hpp:14-16).
_R2_G = np.float32(1.32471795)
_R2_A1 = np.float32(1.0) / _R2_G
_R2_A2 = np.float32(1.0) / (_R2_G * _R2_G)


def r2_sequence(n, sequence_length):
    """2D quasirandom R2 sequence point(s) for index n (mod sequence_length).

    Matches src/common/r_sequence.hpp:11-22. Returns an array with a trailing
    dimension of 2.
    """
    i = np.float32(np.asarray(n) % sequence_length)
    x = fract(np.float32(0.5) + _R2_A1 * i)
    y = fract(np.float32(0.5) + _R2_A2 * i)
    return np.stack([x, y], axis=-1)


def degrees_to_radians(deg):
    return np.asarray(deg, dtype=np.float32) * np.float32(np.pi / 180.0)


class Angle:
    """Strongly-typed angle (src/common/units/angle.hpp:9-36).

    Constructed only via the named factories; stores float32 radians and
    converts with float32 pi exactly like the reference (pi_v<float>)."""

    __slots__ = ("_radians",)
    _PI_F = np.float32(np.pi)

    def __init__(self, _radians=None, *, _token=None):
        if _token is not Angle:
            raise TypeError("use Angle.degrees(x) or Angle.radians(x)")
        self._radians = np.float32(_radians)

    @staticmethod
    def degrees(deg) -> "Angle":
        return Angle(np.float32(deg) * Angle._PI_F / np.float32(180.0), _token=Angle)

    @staticmethod
    def radians(rad) -> "Angle":
        return Angle(np.float32(rad), _token=Angle)

    def as_degrees(self) -> np.float32:
        return np.float32(self._radians * np.float32(180.0) / Angle._PI_F)

    def as_radians(self) -> np.float32:
        return self._radians

    def __add__(self, rhs: "Angle") -> "Angle":
        return Angle.radians(self._radians + rhs._radians)

    def __lt__(self, rhs: "Angle") -> bool:
        if np.isnan(self._radians) or np.isnan(rhs._radians):
            raise ValueError("an Angle of NaN radians has no order")
        return bool(self._radians < rhs._radians)

    def __eq__(self, rhs) -> bool:
        return isinstance(rhs, Angle) and self._radians == rhs._radians

    def __hash__(self):
        return hash(("Angle", float(self._radians)))

    def __repr__(self):
        return f"Angle.radians({float(self._radians)!r})"


class Extent2:
    """2D extent (src/common/extent.hpp:7-33): x/y with equality,
    aspect_ratio and area helpers. `dtype` plays the template parameter's
    role (Extent2i/u/f): components are coerced through it."""

    __slots__ = ("x", "y", "dtype")

    def __init__(self, x=0, y=0, dtype=np.int32):
        self.dtype = np.dtype(dtype)
        self.x = self.dtype.type(x)
        self.y = self.dtype.type(y)

    def astype(self, dtype) -> "Extent2":
        return Extent2(self.x, self.y, dtype=dtype)

    def aspect_ratio(self) -> np.float32:
        """extent.hpp:36-39 (float division regardless of dtype)."""
        return np.float32(np.float32(self.x) / np.float32(self.y))

    def area(self):
        """extent.hpp:42-45 (in the component dtype, like the reference)."""
        return self.dtype.type(self.x * self.y)

    def __eq__(self, rhs) -> bool:
        return isinstance(rhs, Extent2) and self.x == rhs.x and self.y == rhs.y

    def __hash__(self):
        return hash(("Extent2", float(self.x), float(self.y)))

    def __repr__(self):
        return f"Extent2({self.x}, {self.y}, dtype={self.dtype.name})"


class BitFlags:
    """Scoped-enum flag set (src/common/bit_flags.hpp:13-52): construct
    from any number of enum members, query with has(), extend with add().
    `none()`/`all()` mirror the reference factories (all() needs the enum
    to size the mask)."""

    __slots__ = ("_flags",)

    def __init__(self, *flags):
        self._flags = 0
        for f in flags:
            self.add(f)

    @staticmethod
    def none() -> "BitFlags":
        return BitFlags()

    @staticmethod
    def all(enum_cls) -> "BitFlags":
        out = BitFlags()
        for member in enum_cls:
            out.add(member)
        return out

    def has(self, flag) -> bool:
        v = int(flag.value if hasattr(flag, "value") else flag)
        return (self._flags & v) == v

    def add(self, flag) -> None:
        self._flags |= int(flag.value if hasattr(flag, "value") else flag)

    def __eq__(self, rhs) -> bool:
        return isinstance(rhs, BitFlags) and self._flags == rhs._flags

    def __hash__(self):
        return hash(("BitFlags", self._flags))

    def __repr__(self):
        return f"BitFlags(0x{self._flags:x})"
