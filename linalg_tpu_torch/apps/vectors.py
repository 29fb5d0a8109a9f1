"""Hand-rolled 3-D vector toy with embedded self-tests — the port's copy
of ``linalg_tpu/apps/vectors.py`` (pure Python, no array library): a
``Vector`` class with add, scalar multiply, dot, cross, length, angle
(clamped acos) and cosine similarity, plus a unittest.TestCase of
known-answer identities.

    python -m linalg_tpu_torch.apps.vectors
"""

from __future__ import annotations

import math
import unittest
from typing import Iterable

__all__ = ["Vector"]


class Vector:
    """An immutable 3-D vector with the classic operations."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: float, y: float, z: float):
        object.__setattr__(self, "x", float(x))
        object.__setattr__(self, "y", float(y))
        object.__setattr__(self, "z", float(z))

    def __setattr__(self, *_):
        raise AttributeError("Vector is immutable")

    def __repr__(self):
        return f"Vector({self.x}, {self.y}, {self.z})"

    def __eq__(self, other):
        return (isinstance(other, Vector)
                and (self.x, self.y, self.z) == (other.x, other.y, other.z))

    def __add__(self, other: "Vector") -> "Vector":
        return Vector(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vector") -> "Vector":
        return Vector(self.x - other.x, self.y - other.y, self.z - other.z)

    def __mul__(self, s: float) -> "Vector":
        return Vector(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, other: "Vector") -> float:
        return self.x * other.x + self.y * other.y + self.z * other.z

    def cross(self, other: "Vector") -> "Vector":
        return Vector(
            self.y * other.z - self.z * other.y,
            self.z * other.x - self.x * other.z,
            self.x * other.y - self.y * other.x,
        )

    def length(self) -> float:
        return math.sqrt(self.dot(self))

    def angle(self, other: "Vector") -> float:
        """Angle in radians, acos argument clamped to [-1, 1]."""
        denom = self.length() * other.length()
        if denom == 0:
            raise ValueError("angle undefined for zero-length vector")
        c = max(-1.0, min(1.0, self.dot(other) / denom))
        return math.acos(c)

    def cosine_similarity(self, other: "Vector") -> float:
        denom = self.length() * other.length()
        if denom == 0:
            raise ValueError("cosine undefined for zero-length vector")
        return self.dot(other) / denom

    @classmethod
    def from_iterable(cls, it: Iterable[float]) -> "Vector":
        x, y, z = it
        return cls(x, y, z)


class VectorTests(unittest.TestCase):
    def setUp(self):
        self.ex = Vector(1, 0, 0)
        self.ey = Vector(0, 1, 0)
        self.ez = Vector(0, 0, 1)

    def test_add_sub(self):
        self.assertEqual(self.ex + self.ey, Vector(1, 1, 0))
        self.assertEqual(Vector(3, 2, 1) - Vector(1, 1, 1), Vector(2, 1, 0))

    def test_scalar_mul(self):
        self.assertEqual(2 * self.ex, Vector(2, 0, 0))
        self.assertEqual(self.ey * -1, Vector(0, -1, 0))

    def test_dot(self):
        self.assertEqual(self.ex.dot(self.ey), 0.0)
        self.assertEqual(Vector(1, 2, 3).dot(Vector(4, 5, 6)), 32.0)

    def test_cross_right_handed(self):
        self.assertEqual(self.ex.cross(self.ey), self.ez)
        self.assertEqual(self.ey.cross(self.ez), self.ex)
        self.assertEqual(self.ez.cross(self.ex), self.ey)

    def test_length(self):
        self.assertAlmostEqual(Vector(3, 4, 0).length(), 5.0)

    def test_angle(self):
        self.assertAlmostEqual(self.ex.angle(self.ey), math.pi / 2)
        self.assertAlmostEqual(self.ex.angle(self.ex), 0.0)
        self.assertAlmostEqual(self.ex.angle(-1 * self.ex), math.pi)

    def test_angle_clamping(self):
        # Nearly-parallel vectors must not blow up acos via roundoff.
        a = Vector(1, 1e-8, 0)
        self.assertAlmostEqual(a.angle(a), 0.0)

    def test_cosine_similarity(self):
        self.assertAlmostEqual(
            Vector(1, 0, 0).cosine_similarity(Vector(1, 1, 0)),
            1 / math.sqrt(2),
        )

    def test_zero_vector_raises(self):
        with self.assertRaises(ValueError):
            Vector(0, 0, 0).angle(self.ex)


if __name__ == "__main__":
    unittest.main()
