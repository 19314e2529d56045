"""Differentiable sphere raytracer for inverse rendering.

Parity: reference examples/inverse_rendering/inverse_rendering.nim — a
scene of spheres is rendered by a single DSL kernel (one big scalar
expression per output pixel/channel); because the whole renderer is written
in the language, the compiler derives its gradient, and scene parameters
(sphere colors here) can be optimized to match a target image.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..expr import Scalar, as_scalar, iters, maximum, select, sqrt, to_scalar
from ..fun import Fun, input


@dataclass
class Vec3:
    x: Scalar
    y: Scalar
    z: Scalar

    def dot(self, other: "Vec3") -> Scalar:
        return self.x * other.x + self.y * other.y + self.z * other.z

    def scale(self, s) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def length(self) -> Scalar:
        return sqrt(self.dot(self))

    def normalize(self) -> "Vec3":
        inv = 1.0 / self.length()
        return self.scale(inv)


def vec3_of(fun: Fun, *indices) -> Vec3:
    return Vec3(
        fun[(*indices, 0)], fun[(*indices, 1)], fun[(*indices, 2)]
    )


@dataclass
class Sphere:
    geometry: Fun  # [4]: x, y, z, radius
    color: Fun     # [3]


@dataclass
class Scene:
    background: Fun  # [3]
    spheres: Sequence[Sphere]
    light: Fun       # [3]
    camera: Fun      # [1]: focal z


def _raycast_sphere(sphere: Sphere, direction: Vec3):
    """Ray/sphere intersection from the origin along ``direction``.

    Solves |d*t - p| = r for t; returns (hit, t, surface normal).
    """
    pos = vec3_of(sphere.geometry)
    radius = sphere.geometry[3]
    c = pos.dot(pos) - radius * radius
    b = 2.0 * pos.dot(direction)
    a = direction.dot(direction)
    disc = b * b - 4.0 * a * c
    hit = disc >= 0.0
    e = sqrt(maximum(disc, 0.0))
    t1 = (b + e) / (2.0 * a)
    t2 = (b - e) / (2.0 * a)
    t = select(t1 < t2, t1, t2)
    normal = (direction.scale(t) - pos).normalize()
    return hit, t, normal


def _raycast(scene: Scene, direction: Vec3, light_dir: Vec3, comp,
             view_distance: float = 100.0) -> Scalar:
    result = scene.background[comp]
    min_dist: Scalar = as_scalar(view_distance)
    for sphere in scene.spheres:
        hit, t, normal = _raycast_sphere(sphere, direction)
        is_closer = hit & (t > 0.0) & (t < min_dist)
        intensity = maximum(normal.dot(light_dir), 0.0)
        color = intensity * sphere.color[comp]
        result = select(is_closer, color, result)
        min_dist = select(is_closer, t, min_dist)
    return result


def render(scene: Scene, width: int, height: int) -> Fun:
    """One kernel computing every pixel channel of the rendered image."""
    y, x, c = iters("y", "x", "c")
    out = Fun("render")
    direction = Vec3(
        to_scalar(x) / float(width) - 0.5,
        -(to_scalar(y) / float(height) - 0.5),
        scene.camera[0],
    )
    light_dir = vec3_of(scene.light).normalize()
    out[y, x, c] = _raycast(scene, direction, light_dir, c)
    out.with_shape([height, width, 3])
    return out


def two_sphere_scene(trainable_colors: bool = False) -> Scene:
    from ..fun import param

    def color(name: str) -> Fun:
        if trainable_colors:
            return param([3], init_range=(0.0, 1.0), name=name)
        return input(name, [3])

    return Scene(
        background=input("background", [3]),
        spheres=[
            Sphere(geometry=input("sphere0.geom", [4]), color=color("sphere0.color")),
            Sphere(geometry=input("sphere1.geom", [4]), color=color("sphere1.color")),
        ],
        light=input("light", [3]),
        camera=input("camera"),
    )
