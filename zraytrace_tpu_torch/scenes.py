"""Scene library (scenes.zig:26-277); counterpart of
``zraytrace_tpu/scenes.py``, with the same constants. Scene indices 0-5
match ``render_scene`` (scenes.zig:267-277). Scene 5 (goat) raises
``FileNotFoundError``: its asset is absent upstream too; ``goat_class``
is the JAX package's synthetic stand-in at its scale. Each builder is a
``scene.build`` span (``profiling``), with ``io.png``, ``io.obj`` and
``bvh.build`` inside where it reads or builds them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

from zraytrace_tpu_torch import scene as sc
from zraytrace_tpu_torch.camera import Camera, make_camera
from zraytrace_tpu_torch.io.obj import read_obj
from zraytrace_tpu_torch.io.png import read_png
from zraytrace_tpu_torch.profiling import span
from zraytrace_tpu_torch.scene import Scene, SceneBuilder


def assets_dir() -> Path:
    env = os.environ.get("ZRAYTRACE_ASSETS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / "assets" / "models"


class BuiltScene(NamedTuple):
    scene: Scene
    camera: Camera
    name: str


# The big ground ball shared by all mesh scenes (scenes.zig:40-43 etc.).
_EARTH_X = 1.66445508e-01
_EARTH_Z = 7.37018966e00
_EARTH_RADIUS = 100.0


def _ground(b: SceneBuilder, top: float) -> None:
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((_EARTH_X, top - _EARTH_RADIUS, _EARTH_Z), _EARTH_RADIUS, green)


def _add_model(b: SceneBuilder, obj_name: str, mat_id: int) -> None:
    a, bb, c = read_obj(assets_dir() / obj_name).tri_vertices
    b.add_triangles(a, bb, c, mat_id)


def _camera(look_from, device) -> Camera:
    return make_camera(look_from, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0, 1.0, device=device)


@span("scene.build")
def man_and_ball(device="cuda") -> BuiltScene:
    """Scene 0 (scenes.zig:26-52): Man.obj in blue metal on the ground."""
    b = SceneBuilder()
    _ground(b, top=-2.33)
    _add_model(b, "man/Man.obj", b.add_metal_color(sc.COLOR_BLUE))
    return BuiltScene(b.build(device), _camera((0.0, 0.0, -30.0), device), "manAndBall")


@span("scene.build")
def three_balls(device="cuda") -> BuiltScene:
    """Scene 1 (scenes.zig:54-100): ground, nitor-logo Lambertian, silver
    mirror, earth-mapped metal, filled glass and a hollow glass bubble
    (nested spheres r=0.9 / r=-0.8, IOR 1.52)."""
    b = SceneBuilder()
    images = assets_dir() / "images"
    earthmap = read_png(images / "earthmap.png")
    nitor = read_png(images / "nitor-logo-25.png")

    green = b.add_lambertian_color(sc.COLOR_GREEN)
    nitor_mat = b.add_lambertian(b.add_image_texture(nitor))
    mirror = b.add_metal_color(sc.COLOR_SILVER)
    earth_mat = b.add_metal(b.add_image_texture(earthmap))
    glass = b.add_dielectric(1.52)  # window glass (scenes.zig:80)

    b.add_sphere((1.0, -102.5, 4.0), 100.0, green)
    b.add_sphere((0.0, 0.0, 8.0), 2.0, nitor_mat)
    b.add_sphere((-3.0, -1.5, 3.0), 1.0, mirror)
    b.add_sphere((3.0, -1.0, 4.0), 1.5, earth_mat)
    b.add_sphere((-1.0, -1.0, 2.0), 0.7, glass)  # filled glass
    # hollow glass bubble (scenes.zig:92-96)
    bubble_center = (0.85, -0.7, 1.5)
    radius, thickness = 0.9, 0.1
    b.add_sphere(bubble_center, radius, glass)
    b.add_sphere(bubble_center, -(radius - thickness), glass)

    camera = make_camera((0.0, 0.0, -7.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0,
                         1.0, device=device)
    return BuiltScene(b.build(device), camera, "threeBalls")


@span("scene.build")
def bunny_and_ball(device="cuda") -> BuiltScene:
    """Scene 2 (scenes.zig:102-126): bunny.obj in silver metal."""
    b = SceneBuilder()
    _ground(b, top=-0.33)
    _add_model(b, "bunny/bunny.obj", b.add_metal_color(sc.COLOR_SILVER))
    return BuiltScene(b.build(device), _camera((0.0, 0.0, -0.5), device), "bunnyAndBall")


@span("scene.build")
def teapot_and_ball(device="cuda") -> BuiltScene:
    """Scene 3 (scenes.zig:206-231): teapot.obj in blue metal."""
    b = SceneBuilder()
    _ground(b, top=-2.33)
    _add_model(b, "teapot/teapot.obj", b.add_metal_color(sc.COLOR_BLUE))
    return BuiltScene(b.build(device), _camera((0.0, 0.0, -10.0), device), "teapotAndBall")


@span("scene.build")
def teapot_and_ball_circle(device="cuda") -> BuiltScene:
    """Scene 4 (scenes.zig:168-204): teapot + inward silver sphere
    (negative radius, scenes.zig:195) + earthmap Lambertian ball."""
    b = SceneBuilder()
    earthmap = read_png(assets_dir() / "images" / "earthmap.png")
    silver = b.add_metal_color(sc.COLOR_SILVER)
    purple_matte = b.add_lambertian(b.add_image_texture(earthmap))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    blue_metal = b.add_metal_color(sc.COLOR_BLUE)
    b.add_sphere((0.0, 0.0, 6.0), -2.0, silver)
    b.add_sphere((3.0, -1.0, 4.0), 1.0, purple_matte)
    top = -2.33
    b.add_sphere((_EARTH_X, top - _EARTH_RADIUS, _EARTH_Z), _EARTH_RADIUS, green)
    _add_model(b, "teapot/teapot.obj", blue_metal)
    return BuiltScene(b.build(device), _camera((-8.0, 0.0, -10.0), device),
                      "teapotAndBallCircle")


@span("scene.build")
def goat(device="cuda") -> BuiltScene:
    """Scene 5 (scenes.zig:234-260): high_poly_goat.obj — the asset is
    absent from the reference repo too, so this raises
    ``FileNotFoundError``."""
    b = SceneBuilder()
    _add_model(b, "high_poly_goat.obj", b.add_metal_color(sc.COLOR_SILVER))
    _ground(b, top=-2.33)
    return BuiltScene(b.build(device), _camera((0.0, 0.0, -1.7), device), "goat")


@span("scene.build")
def teapot_on_ground(device="cuda") -> BuiltScene:
    """The teapot pose fit's scene (``tools/diff_bench.py:149-158``,
    ``examples/mesh_fit.py``): the 6,320-triangle teapot in red Lambertian
    on a green ground sphere, seen from above and in front. Not one of the
    reference's numbered scenes."""
    b = SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(sc.COLOR_GREEN))
    _add_model(b, "teapot/teapot.obj", b.add_lambertian_color((0.7, 0.15, 0.1)))
    camera = make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), 50.0, 1.0,
                         device=device)
    return BuiltScene(b.build(device), camera, "teapotOnGround")


@span("scene.build")
def goat_class(device="cuda") -> BuiltScene:
    """The goat-class stand-in for scene 5 (``tools/goat_probe.py:31``
    ``build_goat_class_scene``): a 5x5 grid of teapots 8 apart in blue
    metal, 158,000 triangles, on a green ground sphere. Not one of the
    reference's numbered scenes; the scale case of the mesh kernels, its
    anchor ``showcase/goat_class_256x256_64spp.png``."""
    a, bb, c = read_obj(assets_dir() / "teapot/teapot.obj").tri_vertices
    b = SceneBuilder()
    b.add_sphere((0.0, -102.33, 7.0), 100.0, b.add_lambertian_color(sc.COLOR_GREEN))
    blue = b.add_metal_color(sc.COLOR_BLUE)
    offs = [np.asarray([(gx - 2) * 8.0, 0.0, (gz - 2) * 8.0], np.float32)
            for gx in range(5) for gz in range(5)]
    b.add_triangles(*(np.concatenate([x + off for off in offs]) for x in (a, bb, c)), blue)
    camera = make_camera((0.0, 8.0, -30.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 55.0, 1.0,
                         device=device)
    return BuiltScene(b.build(device), camera, "goatClass")


SCENES: dict[int, Callable[..., BuiltScene]] = {
    0: man_and_ball,
    1: three_balls,
    2: bunny_and_ball,
    3: teapot_and_ball,
    4: teapot_and_ball_circle,
    5: goat,
}


class UnknownSceneIndex(KeyError):
    """scenes.zig:263-265."""


def build_scene(index: int, device="cuda") -> BuiltScene:
    try:
        builder = SCENES[index]
    except KeyError:
        raise UnknownSceneIndex(index) from None
    return builder(device)
