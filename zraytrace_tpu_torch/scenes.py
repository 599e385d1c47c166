"""Scene library (scenes.zig:26-277); counterpart of
``zraytrace_tpu/scenes.py``.

Only scene 1 (threeBalls, the 7-spheres showcase) is ported so far. The
mesh scenes need the OBJ reader, the BVH and the triangle kernels, which
ROADMAP.md Queue 1 item 8 ports; asking for them raises
``NotImplementedError`` naming that item.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, NamedTuple

from zraytrace_tpu_torch import scene as sc
from zraytrace_tpu_torch.camera import Camera, make_camera
from zraytrace_tpu_torch.io.png import read_png
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


def three_balls(device="cpu") -> BuiltScene:
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


SCENES: dict[int, Callable[..., BuiltScene]] = {1: three_balls}

# Scenes of the reference that need the mesh slice (ROADMAP.md Queue 1,
# item 8: triangles, OBJ, BVH and mixed scenes).
_MESH_SCENES = {0: "manAndBall", 2: "bunnyAndBall", 3: "teapotAndBall",
                4: "teapotAndBallCircle", 5: "goat"}


class UnknownSceneIndex(KeyError):
    """scenes.zig:263-265."""


def build_scene(index: int, device="cpu") -> BuiltScene:
    if index in _MESH_SCENES:
        raise NotImplementedError(
            f"scene {index} ({_MESH_SCENES[index]}) holds a mesh; the port "
            "renders it once ROADMAP.md Queue 1 item 8 (triangles, OBJ, BVH "
            "and mixed scenes) is done")
    try:
        builder = SCENES[index]
    except KeyError:
        raise UnknownSceneIndex(index) from None
    return builder(device)
