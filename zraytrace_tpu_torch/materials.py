"""Branchless material scatter (forward).

Counterpart of ``zraytrace_tpu/materials.py``. Reference semantics:
material.zig — Lambertian (material.zig:71-77: normal + random unit
vector), Metal (material.zig:87-97: perfect mirror, absorbs when the
reflection points below the surface) and Dielectric (material.zig:109-128:
Schlick test, then refract or reflect; attenuation white). Every lane
evaluates all three candidates and selects by material tag.

Parity note: the reference's Schlick ``r0`` is NOT squared
(material.zig:126). The port keeps it so images compare pixel for pixel.
"""

from __future__ import annotations

import torch

from zraytrace_tpu_torch import rng as zrng
from zraytrace_tpu_torch import scene as sc
from zraytrace_tpu_torch import vecmath as vm
from zraytrace_tpu_torch.textures import texture_albedo

# Bandwidth of the relaxed total-internal-reflection indicator in
# ratio*sin_theta units (scatter's branch_grad).
TIR_EPS = 0.01


def schlick_reflectance(cosine: torch.Tensor, ref_ratio: torch.Tensor) -> torch.Tensor:
    """material.zig:125-127, unsquared r0. ``x**5`` is evaluated as
    ``x * (x*x)*(x*x)``, the product XLA's integer power forms."""
    r0 = (1.0 - ref_ratio) / (1.0 + ref_ratio)
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(scene: sc.Scene, d_in, normal, front_face, uv, mat_id, rnd,
            bilinear_textures: bool = False, branch_grad: bool = False):
    """Scatter a batch of rays off their hit surfaces.

    ``d_in``/``normal`` ``(N, 3)`` unit (normal flipped against the ray),
    ``front_face`` ``(N,)`` bool, ``uv`` ``(N, 2)``, ``mat_id`` ``(N,)``
    int, ``rnd`` ``(N, 4)`` U[0,1): [0:2] Lambertian direction, [2] the
    dielectric Fresnel test. ``bilinear_textures``: bilinear image lookup
    (the differentiable path's).

    Returns ``(new_dir (N,3) unit, attenuation (N,3), absorbed (N,))``,
    and with ``branch_grad`` also ``log_w (N,)`` and ``amp_mul (N,)``
    (``zraytrace_tpu/materials.py:142-187``):

    - ``log_w``: the log-probability of the Fresnel branch taken on
      dielectric lanes (0 elsewhere), with the total-internal-reflection
      threshold relaxed by a sigmoid of bandwidth ``TIR_EPS`` and the
      Schlick term clipped to [1e-4, 1 - 1e-4]. Every input but the IOR is
      detached, so its score-function gradient reaches only ``mat_ior``:
      every other gradient is the same with ``branch_grad`` on or off.
    - ``amp_mul`` (detached): the refraction's angular magnification
      ``ratio * cos_i / cos_t`` clipped to [1, 32] on refracted lanes, 1 on
      other non-diffuse lanes, 0 on a diffuse bounce (which resets the
      carried edge bandwidth).
    """
    mid = mat_id.long()
    mat_type = scene.mat_type[mid]
    ior = scene.mat_ior[mid]
    albedo = texture_albedo(scene, scene.mat_tex[mid], uv, bilinear_textures)

    # --- Lambertian (material.zig:71-77) ---
    ruv = zrng.random_unit_vector(rnd[:, 0], rnd[:, 1])
    lam_dir = normal + ruv
    # A (near-)zero direction falls back to the normal.
    degenerate = vm.length_squared(lam_dir) < 1e-12
    lam_dir = torch.where(degenerate[:, None], normal, lam_dir)

    # --- Metal (material.zig:87-97) ---
    met_dir = vm.reflect(d_in, normal)
    met_absorb = vm.dot(met_dir, normal) <= 0.0

    # --- Dielectric (material.zig:109-123) ---
    ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(vm.dot(-d_in, normal), max=1.0)
    sin_theta = vm.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = ratio * sin_theta > 1.0
    refl = schlick_reflectance(cos_theta, ratio)
    reflect_now = cannot_refract | (refl > rnd[:, 2])
    die_dir = torch.where(reflect_now[:, None], met_dir,
                          vm.refract(d_in, normal, ratio))

    # --- select by tag ---
    is_lam = (mat_type == sc.LAMBERTIAN)[:, None]
    is_met = (mat_type == sc.METAL)[:, None]
    new_dir = torch.where(is_lam, lam_dir, torch.where(is_met, met_dir, die_dir))
    new_dir = vm.normalize_safe(new_dir)  # Ray.init normalizes (ray.zig:11)

    attenuation = torch.where(is_lam | is_met, albedo, torch.ones_like(albedo))
    absorbed = (mat_type == sc.METAL) & met_absorb
    if not branch_grad:
        return new_dir, attenuation, absorbed

    # Relaxed probability of the branch taken: P(reflect) = s + (1-s) R,
    # P(refract) = (1-s)(1-R), s the soft TIR indicator, R the Schlick term
    # at the detached incidence angle.
    refl_d = schlick_reflectance(cos_theta.detach(), ratio)
    r_c = torch.clamp(refl_d, 1e-4, 1.0 - 1e-4)
    s = torch.sigmoid((ratio * sin_theta.detach() - 1.0) / TIR_EPS)
    w = torch.where(reflect_now, s + (1.0 - s) * r_c, (1.0 - s) * (1.0 - r_c))
    w = torch.clamp(w, min=1e-6)
    is_die = (mat_type != sc.LAMBERTIAN) & (mat_type != sc.METAL)
    log_w = torch.where(is_die, torch.log(w), 0.0)

    # angular magnification of a refraction, for the downstream edge band
    cos_t_out = vm.sqrt(torch.clamp(1.0 - ratio * ratio * (1.0 - cos_theta * cos_theta), min=1e-6))
    amp_refract = torch.clamp(ratio * cos_theta / cos_t_out, 1.0, 32.0)
    amp_mul = torch.where(is_die & ~reflect_now, amp_refract, 1.0)
    amp_mul = torch.where(is_lam[:, 0], 0.0, amp_mul).detach()
    return new_dir, attenuation, absorbed, log_w, amp_mul
