"""Ties and edges of the flash winner and the margin selection, on their
plain PyTorch versions: the contract the CUDA kernels' lane-parallel
reduction must keep (``tests/test_torch_gpu.py`` holds the kernels to the
plain versions on the same cases).

- Exact duplicates, in one chunk or in two: the first in packed order
  wins, for the winner, the near miss (equal ``m``), the occluder and the
  winner at ``t_cap`` (equal ``t``).
- A hit tied with ``t_init``: the seed keeps it, ``hit`` is False.
- Miss rays (``t_cap`` 3.4e38) select no occluder and no winner.

Triangles are packed in input order (no BVH order), so the packed position
is the original id. Every triangle not under test is a small filler far
off the rays. No JAX: the card's tests import these cases.
"""

import numpy as np
import pytest
import torch

from zraytrace_tpu_torch.ops import flash_intersect as fi

T_MIN = 1e-3
BIG = 3.4e38
# the unit right triangle in z = 0, facing +z: a ray down -z from (x, y, 1)
# crosses it at t = 1 with u = x, v = y
TRI = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
# the positions of the two copies: in one chunk, or in chunks 0 and 1
CASES = {"one chunk": (3, 70), "two chunks": (10, 130)}


def tie_mesh(first: int, second: int, n_tris: int = 300, extra=()):
    """``n_tris`` fillers with ``TRI`` at ``first`` and ``second``, and each
    ``(position, triangle)`` of ``extra``: vertex arrays ``(T, 3)`` f32."""
    k = np.arange(n_tris, dtype=np.float32)[:, None]
    a = np.concatenate([50.0 + k, np.full_like(k, 50.0), np.full_like(k, -5.0)], axis=1)
    b, c = a + (0.1, 0.0, 0.0), a + (0.0, 0.1, 0.0)
    for pos, tri in ((first, TRI), (second, TRI), *extra):
        a[pos], b[pos], c[pos] = tri
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b, c))


def down_rays(xy):
    """Rays from ``(x, y, 1)`` straight down."""
    xy = torch.tensor(xy, dtype=torch.float32)
    o = torch.cat([xy, torch.ones((len(xy), 1))], dim=1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(len(xy), 3).contiguous()
    return o, d


def flash_case(case: str, packed: bool):
    """(planes, o, d, t_init, want (t, idx, hit)) of a flash tie case:
    three rays through the copies (the first unseeded, the second seeded
    with the tie t = 1, the third seeded above it) and one beside them."""
    first, second = CASES[case]
    a, b, c = tie_mesh(first, second)
    tri_mat = torch.zeros((a.shape[0],)) if packed else None
    planes = fi.pack_tri_planes(a, b, c, tri_mat=tri_mat, const_materials=packed)
    o, d = down_rays([(0.2, 0.3), (0.2, 0.3), (0.25, 0.25), (2.0, 2.0)])
    t_init = torch.tensor([BIG, 1.0, 2.0, BIG])
    want = (torch.tensor([1.0, 1.0, 1.0, BIG]),
            torch.tensor([first, 0, first, 0], dtype=torch.int32),
            torch.tensor([True, False, True, False]))
    return planes, o, d, t_init, want


def margin_case(case: str):
    """(planes, o, d, t_cap, want (near, occ, win)) of a margin tie case.
    A second, farther-missing triangle sits between the copies (a smaller
    margin, so it loses the near miss). Rays: a near miss (u = -0.1) with
    a hit behind at t = 5; an interior crossing with a hit in front at
    t = 0.5 (the copies occlude); an interior crossing with t_cap = 1 (the
    copies are the winner); the same two rays with t_cap = 3.4e38 (miss
    rays: no occluder, no winner; near misses still count)."""
    first, second = CASES[case]
    far_miss = ((0.3, 0.0, 0.0), (1.3, 0.0, 0.0), (0.3, 1.0, 0.0))  # u = -0.4 at x = -0.1
    a, b, c = tie_mesh(first, second, extra=[(first + 1, far_miss)])
    planes = fi.pack_tri_planes(a, b, c)
    o, d = down_rays([(-0.1, 0.2), (0.2, 0.3), (0.2, 0.3), (0.2, 0.3), (-0.1, 0.2)])
    t_cap = torch.tensor([5.0, 0.5, 1.0, BIG, BIG])
    # the interior rays near-miss the second triangle (u = -0.1 at x = 0.2)
    # where t < t_cap
    near = torch.tensor([first, -1, -1, first + 1, first], dtype=torch.int32)
    occ = torch.tensor([-1, first, -1, -1, -1], dtype=torch.int32)
    win = torch.tensor([-1, -1, first, -1, -1], dtype=torch.int32)
    return planes, o, d, t_cap, (near, occ, win)


@pytest.mark.parametrize("packed", [False, True], ids=["orig-ids", "packed-ids"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_plain_first_copy_wins(case, packed):
    planes, o, d, t_init, (t, idx, hit) = flash_case(case, packed)
    assert planes.n_chunks == 3
    got_t, got_idx, got_hit, uv = fi.flash_intersect_plain(planes, o, d, T_MIN, t_init)
    assert torch.equal(got_t, t) and torch.equal(got_idx, idx) and torch.equal(got_hit, hit)
    if packed:
        assert not bool(uv.any())
    else:  # u = x, v = y of the crossing, from the copy that won
        assert torch.equal(uv[0], torch.tensor([0.2, 0.3])) and not bool(uv[1].any())


@pytest.mark.parametrize("case", list(CASES))
def test_margin_plain_first_copy_wins(case):
    planes, o, d, t_cap, want = margin_case(case)
    got = fi.flash_margin_select_plain(planes, o, d, t_cap, T_MIN)
    for name, g, w in zip(("near", "occ", "win"), got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w), (name, g, w)


def test_margin_plain_miss_rays_select_no_occluder_or_winner():
    """Rays in every direction from inside and outside the copies' chunk
    boxes, all with t_cap 3.4e38: no occluder and no winner, whatever they
    cross."""
    planes, *_ = margin_case("two chunks")
    g = np.random.default_rng(5)
    o = torch.from_numpy(g.uniform(-1.0, 2.0, (64, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(64, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    o2, d2 = down_rays([(0.2, 0.3), (0.7, 0.1), (-0.05, 0.5)])
    o, d = torch.cat([o, o2]), torch.cat([d, d2])
    near, occ, win = fi.flash_margin_select_plain(planes, o, d, torch.full((len(o),), BIG), T_MIN)
    assert bool((occ == -1).all()) and bool((win == -1).all())
    assert int(near[-1]) == 10  # the copy at 10 wins the near miss at x = -0.05


def test_lanes_script_records_every_launch_of_a_pose_step(monkeypatch):
    """The pose step's recorded kernel calls (``kernel_inputs.pose_step_calls``,
    which ``probes/winner_lanes.py`` times and ``chip_smoke.py`` phase 10
    records the same way), at a cut size on the CPU: one flash and one
    margin call per bounce and sample group, each with its planes, rays and seed
    or cap, as the card would receive them."""
    from zraytrace_tpu_torch import kernel_inputs as ki

    monkeypatch.setattr(ki, "POSE", dict(width=8, height=8, spp=1, depth=2))
    calls = ki.pose_step_calls(torch.device("cpu"))
    assert [len(calls[k]) for k in ("flash_intersect", "flash_margins")] == [2, 2]
    for c in calls["flash_intersect"] + calls["flash_margins"]:
        assert c.planes.n_chunks == 50 and c.planes.attrs is None and c.t_min == T_MIN
        assert c.o.shape == c.d.shape == (64, 3) and c.x.shape == (64,)
        assert c.o.is_contiguous() and c.d.is_contiguous() and c.x.dtype == torch.float32
    # the recorded inputs give the recorded results again
    for kernel, recs in calls.items():
        for c in recs:
            plain = (fi.flash_intersect_plain(c.planes, c.o, c.d, c.t_min, c.x)
                     if kernel == "flash_intersect" else
                     fi.flash_margin_select_plain(c.planes, c.o, c.d, c.x, c.t_min))
            assert all(torch.equal(x, y) for x, y in zip(ki.launch(kernel, c), plain))
