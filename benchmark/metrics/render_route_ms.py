"""``render_route_ms``: ``render.route`` per image (``mesh_routing``, with
``flash_pack_cached``'s hash of the mesh and its lookup), the mean over
the window's kept ``render.render`` records (``_spans``), in ms."""

from benchmark.metrics._spans import seconds, window_mean


def read(run):
    s = window_mean(run, "render.render", lambda r: seconds(r, "render.route"))
    return None if s is None else 1e3 * s
