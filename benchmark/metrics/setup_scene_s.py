"""``setup_scene_s``: the set-up's ``scene.build`` (the scene builder, with
its PNG and OBJ reads and any host build they start), summed over the
``scene.build`` records opened before set-up ended (one), in s."""

from benchmark.metrics._spans import setup_total


def read(run):
    return setup_total(run, "scene.build", lambda r: r.seconds)
