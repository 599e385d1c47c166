"""``render_host_ms``: the host's share of an image in ``render.render``
(lanes, routing, the image's fetch and decode), the mean over the
window's images of ``RenderStats.preprocess_seconds + transfer_seconds``,
in ms."""


def read(run):
    images = run.get("images")
    if not images:
        return None
    return 1e3 * sum(im["preprocess_s"] + im["transfer_s"] for im in images) / len(images)
