"""Data: a step's interval (one on_step call to the next) less the
trainer's own step seconds, mean over the window, in ms: the loop's fetch,
batch_to_device and whatever else the host does between steps."""


def read(layer):
    xs = [iv - s for iv, s in zip(layer.get("intervals", []), layer.get("step_s", []))]
    return 1e3 * sum(xs) / len(xs) if xs else None
