"""Train step: on_step's seconds (the step between two synchronisations),
mean over the window, in ms."""


def read(layer):
    xs = layer.get("step_s", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
