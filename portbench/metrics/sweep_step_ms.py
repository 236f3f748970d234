"""Device milliseconds per training step of the word sweep: CUDA events
around each chunk call, summed over the window, over the steps."""


def read(layer: dict):
    return layer.get("step_ms")
