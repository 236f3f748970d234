"""Device milliseconds of the window's "adapt" spans (self-supervision
under the gate: K6) over the blocks the gate let in."""


def read(layer: dict):
    ms, gated = layer.get("span_ms", {}).get("adapt"), layer.get("n_gated")
    return sum(ms) / gated if ms and gated else None
