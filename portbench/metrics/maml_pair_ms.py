"""Device milliseconds of the window's "meta" spans over the MAML pairs
the device ran in them (OnlineResult.steps["maml"])."""


def read(layer: dict):
    ms, pairs = layer.get("span_ms", {}).get("meta"), layer.get("pairs")
    return sum(ms) / pairs if ms and pairs else None
