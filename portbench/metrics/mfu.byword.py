"""The whole step's share of the card's float32 peak, in percent: the model
operations of the window's work (portbench/counts.py) over the device time
it took, against 67 TFLOP/s."""
from portbench import counts


def read(layer: dict):
    ops, ms = layer.get("model_ops"), layer.get("runs_ms")
    return 100.0 * ops / (ms / 1e3) / counts.F32_FLOP_PER_S if ops and ms else None
