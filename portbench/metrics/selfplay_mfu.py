"""selfplay_mfu: the model's operations over the window's seconds over the
H100's dense bf16 peak (989 TFLOP/s). Positions are counted by the
harness's wrapper of the eval function; operations a position from the
configuration's shapes (`work.model_flops`: stem, trunk, and the heads
search reads), the same whatever route computes them."""
from portbench.harness.work import PEAK_BF16_FLOPS, model_flops


def read(rec):
    w = rec.window
    if not w or w["seconds"] <= 0 or not w["positions"]:
        return None
    return 100.0 * w["positions"] * model_flops(rec.config) / w["seconds"] / PEAK_BF16_FLOPS
