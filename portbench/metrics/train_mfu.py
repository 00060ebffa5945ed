"""Model, train step: the model FLOPs of the steps inside the device
trace (``yardstick.flops.train_flops``: forward and backward of every
layer and of the head over every token, recomputation not counted) over
the traced sub-window times the bf16 peak, in %."""
from portbench.yardstick.flops import train_flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(rec):
    tr, n = rec.get("trace"), rec.get("trace_steps", 0)
    if tr is None or not n or tr.window_s <= 0:
        return None
    mix = rec["mix"]
    f = train_flops(rec["config"], mix["batch"], mix["seq_len"])
    return 100.0 * n * f / (tr.window_s * BF16_FLOPS)
