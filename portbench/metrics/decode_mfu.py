"""The whole decode step's share of the card's bf16 peak: the model FLOPs
a token (frozen yardstick, from the configuration's shapes) times the
tokens of the window, over the window, over 989 TFLOP/s (in a traced
run, the part of the window after the trace)."""
from portbench.reference import yardstick


def read(run):
    if not run.get("tokens"):
        return None
    rate = run["flops_per_token"] * run["tokens"] / run["window_s"]
    return 100.0 * rate / yardstick.BF16_FLOPS_PER_S
