"""The prefill batches' model FLOPs over the window's time, as a % of the bf16 peak."""

from chipbench import readers


def read(obs):
    return readers.mfu(obs, "prefill")
