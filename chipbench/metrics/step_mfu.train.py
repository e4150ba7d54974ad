"""A train step's model FLOPs over its time, as a % of the bf16 peak."""

from chipbench import readers


def read(obs):
    return readers.mfu(obs, "train")
