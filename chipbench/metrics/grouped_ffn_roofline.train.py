"""The grouped FFN kernel's least time over its time, in train steps."""

from chipbench import readers


def read(obs):
    return readers.roofline(obs, "grouped_ffn", "train")
