"""The grouped FFN kernel's least time over its time, in prefills."""

from chipbench import readers


def read(obs):
    return readers.roofline(obs, "grouped_ffn", "prefill")
