"""The flash attention kernel's least time over its time, in prefills."""

from chipbench import readers


def read(obs):
    return readers.roofline(obs, "flash_attention", "prefill")
