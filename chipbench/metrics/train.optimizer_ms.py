"""AdamW's ms a step (the step's phase timer, its own synchronises)."""

from chipbench import readers


def read(obs):
    return readers.phase_ms(obs, "optimizer")
