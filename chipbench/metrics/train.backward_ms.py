"""The backward's ms a step: autograd's gradients and their sums (the step's phase timer)."""

from chipbench import readers


def read(obs):
    return readers.phase_ms(obs, "backward")
