"""Device ms a train step of token_gather, token_scatter_add and its index launch."""

from chipbench import readers


def read(obs):
    return readers.dispatch_ms(obs, "train")
