"""Device ms a prefill batch of token_gather, token_scatter_add and its index launch."""

from chipbench import readers


def read(obs):
    return readers.dispatch_ms(obs, "prefill")
