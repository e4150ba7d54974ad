"""% of the traced prefill window in which no device op ran."""

from chipbench import readers


def read(obs):
    return readers.idle_share(obs, "prefill")
