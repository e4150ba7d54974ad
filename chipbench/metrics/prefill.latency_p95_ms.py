"""The 95th percentile of every batch's latency in the traced window, from
its submission to its logits on the host, in ms."""

from chipbench import readers


def read(obs):
    return readers.latency_p95(obs, "prefill")
