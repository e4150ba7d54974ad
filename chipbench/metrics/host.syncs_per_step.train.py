"""Host syncs a train step makes (the sync debug mode's warnings)."""

from chipbench import readers


def read(obs):
    return readers.syncs(obs, "train")
