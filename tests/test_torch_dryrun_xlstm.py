"""xlstm-125m's dry run (``launch/dryrun.py``) against the reference's counts, on the CPU.

The pattern of ``test_torch_dryrun.py::test_model_group_shares_uneven_heads_and_ssm_heads``,
in a file of its own so that the test workers run its two long traces (a
32768-token prefill through 512 mLSTM chunks a layer, and a train step,
over fake tensors) beside that file's.  At full depth the model group
of 16 shares what it computed whole before (train_4k on 2 x 16 x 16: 9.29
TFLOP and a peak of 25.24 GB a device; prefill_32k on 16 x 16: 5.88
TFLOP; decode_32k: 1.31 GFLOP, 39.16 MB of arguments): the mLSTM by value
columns (48 of one head's 192 a process; q and k of the head whole, which
the head's 4 processes each compute, so 1.24 x the reference's FLOPs in
training and 1.50 x in the prefill), the sLSTM by channels, their serving
states by the same columns.  Each count a device within
:data:`SHARED_LIMITS` of the reference's.
"""

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

pytestmark = pytest.mark.torch_port

#: the reference's counts a device (``PYTHONPATH=src JAX_PLATFORMS=cpu
#: python -m repro.launch.dryrun --arch xlstm-125m --shape S [--multi-pod]``:
#: its ``cost_analysis`` FLOPs, ``memory_analysis`` argument and peak bytes)
REFERENCE_SHARED = {
    ("xlstm-125m", "train_4k", True): dict(flops=1.0473e12, peak=5.81e9),
    ("xlstm-125m", "prefill_32k", False): dict(flops=0.3676e12, peak=0.52e9),
    ("xlstm-125m", "decode_32k", False): dict(flops=98.84e6, argument=18.91e6),
}
#: how far the port's count may lie above the reference's, by figure
SHARED_LIMITS = {
    ("xlstm-125m", "train_4k", True): dict(flops=1.5, peak=1.00),
    ("xlstm-125m", "prefill_32k", False): dict(flops=1.55),
    ("xlstm-125m", "decode_32k", False): dict(flops=1.10, argument=1.0),
}


@pytest.mark.parametrize("arch,shape,mp", list(SHARED_LIMITS), ids=[
    f"{a}-{s}-{'2x16x16' if mp else '16x16'}" for a, s, mp in SHARED_LIMITS])
def test_model_group_shares_xlstm_by_value_columns_and_channels(arch, shape, mp):
    rec = dryrun.run_one(arch, shape, multi_pod=mp)
    assert rec["status"] == "ok", rec.get("error")
    got = dict(flops=rec["roofline"]["flops_per_device"], **rec["bytes_per_device"])
    ref = REFERENCE_SHARED[(arch, shape, mp)]
    for key, limit in SHARED_LIMITS[(arch, shape, mp)].items():
        assert got[key] <= limit * ref[key], (key, got[key], ref[key])
    assert not dist.is_initialized()
