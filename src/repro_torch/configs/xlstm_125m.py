"""xLSTM-125M [arXiv:2405.04517]: alternating sLSTM and mLSTM blocks.

Copy of ``repro/configs/xlstm_125m.py``.  Attention-free recurrence, so
NIMBLE's expert-parallel dispatch has nothing to balance: the model is
built without it.  The mLSTM layers run chunkwise-parallel (chunk 64,
the ``mlstm_scan`` kernel) and the sLSTM layers through log-depth
prefix scans.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                    # blocks carry their own projection factors
    vocab=50304,
    ssm_state=64,
    ssm_heads=4,
    slstm_every=2,             # odd layers sLSTM, even layers mLSTM
    mlstm_chunk=64,            # 0 = the per-step mLSTM scan
    slstm_assoc=True,          # False = the per-step sLSTM scan
))
