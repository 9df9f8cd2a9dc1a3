"""xlstm-125m: sLSTM + mLSTM blocks (recurrent; d_ff=0 — no FFN) — exact public config [arXiv:2405.04517; unverified].

The same values as ``repro/configs/xlstm_125m.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='xlstm-125m',
    family='xlstm',
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    activation='silu',
    gated_mlp=False,
    norm='layernorm',
    slstm_every=4,
    full_attention=False,
)

SMOKE = CONFIG.replace(
    n_layers=3,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    vocab=512,
    slstm_every=2,
)
