"""phi3-mini-3.8b: dense LM, RoPE + SwiGLU, MHA 32q/32kv — exact public config [arXiv:2404.14219; unverified].

The same values as ``repro/configs/phi3_mini_38b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='phi3-mini-3.8b',
    family='lm',
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    activation='silu',
    gated_mlp=True,
    norm='rmsnorm',
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab=512,
)
