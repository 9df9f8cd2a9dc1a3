"""zamba2-2.7b: Mamba2 backbone + shared attention block every 6 layers — exact public config [arXiv:2411.15242; hf].

The same values as ``repro/configs/zamba2_27b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='zamba2-2.7b',
    family='hybrid',
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    activation='silu',
    gated_mlp=True,
    norm='rmsnorm',
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    full_attention=False,
)

SMOKE = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    attn_every=2,
)
