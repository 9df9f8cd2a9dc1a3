"""chameleon-34b: early-fusion VLM (VQ image tokens are ordinary vocab ids) — exact public config [arXiv:2405.09818; unverified].

The same values as ``repro/configs/chameleon_34b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='chameleon-34b',
    family='lm',
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    activation='silu',
    gated_mlp=True,
    norm='layernorm',
    frontend='tokens',
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
)
