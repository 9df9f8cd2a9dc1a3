"""qwen1.5-32b: dense LM with QKV bias, GQA 40q/40kv — exact public config [hf:Qwen/Qwen1.5-0.5B; hf].

The same values as ``repro/configs/qwen15_32b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen1.5-32b',
    family='lm',
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    activation='silu',
    gated_mlp=True,
    norm='rmsnorm',
    qkv_bias=True,
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
