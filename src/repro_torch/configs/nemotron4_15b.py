"""nemotron-4-15b: dense LM, GQA 48q/8kv, squared-ReLU ungated MLP — exact public config [arXiv:2402.16819; unverified].

The same values as ``repro/configs/nemotron4_15b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='nemotron-4-15b',
    family='lm',
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    activation='relu2',
    gated_mlp=False,
    norm='layernorm',
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
)
