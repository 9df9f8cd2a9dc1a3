"""mixtral-8x22b: MoE LM, 8 experts top-2, GQA 48q/8kv, SWA-4096 — exact public config [arXiv:2401.04088; hf].

The same values as ``repro/configs/mixtral_8x22b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='mixtral-8x22b',
    family='lm',
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    activation='silu',
    gated_mlp=True,
    norm='rmsnorm',
    n_experts=8,
    top_k=2,
    window=4096,
    full_attention=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    n_experts=4,
    window=16,
)
