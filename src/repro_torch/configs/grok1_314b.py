"""grok-1-314b: MoE LM, 8 experts top-2, GQA 48q/8kv — exact public config [hf:xai-org/grok-1; unverified].

The same values as ``repro/configs/grok1_314b.py``. SMOKE is the reduced
same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='grok-1-314b',
    family='lm',
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    activation='gelu',
    gated_mlp=True,
    norm='rmsnorm',
    n_experts=8,
    top_k=2,
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
)
