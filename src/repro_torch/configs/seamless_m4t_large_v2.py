"""seamless-m4t-large-v2: enc-dec multimodal backbone (frame-embedding frontend stub) — exact public config [arXiv:2308.11596; hf].

The same values as ``repro/configs/seamless_m4t_large_v2.py``. SMOKE is the
reduced same-family config the CPU tests use.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name='seamless-m4t-large-v2',
    family='encdec',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    activation='silu',
    gated_mlp=False,
    norm='layernorm',
    n_encoder_layers=24,
    frontend='frames',
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    n_encoder_layers=2,
    encoder_seq=32,
)
