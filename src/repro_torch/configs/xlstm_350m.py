"""xLSTM-350M [ssm] — 24L d1024 4H vocab=50304, sLSTM + mLSTM blocks
(superblock: 7x mLSTM + 1x sLSTM, repeated 3x), no FFN (d_ff=0).
Recurrent O(1) state -> runs long_500k.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, superblock=("M", "M", "M", "M", "M", "M", "M", "s"),
    ssm_expand=2, long_context_ok=True, source="arXiv:2405.04517",
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=512,
    superblock=("M", "s"), ssm_expand=2, long_context_ok=True,
)
