"""Training: functional optimizers (``optimizer``), learning-rate
schedules (``schedule``), gradient compression with error feedback
(``compression``), checkpoints (``checkpoint``) and the step and trainer
(``loop``), over parameter trees of tensors."""
from repro_torch.train import (
    checkpoint,
    compression,
    loop,
    optimizer,
    schedule,
)

__all__ = ["checkpoint", "compression", "loop", "optimizer", "schedule"]
