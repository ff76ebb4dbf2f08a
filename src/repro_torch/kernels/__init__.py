"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``hop_megakernel.py``, ``conv_kernels.py`` and ``twm_matmul.py``
(the kernel bindings and their plain versions), ``moe_dispatch.py`` (the
MoE layer's dropping dispatch, which ports no reference kernel and which
``models/moe.py`` calls), ``ops.py`` (the public
entry points), ``ref.py`` (plain oracles), ``dispatch.py`` (launch
counters), ``build.py`` (nvcc + ctypes) and ``csrc/`` (the CUDA sources).

The kernel library's public names are those of the reference's
``repro.kernels``."""
from repro_torch.kernels.ops import (
    bitserial_conv1d,
    bnn_conv1d,
    bnn_conv1d_batched,
    pick_path,
    twm_linear,
    twm_linear_mxu,
)

__all__ = [
    "twm_linear",
    "twm_linear_mxu",
    "bnn_conv1d",
    "bnn_conv1d_batched",
    "bitserial_conv1d",
    "pick_path",
]
