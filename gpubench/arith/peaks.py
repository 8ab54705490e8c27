"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet, SXM part,
dense rates without sparsity, at the full power limit of 700 W."""
from __future__ import annotations

# Dense bf16 tensor-core FLOP/s.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
# HBM bytes/s.
PEAK_HBM_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}
