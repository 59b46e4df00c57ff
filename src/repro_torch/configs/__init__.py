"""configs layer of the PyTorch/CUDA port (twin of ``repro.configs``).
Importing this package registers every architecture config."""

from repro_torch.configs import (  # noqa: F401
    bst,
    deepseek_moe_16b,
    dlrm_mlperf,
    dlrm_rm2,
    gin_tu,
    granite_moe_3b_a800m,
    minitron_4b,
    pixie,
    qwen2_5_3b,
    sasrec,
    smollm_360m,
)
from repro_torch.configs.registry import (  # noqa: F401
    ArchSpec,
    ShapeCell,
    all_archs,
    get_arch,
)
