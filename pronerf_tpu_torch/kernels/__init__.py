from pronerf_tpu_torch.kernels.fused_minmax import (  # noqa: F401
    fused_minmax_plain,
    fused_minmax_t,
    pack_minmax_params,
)
from pronerf_tpu_torch.kernels.fused_nerf import (  # noqa: F401
    fused_nerf_composite_plain,
    fused_nerf_composite_t,
    fused_nerf_raw_plain,
    fused_nerf_raw_t,
    pack_nerf_params,
)
