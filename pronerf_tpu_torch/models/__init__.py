from pronerf_tpu_torch.models.mlp import (  # noqa: F401
    MinMaxMLP,
    NeRFMLP,
    init_linear,
    minmax_mlp_apply_folded,
)
from pronerf_tpu_torch.models.pronerf import (  # noqa: F401
    RenderStatics,
    init_pronerf_params,
    render_rays,
)
