"""Plain functions on tensors: rays, encodings, epipolar warp, sampling,
volume compositing, and image metrics."""

from pronerf_tpu_torch.ops.rays import (  # noqa: F401
    get_rays,
    get_rays_np,
    ndc_rays,
    ray_points,
    linspace_depths,
)
from pronerf_tpu_torch.ops.encoding import (  # noqa: F401
    positional_encoding,
    posenc_dim,
    plucker,
)
from pronerf_tpu_torch.ops.warp import (  # noqa: F401
    fuse_projection,
    bilinear_sample,
    project_points,
    epipolar_colors,
    epipolar_colors_shared,
    mean_fill_invalid,
)
from pronerf_tpu_torch.ops.sampling import (  # noqa: F401
    explore_expand,
    gap_jitter,
    sort_with_payloads,
    ndc_to_3d_depth,
    bin_constrain,
)
from pronerf_tpu_torch.ops.composite import composite  # noqa: F401
from pronerf_tpu_torch.ops.metrics import (  # noqa: F401
    img2mse,
    mse2psnr,
    to8b,
    img2ssim,
)
