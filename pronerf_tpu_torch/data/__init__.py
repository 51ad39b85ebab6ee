"""LLFF and COLMAP loaders: counterpart of ``pronerf_tpu/data``."""

from pronerf_tpu_torch.data.llff import (
    load_llff_data,
    load_llff_data_infer,
    recenter_poses,
    poses_avg,
    render_path_spiral,
    spherify_poses,
)
from pronerf_tpu_torch.data.colmap import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
    greedy_reference_views,
)
