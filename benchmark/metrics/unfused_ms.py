"""Device ms a frame of every kernel outside the port's fused MLP kernels:
the gathers, sort, cumprod and the elementwise work around them."""

LAYER = "frame ops (ops/warp.py, ops/sampling.py, ops/composite.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["fern_trt.view_1008"]

FUSED = ("minmax_wg_kernel", "nerf_wg_kernel", "nerf_q_wg_kernel",
         "minmax_kernel", "nerf_kernel")


def read(outcome):
    tr = outcome.trace
    if tr is None or not tr.kernels:
        return None
    return tr.kernel_us(FUSED, exclude=True) * 1e-3 / tr.units
