"""Traffic ``viewer_donerf``: the ``viewer`` traffic (one viewer flying
through the scene, closed loop, ``viewer.py`` says how) on a configuration
whose radiance net is DoNeRF (``netarch = donerf``).

Only the weights and the reference differ from ``viewer``: the DoNeRF net's
weights are drawn with NumPy from the configuration's ``donerf_seed``
(``reference/donerf.py:draw_weights``), in the form its ``widths``
(``netdepth``, ``netwidth``) and ``donerf`` (``skip_layer``, ``outputs``)
give; the sampler and refine nets come from its checkpoint, and the
program and the reference get the same arrays; the reference is
``reference/donerf.py``'s frame, with the view features entering at the
same layer. The parameters are ``viewer``'s.
"""

from __future__ import annotations

import torch

import harness
from reference import donerf as rdonerf
from reference import pronerf as ref
from traffic import viewer


def draw_donerf(config):
    """The configuration's DoNeRF net, drawn from its ``donerf_seed``."""
    return rdonerf.draw_weights(
        config["donerf_seed"], config["widths"]["netdepth"],
        config["widths"]["netwidth"], config["donerf"]["skip_layer"],
        config["donerf"]["outputs"])


class DoNeRFViewer(viewer.Viewer):
    """``viewer.Viewer`` with the DoNeRF net."""

    def nets(self):
        if getattr(self, "donerf", None) is None:
            self.donerf = draw_donerf(self.config)
        return {"nerf": self.donerf, **super().nets()}

    def reference(self, c2w, quant=None):
        """The float32 DoNeRF reference's frame at ``c2w``, through the
        source-row windows the served form resolves at this size."""
        if getattr(self, "P", None) is None:
            nets = self.nets()
            self.P = rdonerf.weights_from_tree(
                nets["nerf"], nets["sampler"], nets["refine"],
                device=self.dev)
            self.rsc = {
                "images": torch.as_tensor(self.sc["images"], device=self.dev),
                "poses": torch.as_tensor(self.sc["poses"][self.views],
                                         device=self.dev),
                "K": self.sc["K"]}
        windows = ref.window_rule(self.H, self.W) \
            if self.config["statics"]["gather_tiles"] == -1 else None
        return rdonerf.render_frame(
            self.P, self.rsc, torch.as_tensor(c2w, device=self.dev), self.H,
            self.W, self.sc["K"], self.config["statics"]["num_neighbor"],
            self.p["reference_block"], quant, windows,
            self.config["donerf"]["skip_layer"])


def run(ctx) -> harness.Outcome:
    """``viewer.run`` with ``DoNeRFViewer``."""
    v = DoNeRFViewer(ctx["cell"], ctx["config"], ctx["device"])
    lat, window_s, t_w0, kept = v.window(ctx["seed"], ctx["seconds"])
    e2e = {"setup_s": t_w0 - ctx["t_start"],
           "frame_ms": window_s * 1e3 / len(lat),
           "frame_p95_ms": harness.nearest_rank(lat, 0.95) * 1e3}
    card = harness.gpu_state() if ctx["device"] != "cpu" else ""
    trace = v.traced(v.p["trace_frames"]) if ctx["trace"] else None
    peak = torch.cuda.max_memory_allocated(v.dev) if v.on_card else 0
    v.free()
    frames = [s for s, c in zip(v.slots, kept) if c is not None]
    refs = [v.reference(c) for c in kept if c is not None]
    limits = ctx["cell"]["limits"]
    checks = {k: (e, limits[k])
              for k, e in viewer.rms_errors(frames, refs).items()}
    return harness.Outcome(e2e, checks, len(lat), 0, peak,
                           viewer.Record(ctx["cell"], ctx["config"], v.spans),
                           trace, card)
