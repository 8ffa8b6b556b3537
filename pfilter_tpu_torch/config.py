"""Typed configuration tree for the PyTorch port of the PFilter engine.

The port's own copy of ``pfilter_tpu/config.py``: the same frozen dataclass
tree, presets and override layer, so a configuration means the same thing to
both packages.  Capacities are static shapes in the port too: every
dynamically-sized structure of the reference (growing point clouds, KD-trees,
hash maps) is a padded tensor with a validity mask whose capacity is set here,
which keeps the per-frame step free of host synchronisation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LidarConfig:
    """Sensor geometry (ref: include/lidar.h:9-31, src/lidar.cpp:5-36)."""

    num_lines: int = 64
    scan_period: float = 0.1
    max_distance: float = 90.0
    min_distance: float = 3.0
    vertical_angle: float = 2.0
    horizontal_resolution: float = 0.2  # degrees, used by the synthetic simulator


@dataclass(frozen=True)
class FeatureConfig:
    """Ring feature extraction (ref: src/laserProcessingClass.cpp:10-209).

    The reference splits each scan ring into 6 azimuth sectors, sorts by
    11-point curvature, picks the top <=20 points with curvature > 0.1 as
    edges (with +-5-neighbor non-max suppression that stops at >0.05 m^2
    gaps), and sends every unpicked curvature point to the surf cloud.
    """

    num_sectors: int = 6
    max_edge_per_sector: int = 20
    edge_curvature_threshold: float = 0.1
    suppression_gap_sq: float = 0.05
    suppression_radius: int = 5
    curvature_half_window: int = 5
    min_ring_points: int = 131
    # Candidates kept per (ring, sector) for the pick-and-suppress loop; the
    # worst case consumed is max_edge_per_sector * (2*suppression_radius + 1)
    # = 220, so 256 is exact for any input.  Validated in __post_init__ so a
    # YAML/CLI override of the pick params can't silently truncate edges.
    pick_candidates: int = 256
    # Keep every Nth surf candidate within each ring (1 = all, the
    # reference's behavior: every unpicked point goes to the surf cloud,
    # src/laserProcessingClass.cpp:198-205).  The surf cloud is voxelized at
    # 2x map_resolution before registration, which collapses in-ring
    # neighbors (~3 cm apart at HDL-64 density) into one centroid anyway —
    # stride-2 halves every downstream sort at sub-centimeter centroid cost.
    surf_decimate: int = 1

    def __post_init__(self):
        need = self.max_edge_per_sector * (2 * self.suppression_radius + 1)
        if self.pick_candidates < need:
            raise ValueError(
                f"pick_candidates={self.pick_candidates} < worst-case consumption "
                f"max_edge_per_sector*(2*suppression_radius+1)={need}; raise "
                f"pick_candidates to keep the edge pick loop exact"
            )


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-map registration + persistence filter parameters.

    Mirrors the reference's launch args (launch/pfilter_kitti.launch:49-72):
    ``k_new``/``theta_p``/``theta_max`` gate map-point persistence
    (ref: src/odomEstimationClass.cpp:7-25, :332-355), ``map_resolution`` sets
    the rgbds voxel size (edge maps use x1, surf maps x2,
    ref: src/odomEstimationClass.cpp:625-626), and the Ceres solve becomes a
    batched Gauss-Newton with Huber IRLS (ref: src/odomEstimationClass.cpp:252-272).
    """

    k_new: float = 0.0
    theta_p: float = 0.4
    theta_max: float = 75.0
    weight_type: int = 0  # 0 none | 1 observe | 2 sparsity | 12 mean of both
    map_resolution: float = 0.4
    crop_half_extent: float = 100.0  # ref: src/odomEstimationClass.cpp:606-623
    nn_gate_sq: float = 1.0  # 5th-NN sq-dist gate (ref: :300, :451)
    # Coarse-to-fine association: the FIRST outer iteration gates at this
    # wider radius, later iterations at nn_gate_sq.  The reference's fixed
    # 1 m gate has an absorbing failure state: once the predicted pose errs
    # by > 1 m (corner exit, cold start), every correspondence that could
    # correct the error is gated out and the estimator freezes — a wide
    # first pass re-captures them and the normal gate then refines.  Must
    # stay within the tiled kernel's halo coverage (~4 m for 4 m tiles).
    nn_gate_wide_sq: float = 6.25  # (2.5 m)^2
    line_eig_ratio: float = 3.0  # lambda_max > 3*lambda_mid (ref: :326)
    line_half_length: float = 0.1  # endpoints at +-0.1*dir (ref: :330-331)
    plane_fit_tol: float = 0.2  # plane residual gate (ref: :469-471)
    huber_delta: float = 0.1  # ref: :254
    max_outer_iters: int = 12  # first-frame opt count (ref: :221)
    min_outer_iters: int = 2  # steady-state opt count (ref: :198)
    inner_gn_iters: int = 4  # Ceres max_num_iterations (ref: :265)
    gn_damping: float = 1.0e-6  # small LM-style Tikhonov on the 6x6 system
    aging_increment: float = 2.0  # r += 2 per frame, cap 255 (ref: :634-646)
    # Per-frame pose jump marking a corrupt frame (fault tolerance).  Note:
    # the tiled kNN path sorts queries once per frame at the *predicted* pose
    # and its 3x3-tile halo absorbs ~3 m of refinement; a frame whose GN
    # correction approaches max_jump_m degrades neighbor completeness before
    # the guard fires.  FrameDiag.n_halo_escape counts such queries.
    max_jump_m: float = 10.0
    observe_saturate_ratio: float = 5.0  # observe/round > 5 -> observe = 255 (ref: :348)
    counter_cap: float = 255.0
    # Associate once per frame (kNN + neighbor gather + geometric fits +
    # persistence reads at the *predicted* pose), with outer iterations only
    # re-gating distances under the refined pose and re-running GN.  The
    # neighbor sets, line/plane fits and persistence counters depend on the
    # map alone, so re-deriving them every outer iteration (as the reference
    # does, re-querying the KD-tree per iteration) buys nothing once the
    # pose prediction is within the wide gate — and costs ~2x the kNN,
    # gather, fit and scatter work per frame.  g-counter increments are
    # scaled by the number of outer iterations to preserve the reference's
    # per-iteration counter dynamics.  False restores per-iteration
    # re-association (ref: src/odomEstimationClass.cpp:252-272).
    assoc_once: bool = True


@dataclass(frozen=True)
class CapacityConfig:
    """Static array capacities (fixed shapes in place of dynamic containers)."""

    scan_points: int = 131072  # max raw points per scan (HDL-64 ~ 120k)
    ring_points: int = 2560  # max points per scan ring after binning
    edge_points: int = 8192  # extracted edge features per scan
    surf_points: int = 131072  # extracted surf features per scan
    ds_edge_points: int = 8192  # downsampled edge scan fed to registration
    ds_surf_points: int = 32768  # downsampled surf scan fed to registration
    edge_map_points: int = 65536
    surf_map_points: int = 262144
    # Per-channel BPF map capacities (0 = inherit edge/surf caps).  The BPF
    # channels occupy far less than the ES maps (measured on the city bench:
    # beam ~2.5k, pillar ~0.6k, facade ~14k vs edge 17k/surf 21k peaks), and
    # every merge/sort/kNN cost scales with capacity — sizing them
    # separately is a direct BPF throughput lever (VERDICT r4 #3).
    bpf_line_map_points: int = 0  # beam + pillar
    bpf_plane_map_points: int = 0  # facade
    # Per-channel kNN tile caps (0 = inherit edge/surf tile caps): the
    # query kernel's matmul K-dim is 3*tile_cap, so sparse channels pay for
    # oversized caps directly; lane 3 (tile) overflow counters catch any
    # world that outgrows them.
    bpf_line_tile_cap: int = 0
    bpf_plane_tile_cap: int = 0
    # Facade-channel scan compact capacity (0 = inherit surf_points).  With
    # ground->facade routing the facade mask holds ~55k of a 131k scan; the
    # compact gather + downsample sort pay for the full inherited capacity
    # otherwise.
    bpf_plane_points: int = 0
    knn_cells: int = 256  # kNN grid cells per axis (1 m cells, covers +-128 m)
    knn_cell_size: float = 1.0
    # Exactness bound: a 1 m cell intersects <= (floor(1/leaf)+1)^3 voxels of
    # a leaf-downsampled map = 27 at the edge map's 0.4 m leaf (ops/knn.py).
    knn_candidates_per_cell: int = 32
    knn_k: int = 5
    # kNN implementation: "tiled" = tiled brute-force kernel
    # (ops/knn_tiled.py, CUDA on the card); "grid" = searchsorted voxel grid
    # (ops/knn.py, plain PyTorch on either device).
    knn_impl: str = "tiled"
    knn_tiles: int = 64  # NT x NT tile window
    tile_cells: int = 4  # tile edge in 1 m cells (4 m tiles)
    edge_tile_cap: int = 256  # max edge-map points per tile
    surf_tile_cap: int = 512  # max surf-map points per tile
    # Tile capacity for the BPF frontend's radius-PCA over the raw non-ground
    # scan (denser than any voxelized map near the sensor; the moments kernel
    # has no packed-key limit so this can exceed the kNN caps).
    frontend_tile_cap: int = 512


@dataclass(frozen=True)
class GroundConfig:
    """Grid-based ground segmentation (ref: include/preProcess.hpp:398-505)."""

    grid_size: float = 3.0
    neighbor_height_tol: float = 1.5  # cell min-z close to 3x3 neighbor min-z
    point_height_tol: float = 0.3  # point within 0.3 m of cell min-z
    num_cells: int = 64  # cells per axis (covers +-96 m at 3 m cells)
    # "grid" = the ground_seg the reference actually calls
    # (src/additionNode.cpp:24); "fast" = the fast_ground_filter variant
    # (ops/fast_ground.py, ref src/preProcess.cpp:56-346, parameterized by
    # FastGroundConfig) with distance-weighted downsampling and per-grid
    # normals — present but never called in the reference; exposed here as a
    # first-class option.
    method: str = "grid"


@dataclass(frozen=True)
class FastGroundConfig:
    """fast_ground_filter parameters (ref: src/preProcess.cpp:56-70 arg list;
    defaults follow the reference call sites / header defaults)."""

    grid_resolution: float = 2.0
    num_cells: int = 128  # fixed window: 128 x 2 m cells = +-128 m
    min_grid_pt_num: int = 8
    max_height_difference: float = 0.3
    neighbor_height_diff: float = 1.5
    max_ground_height: float = 6.0
    ground_down_rate: int = 10
    ground_down_down_rate: int = 2
    nonground_down_rate: int = 2
    reliable_neighbor_thre: int = 0
    normal_method: int = 0  # 0: (0,0,1) | 1/2/3: per-grid TLS plane normal
    distance_weight_method: int = 2  # 0 none | 1 linear | 2 quadratic
    standard_distance: float = 15.0
    fixed_num_downsampling: bool = False
    down_fixed_num: int = 1000


@dataclass(frozen=True)
class DCVCConfig:
    """Dynamic curved-voxel clustering (ref: src/additionClass.cpp, config/config.yaml:49-54)."""

    start_r: float = 0.35
    delta_r: float = 0.0004
    delta_p: float = 1.2
    delta_a: float = 1.2
    min_seg: int = 80
    max_iters: int = 48  # label-propagation fixed-point iterations


@dataclass(frozen=True)
class PCAClassifyConfig:
    """PCA beam/pillar/facade classifier (ref: include/preProcess.hpp:616-736)."""

    # Moment accumulation: "voxel" = sort + segment-reduce + 27-voxel gather
    # (exact cube neighborhood of edge 3*voxel_leaf, no capacity truncation,
    # ~16x faster on raw scans — see ops/pca_voxel.py); "radius" = Pallas
    # exact-ball kernel (ops/pca_radius.py, capped by frontend_tile_cap).
    impl: str = "voxel"
    voxel_leaf: float = 0.7
    # Voxel-table rows for the "voxel" impl (measured occupancy ~1k
    # non-ground voxels on the HDL-64 city scan; the segment-reduce and the
    # 27-gather cube loop scale with this row count — n_voxel_dropped fails
    # loudly if a denser world exceeds it).
    max_voxels: int = 8192
    neighbor_radius: float = 1.0
    neighbor_k: int = 25
    linear_vertical: float = 0.65  # linearity threshold (ref: :709-721)
    dir_z_pillar: float = 0.94
    dir_z_beam: float = 0.17
    beam_min_z: float = 0.5
    planar_threshold: float = 0.65
    norm_z_facade: float = 0.34
    # Keep every Nth ground point when routing ground into the facade
    # channel (1 = all).  Ground dominates the facade mask (~45k of ~55k
    # points); the scan order is ring-major so the stride is uniform
    # angular thinning, and the 0.8 m facade voxelization collapses in-ring
    # neighbors anyway.  A/B at 2 on the pinned bench: drift 0.3582 vs
    # 0.3609, ATE 1.92 vs 2.04 m, fps unchanged — within noise, so the
    # reference-faithful 1 stays the default.
    ground_facade_decimate: int = 1
    # Route ground-segmented points into the facade (plane-cost) channel.
    # Documented divergence from the reference, which drops ground entirely
    # in BPF mode (src/additionNode.cpp:24-27) and then has NO z-constraining
    # planes: pillars/facades are vertical and only beams (horizontal lines,
    # ~100/frame on the city circuit) touch z.  Measured on the synthetic
    # city circuit: z-ATE 4.52 m over 150 frames WITHOUT ground (x/y are
    # 0.22 m), a monotonic z ratchet — the reference's own ES path keeps
    # ground in its surf cloud (src/laserProcessingClass.cpp:198-205), so
    # this restores the constraint the BPF preprocessing threw away.  The
    # facade cost is per-correspondence plane fitting, so horizontal ground
    # planes coexist with vertical facades in one map.  Set False for the
    # reference-faithful channel split.
    ground_as_facade: bool = True


@dataclass(frozen=True)
class PoseGraphConfig:
    """Windowed pose-graph smoother (ops/pose_graph.py) — the back-end the
    reference lacks: the last ``window`` scan-matched poses, each anchored by
    its per-frame GN information matrix, regularized by constant-velocity
    smoothness factors.  Directions the scan measured well stay pinned;
    degenerate directions (corridor along-track, facade-only z) are filled
    in by the motion model.  Replicated arithmetic — shard-safe as is."""

    # Default ON (VERDICT r3 #6 A/B, tools/out/pose_graph_ab.json; r5
    # refresh after fixing the canyon world's inverted -y stub bounds,
    # ADVICE r4): on the degenerate canyon — the failure mode this back-end
    # exists for — the smoother cuts drift 0.930% -> 0.588% (along-track
    # RMSE 1.03 m -> 0.36 m); on the structured-canyon control it is within
    # noise of off (0.3829% vs 0.3822%, fps unchanged).  Robustness to
    # degenerate stretches wins the default; set pose_graph.enabled=false
    # to recover the last few hundredths on rich worlds.
    enabled: bool = True
    window: int = 8
    iters: int = 3
    # Weights A/B'd on the city circuit: stronger smoothness (w_xy=25,
    # anchor_scale=0.0025) LAGS well-constrained scan-matching (drift 0.525%
    # vs 0.425% baseline); these gentler values are drift-neutral on ES
    # (0.437%) while still carrying weakly-measured directions (BPF z).
    w_rot: float = 100.0  # info weight on inter-frame rotation change
    w_xy: float = 5.0  # info weight on horizontal acceleration
    w_z: float = 25.0  # info weight on vertical acceleration
    damping: float = 1.0e-3
    # The per-frame GN information H assumes unit residual noise; actual
    # point-to-feature residual noise is ~0.05 m, so H overstates information
    # by ~1/sigma^2.  anchor_scale ~ sigma^2 restores the balance against the
    # w_* smoothness weights above.
    anchor_scale: float = 0.01


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline selection + all stage configs.

    ``mode`` selects the ES pipeline (the PFilter paper path: ring features ->
    edge/surf odometry) or the BPF pipeline (ground seg -> DCVC -> PCA ->
    beam/pillar/facade odometry), mirroring ``featurePreExtract`` in
    launch/pfilter_kitti.launch:5-10.
    """

    mode: str = "es"  # "es" | "bpf"
    # ES-mode pre-filters: run ground segmentation and/or DCVC small-cluster
    # removal on the raw scan BEFORE ring feature extraction — the reference's
    # curvedVoxel_node front-end feeding the ES processing node
    # (curvedfilter=1 / groundfilter=1 with featurePreExtract=0:
    # src/additionNode.cpp:12-54 republishes the surviving cloud on
    # pfilter_input_cloud, consumed by src/laserProcessingNode.cpp:120-126).
    # Off by default (the paper's ES path consumes the raw scan).
    es_ground_filter: bool = False
    es_curved_filter: bool = False
    lidar: LidarConfig = LidarConfig()
    features: FeatureConfig = FeatureConfig()
    odometry: OdometryConfig = OdometryConfig()
    capacity: CapacityConfig = CapacityConfig()
    ground: GroundConfig = GroundConfig()
    fast_ground: FastGroundConfig = FastGroundConfig()
    dcvc: DCVCConfig = DCVCConfig()
    pca: PCAClassifyConfig = PCAClassifyConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


def kitti_config() -> PipelineConfig:
    """KITTI HDL-64 parameters (launch/pfilter_kitti.launch:49-64).

    Capacities are sized to measured KITTI-scale loads (the crop box bounds
    the map to +-100 m and the 0.4/0.8 m rgbds voxels bound its density; the
    persistence filter keeps it far below even that).  Smaller capacities cut
    every sort/merge/kNN cost linearly, so they are tuned tight-but-safe
    rather than generous."""
    return PipelineConfig(
        lidar=LidarConfig(num_lines=64, max_distance=90.0, min_distance=3.0),
        # surf_decimate=2 trades drift for throughput (measured on the
        # reference package's hardware) — accuracy wins by default.
        features=FeatureConfig(surf_decimate=1),
        # weight_type=0: ABLATION_r04.json measures weighting-off at 0.304%
        # drift vs 0.425% for the reference's launch default weighttype=2
        # (launch/pfilter_kitti.launch:8) on the pinned 300-frame protocol (r2 had measured w2 slightly ahead; the
        # assoc-once static weights changed that).  Override
        # odometry.weight_type=2 for launch-parity runs; weightType 1 is
        # pathological by the reference's own normalizer semantics — see
        # ops/gauss_newton.fold_normalize.
        odometry=OdometryConfig(
            k_new=0.0, theta_p=0.4, theta_max=75.0, map_resolution=0.4, weight_type=0
        ),
        # Capacities sized 3-6x the MEASURED steady-state occupancy on the
        # KITTI-like city world (HDL-64, 1800 azimuth: ~100k valid returns,
        # ~750 edge features, ~600 ds-edge voxels, ~5.7k ds-surf voxels,
        # edge map ~3.1k, surf map ~9.9k).  Every sort/merge/kNN/scatter
        # cost scales with capacity, not occupancy, and all eight overflow
        # lanes fail loudly if a denser world ever fills one — raise the cap
        # that overflows, not all of them.
        # ds_surf 8192 and surf_map 32768: steady-state occupancy on the
        # pinned 300-frame protocol is ~5.7k ds-surf voxels and ~15.2k surf
        # map points, so the caps keep 1.4x/2.1x headroom.
        # r5: the v2 bench protocol drives the FULL 1.06 km loop (850
        # frames); the far side of the city grid is edge-denser than the
        # first 300-frame stretch the r4 caps were sized on and edge_map
        # 16384 overflowed there (edge_merge_voxel lane: 2164 dropped
        # voxels; measured 850-frame edge peak 17144) — 24576 restores 1.4x
        # headroom.  Surf steady-state peak is 21.5k (32768 keeps 1.5x);
        # the frame-0 "peak == capacity" in bench logs is the raw-scan seed
        # filling the array (initMapWithPoints semantics, truncation
        # harmless and immediately re-voxelized away).
        capacity=CapacityConfig(
            ds_edge_points=2048,
            ds_surf_points=8192,
            edge_map_points=24576,
            surf_map_points=32768,
            # BPF channel occupancies are small (beam peak ~2.5k, pillar
            # ~0.6k, facade ~14k on the 300-frame city stretch) — per-channel
            # caps cut every capacity-proportional BPF cost; overflow lanes
            # fail loudly if a denser world fills one.
            bpf_line_map_points=8192,
            bpf_plane_map_points=24576,
            bpf_line_tile_cap=128,
            bpf_plane_points=98304,
            # Tile caps sized to measured worst-case 3-tile halo-row
            # occupancy on the KITTI-like city world (edge rows peak ~490 of
            # w=3*256, surf ~310 of w=3*256) — FrameDiag lane 6 counts any
            # regression to nonzero truncation.
            edge_tile_cap=256,
            surf_tile_cap=256,
            frontend_tile_cap=384,
        ),
    )


def campus_32beam_config() -> PipelineConfig:
    """32-beam low-speed UGV parameters (README.md:43)."""
    return PipelineConfig(
        lidar=LidarConfig(num_lines=32, max_distance=60.0, min_distance=2.0),
        odometry=OdometryConfig(k_new=0.0, theta_p=1.0, theta_max=200.0, map_resolution=0.4),
    )


def floam_equivalent_config() -> PipelineConfig:
    """Persistence filtering disabled — FLOAM-equivalent mode, params (0,0,0)
    (README.md:44).  With theta_p=0 the eviction predicate never fires."""
    return PipelineConfig(
        odometry=OdometryConfig(k_new=0.0, theta_p=0.0, theta_max=0.0, map_resolution=0.4),
    )


# ---------------------------------------------------------------------------
# YAML / CLI override layer — the typed replacement for the reference's three
# config mechanisms (ROS params re-parsed from strings, per-frame yaml-cpp
# reload, hard-coded header thresholds; SURVEY.md §5 "Config / flag system",
# ref: src/odomEstimationNode.cpp:350-370, src/additionClass.cpp:17-35).
# ---------------------------------------------------------------------------

_PRESETS = {
    "default": PipelineConfig,
    "kitti": kitti_config,
    "campus32": campus_32beam_config,
    "floam": floam_equivalent_config,
}


def _coerce(value, ref):
    """Coerce a YAML/CLI value to the type of the dataclass default."""
    if isinstance(ref, bool):
        return value in (True, "true", "True", "1", 1)
    if isinstance(ref, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    return value


def apply_overrides(cfg: PipelineConfig, overrides: dict) -> PipelineConfig:
    """Nested-dict overrides: {"odometry": {"theta_p": 0.5}, "mode": "bpf"}."""
    kwargs = {}
    for key, val in overrides.items():
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            sub = {}
            for k, v in val.items():
                if not hasattr(cur, k):
                    raise KeyError(f"unknown config field {key}.{k}")
                sub[k] = _coerce(v, getattr(cur, k))
            kwargs[key] = dataclasses.replace(cur, **sub)
        else:
            if not hasattr(cfg, key):
                raise KeyError(f"unknown config field {key}")
            kwargs[key] = _coerce(val, cur)
    return dataclasses.replace(cfg, **kwargs)


def apply_dotted_overrides(cfg: PipelineConfig, pairs) -> PipelineConfig:
    """CLI-style "odometry.theta_p=0.5" strings."""
    nested: dict = {}
    for pair in pairs:
        path, _, raw = pair.partition("=")
        keys = path.strip().split(".")
        d = nested
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = raw.strip()
    return apply_overrides(cfg, nested)


def load_config(
    preset: str = "default",
    yaml_path=None,
    cli_overrides=(),
) -> PipelineConfig:
    """preset -> YAML file -> CLI dotted overrides, later wins."""
    try:
        cfg = _PRESETS[preset]()
    except KeyError:
        raise KeyError(f"unknown preset {preset!r}; have {sorted(_PRESETS)}")
    if yaml_path is not None:
        import yaml  # pyyaml ships with the baked-in stack

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = apply_overrides(cfg, data)
    if cli_overrides:
        cfg = apply_dotted_overrides(cfg, cli_overrides)
    return cfg
