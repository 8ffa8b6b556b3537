"""Synthetic LiDAR world simulator: ray-cast multi-beam scans with ground truth.

The port's own renderer (``pfilter_tpu/utils/synthetic.py`` is JAX, and the
machine with the card has no JAX): the same worlds and trajectories, built
with numpy from a seed, and the same ray caster in PyTorch on the given
device.  An urban world of ground plane + building facades + poles + movers +
clutter is ray-cast with an HDL-64-style beam pattern along a trajectory,
producing sensor-frame scans plus ground-truth poses for drift evaluation.

Beam elevations invert exactly through the reference's ring formulas
(src/laserProcessingClass.cpp:46-57), so feature extraction bins them onto
the intended rings.  Range noise comes from a ``torch.Generator``; it cannot
equal ``jax.random``, so parity runs render with ``noise=0`` and add
``shared_range_noise``, the one noise both packages' scans can share: numpy,
outside either renderer (``render_shared_sequence`` does both).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pfilter_tpu_torch import resolve_device
from pfilter_tpu_torch.config import LidarConfig
from pfilter_tpu_torch.ops import se3


class World(NamedTuple):
    """Axis-aligned world primitives, as host numpy arrays (the renderer
    copies them to its device once per scan)."""

    walls_x: np.ndarray  # [Wx, 5]: x, y0, y1, z0, z1  (plane x = const)
    walls_y: np.ndarray  # [Wy, 5]: y, x0, x1, z0, z1  (plane y = const)
    poles: np.ndarray  # [P, 4]: cx, cy, radius, height
    ground_z: float
    # Dynamic rigid movers (cars/pedestrians — the outlier clutter KITTI has
    # and the round-1 corridor lacked): [D, 8] = cx0, cy0, vx, vy, half_w,
    # half_l, height, phase.  At time t the box center is c0 + v * t; points
    # on movers violate the static-world assumption and must be rejected /
    # evicted by the persistence filter.
    movers: np.ndarray = np.zeros((0, 8), np.float32)
    # Static clutter spheres (foliage blobs / bushes): [C, 4] = cx, cy, cz, r.
    clutter: np.ndarray = np.zeros((0, 4), np.float32)


def beam_elevations(num_lines: int) -> np.ndarray:
    """Per-ring elevation angles (degrees) that map back onto ring k through
    the reference's vertical-angle formulas."""
    if num_lines == 64:
        upper = 2.0 - np.arange(32) / 3.0
        lower = -8.87 - (np.arange(32)) / 2.0  # lands on rings 32..63
        return np.concatenate([upper, lower])
    if num_lines == 32:
        # scanID = int((angle + 92/3) * 3/4)  ->  angle = (k + 0.5) * 4/3 - 92/3
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0
    if num_lines == 16:
        # scanID = int((angle + 15)/2 + 0.5)  ->  angle = 2k - 15
        return 2.0 * np.arange(16) - 15.0
    raise ValueError(num_lines)


def make_world(
    seed: int = 0,
    corridor_len: float = 400.0,
    n_movers: int = 0,
    clutter_per_100m: float = 0.0,
) -> World:
    """An urban corridor: two building rows with setbacks (facades + corners
    give edge features), poles, and a ground plane.  ``n_movers`` adds
    dynamic box objects driving along the road (KITTI-style outliers);
    ``clutter_per_100m`` adds foliage-blob spheres whose rough surfaces
    produce unstructured returns."""
    rng = np.random.default_rng(seed)
    walls_x, walls_y, poles = [], [], []

    # Building rows on both sides of the road (road along +x, y=0).
    for side in (-1.0, 1.0):
        x = -20.0
        while x < corridor_len + 20.0:
            w = rng.uniform(8.0, 25.0)
            depth_off = rng.uniform(7.0, 16.0)
            h = rng.uniform(4.0, 12.0)
            y_face = side * depth_off
            # Front facade (plane y = y_face over x in [x, x+w]).
            walls_y.append([y_face, x, x + w, 0.0, h])
            # Protruding ledges (awnings / eaves): narrow horizontal bands
            # well in front of the facade at fixed heights — the stable
            # horizontal line features ("beams") real urban scenes provide.
            # Tall enough (0.3 m) to catch a scan ring at range, and far
            # enough out (1.2 m) that the PCA radius-1 neighborhood never
            # mixes them with the facade behind.
            for z_l in (2.4, 4.6):
                if z_l < h - 0.5:
                    walls_y.append([y_face - side * 1.2, x, x + w, z_l, z_l + 0.3])
            # Side walls (plane x = const) — corners create edge lines.
            y_back = side * (depth_off + rng.uniform(4.0, 8.0))
            walls_x.append([x, min(y_face, y_back), max(y_face, y_back), 0.0, h])
            walls_x.append([x + w, min(y_face, y_back), max(y_face, y_back), 0.0, h])
            x += w + rng.uniform(2.0, 8.0)

    # Poles (street lamps / trunks) near the road.
    n_poles = int(corridor_len / 8)
    for _ in range(n_poles):
        px = rng.uniform(-10.0, corridor_len + 10.0)
        py = rng.choice([-1.0, 1.0]) * rng.uniform(4.0, 6.5)
        poles.append([px, py, rng.uniform(0.1, 0.25), rng.uniform(3.0, 7.0)])

    movers = []
    for _ in range(n_movers):
        cx0 = rng.uniform(0.0, corridor_len)
        cy0 = rng.choice([-1.0, 1.0]) * rng.uniform(1.5, 3.5)  # on the road
        speed = rng.uniform(0.5, 2.5) * rng.choice([-1.0, 1.0])  # m per time unit
        movers.append(
            [cx0, cy0, speed, 0.0, rng.uniform(0.8, 1.1), rng.uniform(1.8, 2.6),
             rng.uniform(1.3, 2.0), 0.0]
        )

    clutter = []
    for _ in range(int(clutter_per_100m * corridor_len / 100.0)):
        cx = rng.uniform(-10.0, corridor_len + 10.0)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(4.0, 9.0)
        r = rng.uniform(0.6, 1.8)
        clutter.append([cx, cy, r * rng.uniform(0.8, 1.4), r])

    return World(
        walls_x=np.array(walls_x, np.float32).reshape(-1, 5),
        walls_y=np.array(walls_y, np.float32).reshape(-1, 5),
        poles=np.array(poles, np.float32).reshape(-1, 4),
        ground_z=0.0,
        movers=np.array(movers, np.float32).reshape(-1, 8),
        clutter=np.array(clutter, np.float32).reshape(-1, 4),
    )


def make_city_world(
    seed: int = 0,
    n_blocks_x: int = 4,
    n_blocks_y: int = 2,
    block: float = 90.0,
    street_w: float = 18.0,
    n_movers: int = 12,
    clutter_per_block: float = 3.0,
    parked_per_side: float = 3.0,
    outer_ring: bool = True,
    mover_speed: tuple = (0.5, 2.5),
) -> World:
    """A Manhattan grid of city blocks for KITTI-protocol evaluation: each
    block holds 2-4 axis-aligned buildings (facades, eave ledges, corner
    walls), poles and foliage clutter line the streets, and movers drive on
    the road lattice.  Streets run at x = i*(block+street_w) - street_w/2 and
    the same in y; the companion :func:`make_loop_trajectory` drives around
    the blocks with real 90-degree turns (the round-1 corridor world had
    none, so rotational drift was barely exercised)."""
    rng = np.random.default_rng(seed)
    pitch = block + street_w
    walls_x, walls_y, poles, clutter = [], [], [], []

    for bx in range(n_blocks_x):
        for by in range(n_blocks_y):
            x0 = bx * pitch
            y0 = by * pitch
            # 2-4 buildings per block, random footprints with a setback.
            for _ in range(rng.integers(2, 5)):
                w = rng.uniform(18.0, 45.0)
                l = rng.uniform(18.0, 45.0)
                px = x0 + rng.uniform(2.0, max(block - w - 2.0, 3.0))
                py = y0 + rng.uniform(2.0, max(block - l - 2.0, 3.0))
                h = rng.uniform(5.0, 18.0)
                walls_x.append([px, py, py + l, 0.0, h])
                walls_x.append([px + w, py, py + l, 0.0, h])
                walls_y.append([py, px, px + w, 0.0, h])
                walls_y.append([py + l, px, px + w, 0.0, h])
                # Eave ledges on the two street-facing sides (horizontal lines).
                for z_l in (2.4, 4.6):
                    if z_l < h - 0.5:
                        walls_y.append([py - 0.9, px, px + w, z_l, z_l + 0.3])
                        walls_x.append([px - 0.9, py, py + l, z_l, z_l + 0.3])
            # Street furniture around the block perimeter.
            for _ in range(int(rng.integers(4, 9))):
                side = rng.integers(0, 4)
                s = rng.uniform(0.0, block)
                off = rng.uniform(1.0, 3.0)
                if side == 0:
                    p = [x0 + s, y0 - off]
                elif side == 1:
                    p = [x0 + s, y0 + block + off]
                elif side == 2:
                    p = [x0 - off, y0 + s]
                else:
                    p = [x0 + block + off, y0 + s]
                poles.append([p[0], p[1], rng.uniform(0.08, 0.25), rng.uniform(3.0, 8.0)])
            for _ in range(int(clutter_per_block)):
                side = rng.integers(0, 4)
                s = rng.uniform(0.0, block)
                off = rng.uniform(2.0, 5.0)
                if side == 0:
                    p = [x0 + s, y0 - off]
                elif side == 1:
                    p = [x0 + s, y0 + block + off]
                elif side == 2:
                    p = [x0 - off, y0 + s]
                else:
                    p = [x0 + block + off, y0 + s]
                r = rng.uniform(0.6, 2.0)
                clutter.append([p[0], p[1], r * rng.uniform(0.8, 1.3), r])
            # Parked cars along each block side: static boxes whose ends are
            # the perpendicular surfaces real streets are full of — without
            # them a one-sided street constrains motion only via building
            # corners, which KITTI scenes never rely on alone.
            for side in range(4):
                for _ in range(int(rng.poisson(parked_per_side))):
                    s = rng.uniform(2.0, block - 6.0)
                    off = rng.uniform(4.5, 6.5)
                    ch = rng.uniform(1.3, 1.8)
                    if side in (0, 1):  # along x
                        cy = y0 - off if side == 0 else y0 + block + off
                        cl, cw = rng.uniform(3.8, 5.0), rng.uniform(1.6, 1.9)
                        cx = x0 + s
                        walls_x.append([cx, cy - cw / 2, cy + cw / 2, 0.0, ch])
                        walls_x.append([cx + cl, cy - cw / 2, cy + cw / 2, 0.0, ch])
                        walls_y.append([cy - cw / 2, cx, cx + cl, 0.0, ch])
                        walls_y.append([cy + cw / 2, cx, cx + cl, 0.0, ch])
                    else:  # along y
                        cx = x0 - off if side == 2 else x0 + block + off
                        cl, cw = rng.uniform(3.8, 5.0), rng.uniform(1.6, 1.9)
                        cy = y0 + s
                        walls_y.append([cy, cx - cw / 2, cx + cw / 2, 0.0, ch])
                        walls_y.append([cy + cl, cx - cw / 2, cx + cw / 2, 0.0, ch])
                        walls_x.append([cx - cw / 2, cy, cy + cl, 0.0, ch])
                        walls_x.append([cx + cw / 2, cy, cy + cl, 0.0, ch])

    ext_x = n_blocks_x * pitch
    ext_y = n_blocks_y * pitch

    if outer_ring:
        # Building rows OUTSIDE the perimeter streets, facing the loop: the
        # companion make_loop_trajectory drives the perimeter, and without
        # these the outward-facing half of every scan is empty — ~95% of
        # returns were ground, starving the BPF facade/beam/pillar classifier
        # and making the world easier than any real street (VERDICT r2
        # weak #5).  Each row: facade + side walls + eave ledges + street
        # poles, like the block buildings.
        lo_street = -street_w / 2.0
        for side, horizontal in ((0, True), (1, True), (2, False), (3, False)):
            s = -15.0
            extent = (ext_x if horizontal else ext_y) + 15.0
            while s < extent:
                w = rng.uniform(14.0, 40.0)
                d = rng.uniform(8.0, 20.0)
                h = rng.uniform(4.0, 14.0)
                setback = rng.uniform(6.0, 12.0)
                if horizontal:
                    y_face = (
                        lo_street - setback if side == 0 else ext_y - street_w / 2.0 + setback
                    )
                    y_back = y_face - d if side == 0 else y_face + d
                    walls_y.append([y_face, s, s + w, 0.0, h])
                    walls_x.append([s, min(y_face, y_back), max(y_face, y_back), 0.0, h])
                    walls_x.append([s + w, min(y_face, y_back), max(y_face, y_back), 0.0, h])
                    for z_l in (2.4, 4.6):
                        if z_l < h - 0.5:
                            off = 0.9 if side == 0 else -0.9
                            walls_y.append([y_face + off, s, s + w, z_l, z_l + 0.3])
                    if rng.uniform() < 0.7:
                        py = y_face + (rng.uniform(2.0, 4.0) if side == 0 else -rng.uniform(2.0, 4.0))
                        poles.append([s + rng.uniform(0, w), py, rng.uniform(0.08, 0.25), rng.uniform(3.0, 8.0)])
                else:
                    x_face = (
                        lo_street - setback if side == 2 else ext_x - street_w / 2.0 + setback
                    )
                    x_back = x_face - d if side == 2 else x_face + d
                    walls_x.append([x_face, s, s + w, 0.0, h])
                    walls_y.append([s, min(x_face, x_back), max(x_face, x_back), 0.0, h])
                    walls_y.append([s + w, min(x_face, x_back), max(x_face, x_back), 0.0, h])
                    for z_l in (2.4, 4.6):
                        if z_l < h - 0.5:
                            off = 0.9 if side == 2 else -0.9
                            walls_x.append([x_face + off, s, s + w, z_l, z_l + 0.3])
                    if rng.uniform() < 0.7:
                        px = x_face + (rng.uniform(2.0, 4.0) if side == 2 else -rng.uniform(2.0, 4.0))
                        poles.append([px, s + rng.uniform(0, w), rng.uniform(0.08, 0.25), rng.uniform(3.0, 8.0)])
                s += w + rng.uniform(2.0, 10.0)

    movers = []
    for _ in range(n_movers):
        horizontal = rng.uniform() < 0.5
        lane_off = rng.choice([-1.0, 1.0]) * rng.uniform(1.5, 4.0)
        # mover_speed is meters per frame (10 Hz: (0.5, 2.5) = 18-90 km/h
        # traffic; a low floor adds crawling movers — the semi-stable
        # lingerers that stress persistence eviction hardest).
        speed = rng.uniform(*mover_speed) * rng.choice([-1.0, 1.0])
        if horizontal:
            iy = rng.integers(0, n_blocks_y + 1)
            cy = iy * pitch - street_w / 2.0 + lane_off
            movers.append([rng.uniform(0, ext_x), cy, speed, 0.0,
                           rng.uniform(0.8, 1.1), rng.uniform(1.8, 2.6),
                           rng.uniform(1.3, 2.0), 0.0])
        else:
            ix = rng.integers(0, n_blocks_x + 1)
            cx = ix * pitch - street_w / 2.0 + lane_off
            movers.append([cx, rng.uniform(0, ext_y), 0.0, speed,
                           rng.uniform(0.8, 1.1), rng.uniform(1.8, 2.6),
                           rng.uniform(1.3, 2.0), 0.0])

    return World(
        walls_x=np.array(walls_x, np.float32).reshape(-1, 5),
        walls_y=np.array(walls_y, np.float32).reshape(-1, 5),
        poles=np.array(poles, np.float32).reshape(-1, 4),
        ground_z=0.0,
        movers=np.array(movers, np.float32).reshape(-1, 8),
        clutter=np.array(clutter, np.float32).reshape(-1, 4),
    )


def make_highway_world(
    length: float = 700.0,
    seed: int = 23,
    n_traffic: int = 110,
    jam_frac: float = 0.25,
    barrier_coverage: float = 0.45,
    clutter_per_100m: float = 8.0,
) -> World:
    """A sparse-geometry highway with heavy traffic — the regime where the
    persistence filter's value proposition actually lives.

    The reference's KITTI gains concentrate on road/highway sequences
    (seq 01: FLOAM 1.9504% vs PFilter 1.8055%, README.md:50): few reliable
    static features (guardrails are along-track-invariant, poles/gantries are
    sparse) while moving trucks dominate the scene, so a map polluted with
    vehicle ghosts actively biases the weakly-constrained along-track
    direction.  A feature-dense city grid never tests this — there the map
    is so over-constrained that extra (even contaminated) points only help.

    Geometry: ground, continuous low guardrails at +-7.2 m, intermittent
    noise barriers further out, lamp poles every ~35 m, sign gantries
    (crossbeam + posts) every ~130 m, roadside vegetation clutter.  Traffic:
    ``n_traffic`` box vehicles over 4 lanes (ego drives y=0, same-direction
    lanes at +1.8/+4.8, oncoming at -3.4/-6.6); a ``jam_frac`` fraction
    crawls at 0.05-0.5 m/frame (the semi-stable lingerers hardest for
    eviction).  Pair with :func:`make_ramp_trajectory` at ~2.0 m/frame."""
    rng = np.random.default_rng(seed)
    walls_x, walls_y, poles, clutter = [], [], [], []

    for y in (-7.2, 7.2):  # guardrails
        walls_y.append([y, -40.0, length + 40.0, 0.4, 0.8])
        # Guardrail POSTS every ~4 m: without them every static surface on
        # the empty road (ground, rail, barriers) is an x-invariant plane and
        # along-track is unobservable — scan matching collapses with or
        # without traffic (measured: drift 100% at n_traffic=0).  Real rails
        # are post-mounted; their returns are what real highway odometry
        # actually locks onto.
        x = -40.0
        while x < length + 40.0:
            poles.append([x, y, 0.07, 0.72])
            x += rng.uniform(3.5, 4.5)

    # Distance-marker posts every ~50 m, both shoulders.
    x = 10.0
    while x < length:
        poles.append([x, rng.choice([-1.0, 1.0]) * 8.6, 0.055, 1.1])
        x += rng.uniform(45.0, 55.0)

    for side in (-1.0, 1.0):  # intermittent noise barriers / cut slopes
        x = -30.0
        while x < length + 30.0:
            w = rng.uniform(25.0, 70.0)
            if rng.uniform() < barrier_coverage:
                y = side * rng.uniform(13.0, 18.0)
                h = rng.uniform(2.5, 4.5)
                walls_y.append([y, x, x + w, 0.0, h])
                # End caps: the only x-facing planes a barrier contributes.
                walls_x.append([x, min(y, y + side * 0.4), max(y, y + side * 0.4), 0.0, h])
                walls_x.append([x + w, min(y, y + side * 0.4), max(y, y + side * 0.4), 0.0, h])
            x += w + rng.uniform(10.0, 40.0)

    x, k = 0.0, 0  # lamp poles, alternating sides
    while x < length:
        side = -1.0 if k % 2 else 1.0
        poles.append(
            [x, side * rng.uniform(7.8, 8.6), rng.uniform(0.10, 0.18), rng.uniform(6.0, 9.0)]
        )
        x += rng.uniform(30.0, 42.0)
        k += 1

    x = rng.uniform(60.0, 100.0)  # sign gantries: crossbeam + two posts
    while x < length:
        walls_x.append([x, -9.0, 9.0, 5.4, 6.0])
        poles.append([x, -9.2, 0.25, 5.6])
        poles.append([x, 9.2, 0.25, 5.6])
        x += rng.uniform(110.0, 160.0)

    for _ in range(int(clutter_per_100m * length / 100.0)):
        cx = rng.uniform(-20.0, length + 20.0)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(9.0, 20.0)
        r = rng.uniform(0.5, 1.6)
        clutter.append([cx, cy, r * rng.uniform(0.7, 1.2), r])

    movers = []
    for _ in range(n_traffic):
        # Ego drives y=0; traffic in the adjacent/far lanes both directions
        # (no movers in the ego lane itself — the ego would clip through
        # slower boxes, and rays cast from inside an AABB return garbage).
        lane = rng.choice([-6.6, -3.4, 1.8, 4.8])
        oncoming = lane < 0
        if rng.uniform() < jam_frac:
            speed = rng.uniform(0.05, 0.5)
        else:
            speed = rng.uniform(1.2, 2.8)
        vx = -speed if oncoming else speed
        # Long axis along x (direction of travel): cars 4-5 m, trucks to 9 m.
        movers.append(
            [rng.uniform(-30.0, length + 30.0), lane + rng.uniform(-0.35, 0.35),
             vx, 0.0, rng.uniform(2.0, 4.5), rng.uniform(0.85, 1.25),
             rng.uniform(1.4, 3.2), 0.0]
        )

    return World(
        walls_x=np.array(walls_x, np.float32).reshape(-1, 5),
        walls_y=np.array(walls_y, np.float32).reshape(-1, 5),
        poles=np.array(poles, np.float32).reshape(-1, 4),
        ground_z=0.0,
        movers=np.array(movers, np.float32).reshape(-1, 8),
        clutter=np.array(clutter, np.float32).reshape(-1, 4),
    )


def make_canyon_world(
    length: float = 400.0,
    half_width: float = 8.0,
    height: float = 30.0,
    structured_until: float = 25.0,
    cross_every: float | None = None,
) -> World:
    """A degenerate urban canyon: two parallel facades and a flat ground
    plane.  Between ``structured_until`` and ``length`` the walls are
    FEATURELESS — lateral/yaw/z/roll/pitch stay constrained (facades +
    ground) but the along-track direction is unobservable: every scan looks
    identical under x-translation.  This is the failure mode the windowed
    pose-graph smoother exists for (ops/pose_graph.py:4-13): scan matching
    contributes near-zero along-track information there and the motion model
    must carry it.  The zone before ``structured_until`` has cross-wall
    stubs + poles so the estimator can establish its velocity with real
    geometry first (a cold start INSIDE the degenerate stretch is unsolvable
    for any odometry — nothing ever measures the speed).  ``cross_every``
    adds a cross stub roughly every N meters along the whole run (the
    non-degenerate control).

    Two deliberate design choices keep the test honest: walls are TALL
    (default 30 m) so no beam grazes the wall top — a finite wall's top
    boundary sheds an x-running line of spurious high-curvature points whose
    5-NN fits claim confident-but-wrong along-track information — and the
    stub spacing is APERIODIC, so the scene never aliases onto itself under
    x-translation."""
    walls_y = [
        [-half_width, -40.0, length + 40.0, 0.0, height],
        [half_width, -40.0, length + 40.0, 0.0, height],
    ]
    walls_x, poles = [], []
    rng = np.random.default_rng(17)

    def cross_stub(x):
        # Perpendicular stubs protruding from both facades + an off-center
        # pole: strong, aperiodic along-track geometry at this x.
        depth = rng.uniform(1.5, 3.0)
        for side in (-1.0, 1.0):
            # Bounds must be ordered (the ray caster requires b0 <= b <= b1);
            # for side=-1 the raw products come out reversed.
            b0, b1 = side * (half_width - depth), side * half_width
            walls_x.append([x, min(b0, b1), max(b0, b1), 0.0, height])
        poles.append(
            [x + rng.uniform(0.5, 2.0), rng.uniform(-0.7, 0.7) * half_width,
             rng.uniform(0.1, 0.2), rng.uniform(3.0, 6.0)]
        )

    x = -30.0
    while x < structured_until:
        cross_stub(x)
        x += rng.uniform(4.0, 9.0)
    if cross_every is not None:
        x = structured_until + cross_every
        while x < length + 30.0:
            cross_stub(x)
            x += cross_every * rng.uniform(0.7, 1.3)

    return World(
        walls_x=np.array(walls_x, np.float32).reshape(-1, 5),
        walls_y=np.array(walls_y, np.float32).reshape(-1, 5),
        poles=np.array(poles, np.float32).reshape(-1, 4),
        ground_z=0.0,
        movers=np.zeros((0, 8), np.float32),
        clutter=np.zeros((0, 4), np.float32),
    )


def make_ramp_trajectory(n_frames: int, speed: float = 1.5, ramp_frames: int = 12):
    """Straight +x trajectory that accelerates from rest to ``speed`` over
    ``ramp_frames`` (KITTI sequences start from rest or slow motion; an
    instant-full-speed first frame is a cold start no odometry solves when
    the local geometry is along-track-ambiguous)."""
    v = np.minimum(np.arange(n_frames, dtype=np.float32) / max(ramp_frames, 1), 1.0) * speed
    x = np.concatenate([[0.0], np.cumsum(v[1:])]).astype(np.float32)
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_frames, 1))
    ts = np.stack([x, np.zeros_like(x), np.full_like(x, 1.73)], -1)
    return se3.Pose(q=qs, t=ts)


def make_loop_trajectory(
    n_frames: int,
    speed: float = 1.5,
    n_blocks_x: int = 4,
    n_blocks_y: int = 2,
    block: float = 90.0,
    street_w: float = 18.0,
    corner_radius: float = 10.0,
    accel_frames: int = 40,
    # 0.25 x 1.5 m/frame = 0.375 m/frame through a 10 m-radius corner
    # -> ~2.1 deg/frame yaw rate, matching real 10 Hz urban driving (KITTI
    # corners run 1-2 deg/frame; cars do not take 90-degree turns at 54 km/h).
    corner_speed_factor: float = 0.25,
):
    """Drive a rectangular loop around the city-grid perimeter streets with
    rounded 90-degree corners (KITTI sequences are block circuits; segment
    drift at 100-800 m needs turns to expose rotational error).  The loop is
    re-traversed if the driven distance exceeds its length.

    Vehicle dynamics mirror real 10 Hz driving: speed ramps from rest over
    ``accel_frames`` (KITTI sequences start from standstill — an instant
    1.5 m first-frame jump would defeat any scan-matcher's 1 m association
    gate, the reference's included) and drops to ``corner_speed_factor`` of
    cruise through corners (cars do not corner at 54 km/h)."""
    pitch = block + street_w
    # Perimeter street centerlines.
    lo = -street_w / 2.0
    hi_x = n_blocks_x * pitch - street_w / 2.0
    hi_y = n_blocks_y * pitch - street_w / 2.0
    r = corner_radius
    # Piecewise path: 4 straights + 4 quarter arcs, counter-clockwise.
    straights = [
        ((lo + r, lo), (hi_x - r, lo), 0.0),  # +x along bottom
        ((hi_x, lo + r), (hi_x, hi_y - r), np.pi / 2),  # +y right
        ((hi_x - r, hi_y), (lo + r, hi_y), np.pi),  # -x top
        ((lo, hi_y - r), (lo, lo + r), -np.pi / 2),  # -y left
    ]
    corners = [  # (center, start angle) — CCW quarter arcs
        ((hi_x - r, lo + r), -np.pi / 2),
        ((hi_x - r, hi_y - r), 0.0),
        ((lo + r, hi_y - r), np.pi / 2),
        ((lo + r, lo + r), np.pi),
    ]
    seg_pts = []
    seg_head = []
    seg_corner = []
    for i in range(4):
        (x0, y0), (x1, y1), head = straights[i]
        length = float(np.hypot(x1 - x0, y1 - y0))
        n = max(int(length * 4), 2)  # 0.25 m polyline resolution
        ts = np.linspace(0.0, 1.0, n, endpoint=False)
        seg_pts.append(np.stack([x0 + ts * (x1 - x0), y0 + ts * (y1 - y0)], -1))
        seg_head.append(np.full(n, head))
        seg_corner.append(np.zeros(n, bool))
        (cx, cy), a0 = corners[i]
        n_arc = max(int(r * np.pi / 2 * 4), 2)
        aa = a0 + np.linspace(0.0, np.pi / 2, n_arc, endpoint=False)
        seg_pts.append(np.stack([cx + r * np.cos(aa), cy + r * np.sin(aa)], -1))
        seg_head.append(aa + np.pi / 2)
        seg_corner.append(np.ones(n_arc, bool))
    pts = np.concatenate(seg_pts)
    heads = np.concatenate(seg_head)
    is_corner = np.concatenate(seg_corner)
    # Arc-length parameterization of the dense polyline.
    d = np.linalg.norm(np.diff(pts, axis=0, append=pts[:1]), axis=1)
    s_cum = np.concatenate([[0.0], np.cumsum(d)[:-1]])
    total = float(np.cumsum(d)[-1])

    # Integrate driven distance with an acceleration ramp and corner
    # slowdown (speed limited by the path 6 m ahead so braking leads turns).
    s_list = np.zeros(n_frames)
    s_now = 0.0
    for i in range(n_frames):
        look = (s_now + 6.0) % total
        j = np.searchsorted(s_cum, look, side="right") - 1
        jn = np.searchsorted(s_cum, s_now % total, side="right") - 1
        v_lim = speed * (corner_speed_factor if (is_corner[j] or is_corner[jn]) else 1.0)
        ramp = min(1.0, (i + 1) / max(accel_frames, 1))
        s_now += v_lim * ramp
        s_list[i] = s_now
    s = s_list % total
    idx = np.searchsorted(s_cum, s, side="right") - 1
    xy = pts[idx]
    heading = heads[idx]
    qs = np.stack(
        [np.cos(heading / 2), np.zeros_like(heading), np.zeros_like(heading),
         np.sin(heading / 2)], -1,
    ).astype(np.float32)
    ts_ = np.stack([xy[:, 0], xy[:, 1], np.full(len(xy), 1.73)], -1).astype(np.float32)
    return se3.Pose(q=qs, t=ts_)


def make_trajectory(
    n_frames: int, speed: float = 1.0, curve_amp: float = 4.0, curve_period: float = 120.0
):
    """Ground-truth poses along a gentle S-curve at sensor height 1.73 m.
    ``speed`` is meters per frame (10 Hz KITTI ~ 1-2 m/frame)."""
    s = np.arange(n_frames) * speed
    x = s
    y = curve_amp * np.sin(2 * np.pi * s / curve_period)
    dy = curve_amp * (2 * np.pi / curve_period) * np.cos(2 * np.pi * s / curve_period)
    heading = np.arctan2(dy, np.ones_like(dy))
    qs = np.stack(
        [np.cos(heading / 2), np.zeros_like(heading), np.zeros_like(heading), np.sin(heading / 2)],
        -1,
    ).astype(np.float32)
    ts = np.stack([x, y, np.full_like(x, 1.73)], -1).astype(np.float32)
    return se3.Pose(q=qs, t=ts)


def _ray_world_hits(origins, dirs, world: World, max_range: float, t_time=0.0):
    """Vectorized ray vs (ground, walls, poles, movers, clutter).  Returns
    ``(t [N], is_mover [N])`` — hit distance (``2*max_range`` where nothing
    is hit) and whether the nearest hit was a dynamic mover.  ``t_time``
    (frame index) advances the movers."""
    dev = dirs.device
    big = max_range * 2.0
    o, d = origins, dirs
    n = o.shape[0]

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def nonzero_dir(x):
        return torch.where(torch.abs(x) < 1e-9, torch.full_like(x, 1e-9), x)

    def min_or_big(ok, t):
        return torch.amin(torch.where(ok, t, torch.full_like(t, big)), dim=1)

    tz = (world.ground_z - o[:, 2]) / nonzero_dir(d[:, 2])
    t_ground = torch.where(tz > 0.1, tz, torch.full_like(tz, big))

    def wall_hits(vals, o_a, d_a, o_b, o_z, d_b, d_z):
        # vals: [W,5] = plane coord, b0, b1, z0, z1
        if vals.shape[0] == 0:
            return torch.full((n,), big, dtype=torch.float32, device=dev)
        v = tensor(vals)
        t = (v[:, 0][None, :] - o_a[:, None]) / nonzero_dir(d_a[:, None])
        b = o_b[:, None] + t * d_b[:, None]
        z = o_z[:, None] + t * d_z[:, None]
        ok = (t > 0.1) & (b >= v[:, 1][None]) & (b <= v[:, 2][None]) & (z >= v[:, 3][None]) & (z <= v[:, 4][None])
        return min_or_big(ok, t)

    t_wx = wall_hits(world.walls_x, o[:, 0], d[:, 0], o[:, 1], o[:, 2], d[:, 1], d[:, 2])
    t_wy = wall_hits(world.walls_y, o[:, 1], d[:, 1], o[:, 0], o[:, 2], d[:, 0], d[:, 2])

    # Poles: |o_xy + t d_xy - c|^2 = r^2, hit if 0 <= z <= h.
    if world.poles.shape[0] > 0:
        poles = tensor(world.poles)
        c = poles[:, :2]
        r = poles[:, 2][None]
        h = poles[:, 3][None]
        oc = o[:, None, :2] - c[None]
        dxy = d[:, None, :2]
        a = torch.sum(dxy * dxy, -1)
        bq = 2 * torch.sum(oc * dxy, -1)
        cq = torch.sum(oc * oc, -1) - r * r
        disc = bq * bq - 4 * a * cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = (-bq - sq) / torch.clamp(2 * a, min=1e-9)
        z1 = o[:, None, 2] + t1 * d[:, None, 2]
        t_pole = min_or_big((disc > 0) & (t1 > 0.1) & (z1 >= 0.0) & (z1 <= h), t1)
    else:
        t_pole = torch.full((n,), big, dtype=torch.float32, device=dev)

    t_hit = torch.minimum(torch.minimum(t_ground, torch.minimum(t_wx, t_wy)), t_pole)
    t_static = t_hit

    # Dynamic movers: axis-aligned boxes at c0 + v * t_time (slab method).
    if world.movers.shape[0] > 0:
        m = tensor(world.movers)
        c = m[:, 0:2] + m[:, 2:4] * t_time
        half = m[:, 4:6]
        h_box = m[:, 6]
        lo3 = torch.stack([c[:, 0] - half[:, 0], c[:, 1] - half[:, 1], torch.zeros_like(h_box)], -1)
        hi3 = torch.stack([c[:, 0] + half[:, 0], c[:, 1] + half[:, 1], h_box], -1)
        dn = nonzero_dir(d)
        tA = (lo3[None] - o[:, None]) / dn[:, None]
        tB = (hi3[None] - o[:, None]) / dn[:, None]
        tmin = torch.amax(torch.minimum(tA, tB), dim=-1)
        tmax = torch.amin(torch.maximum(tA, tB), dim=-1)
        t_hit = torch.minimum(t_hit, min_or_big((tmax >= tmin) & (tmin > 0.1), tmin))

    # Foliage clutter: spheres at (cx, cy, cz) radius r (static).
    if world.clutter.shape[0] > 0:
        cl = tensor(world.clutter)
        cc = cl[:, :3]
        cr = cl[:, 3][None]
        ocs = o[:, None, :] - cc[None]
        a2 = torch.sum(d[:, None] * d[:, None], -1)
        b2 = 2 * torch.sum(ocs * d[:, None], -1)
        c2 = torch.sum(ocs * ocs, -1) - cr * cr
        disc2 = b2 * b2 - 4 * a2 * c2
        sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))
        ts1 = (-b2 - sq2) / torch.clamp(2 * a2, min=1e-9)
        t_cl = min_or_big((disc2 > 0) & (ts1 > 0.1), ts1)
        t_hit = torch.minimum(t_hit, t_cl)
        t_static = torch.minimum(t_static, t_cl)

    # Mover-origin iff the nearest hit overall beat every static primitive.
    return t_hit, t_hit < t_static


def render_scan(
    pose: se3.Pose,
    world: World,
    lidar: LidarConfig,
    n_azimuth: int,
    noise: float = 0.01,
    seed: int = 0,
    t_time=0.0,
    return_mover: bool = False,
    device=None,
):
    """Ray-cast one scan on ``device`` (CUDA unless ``"cpu"`` is passed).
    Returns (xyz_sensor [R*A, 3], valid [R*A]) in ring-major order, plus the
    per-point mover-origin mask with ``return_mover=True``.  ``seed`` seeds
    the range noise's generator; ``t_time`` (frame index) advances movers."""
    dev = resolve_device(device)
    elev = np.radians(beam_elevations(lidar.num_lines)).astype(np.float32)
    az = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False).astype(np.float32)
    ce, se_ = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    dirs_np = np.stack(
        [ce[:, None] * ca[None, :], ce[:, None] * sa[None, :], np.broadcast_to(se_[:, None], (elev.shape[0], n_azimuth))],
        -1,
    ).reshape(-1, 3).astype(np.float32)
    dirs_sensor = torch.from_numpy(dirs_np).to(dev)
    q = torch.as_tensor(pose.q, dtype=torch.float32, device=dev)
    t = torch.as_tensor(pose.t, dtype=torch.float32, device=dev)
    dirs_world = se3.quat_rotate(q, dirs_sensor)
    origins = t.expand_as(dirs_world)
    rng, is_mover = _ray_world_hits(origins, dirs_world, world, lidar.max_distance, t_time=t_time)
    if noise:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        rng = rng + torch.randn(rng.shape, generator=gen, device=dev) * noise
    # Planar (xy) distance gate mirrors the feature extractor's (ref :25-26).
    pts = dirs_sensor * rng[:, None]
    planar = torch.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    valid = (rng > lidar.min_distance) & (rng < lidar.max_distance) & (planar > lidar.min_distance)
    if return_mover:
        return pts, valid, is_mover
    return pts, valid


def render_sequence(world: World, poses: se3.Pose, lidar: LidarConfig, n_azimuth: int, noise: float = 0.01, device=None):
    """Render every frame of ``poses`` on ``device`` (CUDA unless ``"cpu"``
    is passed); frame ``i`` uses ``seed=i`` and ``t_time=i``.  Returns
    ``(xyz [F, R*A, 3], valid [F, R*A])``."""
    q, t = np.asarray(poses.q), np.asarray(poses.t)
    xs, vs = [], []
    for i in range(t.shape[0]):
        x, v = render_scan(se3.Pose(q=q[i], t=t[i]), world, lidar, n_azimuth, noise=noise, seed=i, t_time=i, device=device)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs), torch.stack(vs)


SHARED_NOISE_SIGMA = 0.008  # m, the v1 protocol's range noise (bench.py)
SHARED_NOISE_SEED = 1000  # frame i draws from np.random.default_rng(SHARED_NOISE_SEED + i)


def shared_range_noise(xyz, valid, frame: int, sigma: float = SHARED_NOISE_SIGMA) -> np.ndarray:
    """Range noise for frame ``frame`` of a noise-free scan, in numpy and
    float32: ``n ~ N(0, sigma)`` from ``np.random.default_rng(1000 + frame)``,
    one draw per ray, moves each valid ray's point along the ray,
    ``xyz * (1 + n / |xyz|)``; invalid rays are left as they are.  The one
    definition of the noise that the reference package's trajectories
    (``tools/torch_reference_trajectories.py``) and the port's runs against
    them (``chip_smoke.py``, ``run_distributed``, the tests) add to their own
    renderers' noise-free scans."""
    xyz = np.asarray(xyz, np.float32)
    valid = np.asarray(valid, bool)
    n = np.random.default_rng(SHARED_NOISE_SEED + int(frame)).normal(0.0, sigma, xyz.shape[0]).astype(np.float32)
    r = np.linalg.norm(xyz, axis=1)
    scale = np.where(valid, np.float32(1.0) + n / np.maximum(r, np.float32(1e-6)), np.float32(1.0)).astype(np.float32)
    return xyz * scale[:, None]


def render_shared_sequence(world: World, poses: se3.Pose, lidar: LidarConfig, n_azimuth: int, device=None):
    """Every frame of ``poses`` rendered noise-free on ``device`` (CUDA
    unless ``"cpu"``), with ``t_time=i``, plus ``shared_range_noise`` of
    frame ``i``: ``(xyz [F, R*A, 3], valid [F, R*A])`` on ``device``."""
    dev = resolve_device(device)
    q, t = np.asarray(poses.q), np.asarray(poses.t)
    xs, vs = [], []
    for i in range(t.shape[0]):
        x, v = render_scan(se3.Pose(q=q[i], t=t[i]), world, lidar, n_azimuth, noise=0.0, t_time=float(i), device=dev)
        v_np = v.cpu().numpy()
        xs.append(torch.from_numpy(shared_range_noise(x.cpu().numpy(), v_np, i)).to(dev))
        vs.append(v)
    return torch.stack(xs), torch.stack(vs)
