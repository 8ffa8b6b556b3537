#!/usr/bin/env python3
"""What the PCA kernel's staging cull keeps, emulated on the CPU.

    python3 tools/torch_pca_cull_stats.py [--frame 299] [--chunks 32 16 8]

Renders one scan of the v1 protocol (``make_city_world(seed=7)``,
``make_loop_trajectory(300, speed=1.5)``, ``kitti_config()`` with the radius
front-end of ``chip_smoke.RADIUS_OVERRIDES``), takes its non-ground cloud as
both map and queries (tile cap 5120), lists the work items as
``csrc/pca_radius.cu`` takes them for each item size, and applies the
kernel's cull through its plain version (``pca_radius.cull_keep_plain``, in
the kernel's fp32 order): each halo candidate is kept when every recentered
coordinate lies within ``radius + CULL_MARGIN`` of the bounding box of the
item's recentered queries.  Prints, per item size, the items, the
candidates staged (every halo slot of every item), those kept, and the
(query, kept candidate) tests the sum phase makes.  The counts are the
kernel's work, not device metrics: the scan is rendered with the CPU's noise
stream, so they are close to, not equal to, a card run's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config  # noqa: E402
from pfilter_tpu_torch.ops import knn_tiled as knn  # noqa: E402
from pfilter_tpu_torch.ops import pca_radius as pr  # noqa: E402
from pfilter_tpu_torch.utils import synthetic  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frame", type=int, default=299)
    ap.add_argument("--chunks", type=int, nargs="+", default=[32, 16, 8])
    args = ap.parse_args()
    cfg = apply_dotted_overrides(kitti_config().replace(mode="bpf"), cs.RADIUS_OVERRIDES)
    poses = synthetic.make_loop_trajectory(cs.FRAMES, speed=cs.SPEED)
    pose = synthetic.se3.Pose(q=poses.q[args.frame], t=poses.t[args.frame])
    xyz, valid = synthetic.render_scan(pose, synthetic.make_city_world(seed=7), cfg.lidar, cs.AZIMUTH, noise=0.008,
                                       seed=0, t_time=float(args.frame), device=torch.device("cpu"))
    cap = cfg.capacity.scan_points
    n = min(cap, xyz.shape[0])
    x = torch.zeros((cap, 3))
    v = torch.zeros(cap, dtype=torch.bool)
    x[:n], v[:n] = xyz[:n], valid[:n]
    ng = cs.nonground_cloud(cfg, x, v)
    nt, tc, tcap = cfg.capacity.knn_tiles, cfg.capacity.tile_cells, cfg.capacity.frontend_tile_cap
    tmap = cs.tiled_cloud(knn, x, ng, nt, tc, tcap)
    qs = knn.sort_queries(x, ng, tmap.origin, nt, tc)
    sq = x[qs.order]
    c_start, c_cnt = knn._halo_ranges(tmap, nt, 3 * tcap)
    ctr = knn._tile_centers(tmap.origin, nt, tc)
    xyz_t = tmap.xyz_t[:3].T
    radius = cfg.pca.neighbor_radius
    print(f"frame {args.frame}: {int(ng.sum())} non-ground points (queries and map), tile cap {tcap}")
    for chunk in args.chunks:
        work = knn.work_list_plain(qs.bounds, nt, chunk, x.shape[0])
        staged = kept = tests = widest = 0
        for tile, q0, nq, _ in work[1 : 1 + int(work[0, 0])].tolist():
            k = 0
            for r in range(3):
                s0, cnt = int(c_start[tile, r]), int(c_cnt[tile, r])
                k += int(pr.cull_keep_plain(sq[q0 : q0 + nq], xyz_t[s0 : s0 + cnt], ctr[tile], radius)[0].sum())
                staged += cnt
            kept += k
            tests += k * nq
            widest = max(widest, k)
        print(f"  items of <= {chunk} queries: {int(work[0, 0])} items, {staged} candidates staged, {kept} kept "
              f"({kept / max(staged, 1):.3f}), {tests} (query, kept candidate) tests, at most {widest} kept in one item")


if __name__ == "__main__":
    main()
