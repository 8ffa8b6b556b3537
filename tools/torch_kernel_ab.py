#!/usr/bin/env python3
"""Device times of the port's tiled kernels against their first CUDA version,
at the shapes of every path that ``chip_smoke.py`` drives.

    mkdir -p .scratch/c90bce5 && git archive c90bce5 pfilter_tpu_torch/csrc | tar -x -C .scratch/c90bce5
    python3 tools/torch_kernel_ab.py --baseline .scratch/c90bce5/pfilter_tpu_torch/csrc [--chunks 8 16 32]

Needs one CUDA card and nvcc.  Renders the v1 protocol's scans on the card
(as ``chip_smoke.py``), runs ES and default BPF for ``chip_smoke.ES_FRAMES``
/ ``BPF_FRAMES`` frames and radius BPF for ``chip_smoke.FRAMES`` (or
``--frames``), and takes each path's kNN inputs at its last frame (ES edge
and surf; beam, pillar and facade of both BPF paths) and the radius
front-end's moment inputs of the last scan, as ``chip_smoke.py`` does.

``--baseline`` is a directory of the kernel sources of commit c90bce5 (one
block per query tile for the kNN, one per (tile, 128-query chunk) for the PCA
moments), whose C interface ``BASELINE_SIGNATURES`` declares; they are built
into that directory's ``_build/``.  On every input the tree's wrapper and
the baseline's launch, made as its wrapper made it, must agree (kNN bit for
bit, PCA counts exact), and both are timed by the replay of a CUDA graph of
``chip_smoke.REPEATS`` calls (``chip_smoke.graph_ms``: the card alone) in
turns baseline, tree, tree, baseline.  ``--chunks`` also times the tree's
kNN kernel alone (its work list built beforehand) at other work-item sizes,
in one order and then the reverse.  Prints one line per input and a JSON
record last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# pf_knn_tiled(xyz_t, stride, tile_start, bounds, origin, queries, n_queries,
#   nt, tile_cells, w, out_idx, out_sqdist, stream);
# pf_pca_radius(xyz_t, stride, tile_start, bounds, chunk_start, origin,
#   queries, nt, tile_cells, w, radius_sq, n_blocks, out, stream).
BASELINE_SIGNATURES = {
    "pf_knn_tiled": [_VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP, _VP, _VP],
    "pf_pca_radius": [_VP, _CI, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CF, _CI, _VP, _VP],
}
BASELINE_PCA_CHUNK = 128


def stream():
    return torch.cuda.current_stream().cuda_stream


def load_baseline(csrc: Path):
    from pfilter_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(_build.build(csrc, csrc / "_build")))
    for name, argtypes in BASELINE_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def baseline_knn(lib, tmap, q, bounds, params):
    nt, tc, tcap = params
    idx = torch.empty((q.shape[0], 5), dtype=torch.int32, device=q.device)
    sqdist = torch.empty((q.shape[0], 5), dtype=torch.float32, device=q.device)
    err = lib.pf_knn_tiled(tmap.xyz_t.data_ptr(), tmap.xyz_t.shape[1], tmap.tile_start.data_ptr(), bounds.data_ptr(),
                           tmap.origin.data_ptr(), q.data_ptr(), q.shape[0], nt, tc, 3 * tcap, idx.data_ptr(),
                           sqdist.data_ptr(), stream())
    cs.check(err == 0, f"baseline kNN launch failed: CUDA error {err}")
    return idx, sqdist


def baseline_pca(lib, tmap, sq, bounds, params, radius):
    nt, tc, tcap = params
    out = torch.zeros((sq.shape[0], 10), dtype=torch.float32, device=sq.device)
    chunks = torch.div(bounds[1:] - bounds[:-1] + (BASELINE_PCA_CHUNK - 1), BASELINE_PCA_CHUNK, rounding_mode="floor")
    chunk_start = torch.zeros(nt * nt + 1, dtype=torch.int32, device=sq.device)
    chunk_start[1:] = torch.cumsum(chunks, 0, dtype=torch.int32)
    n_blocks = (sq.shape[0] + BASELINE_PCA_CHUNK - 1) // BASELINE_PCA_CHUNK + nt * nt
    err = lib.pf_pca_radius(tmap.xyz_t.data_ptr(), tmap.xyz_t.shape[1], tmap.tile_start.data_ptr(), bounds.data_ptr(),
                            chunk_start.data_ptr(), tmap.origin.data_ptr(), sq.data_ptr(), nt, tc, 3 * tcap,
                            radius * radius, n_blocks, out.data_ptr(), stream())
    cs.check(err == 0, f"baseline PCA launch failed: CUDA error {err}")
    return out


def in_turns(tree, base):
    """Graph-replay times in turns baseline, tree, tree, baseline."""
    b1, t1, t2, b2 = cs.graph_ms(base), cs.graph_ms(tree), cs.graph_ms(tree), cs.graph_ms(base)
    return {"device_ms": (t1 + t2) / 2, "baseline_device_ms": (b1 + b2) / 2, "turns_ms": [b1, t1, t2, b2]}


def chunk_times(knn, tmap, q, bounds, params, chunks):
    """The tree's kNN kernel alone at each work-item size, bit for bit
    against the plain version; times in one order, then the reverse."""
    from pfilter_tpu_torch.ops import _build

    nt, tc, tcap = params
    lib = _build.load()
    ref = knn.query_tiled_sorted_plain(tmap, q, bounds, *params)
    fns = {}
    for chunk in chunks:
        work = knn.work_list(bounds, nt, chunk, q.shape[0])
        idx = torch.empty((q.shape[0], 5), dtype=torch.int32, device=q.device)
        sqd = torch.empty((q.shape[0], 5), dtype=torch.float32, device=q.device)

        def launch(work=work, idx=idx, sqd=sqd, chunk=chunk):
            err = lib.pf_knn_tiled(tmap.xyz_t.data_ptr(), tmap.xyz_t.shape[1], tmap.tile_start.data_ptr(),
                                   bounds.data_ptr(), work.data_ptr(), tmap.origin.data_ptr(), q.data_ptr(), q.shape[0],
                                   nt, tc, 3 * tcap, chunk, idx.data_ptr(), sqd.data_ptr(), stream())
            cs.check(err == 0, f"kNN launch failed at chunk {chunk}: CUDA error {err}")

        launch()
        torch.cuda.synchronize()
        cs.check(torch.equal(idx, ref.idx) and torch.equal(sqd, ref.sqdist), f"kNN at chunk {chunk} differs from plain")
        fns[chunk] = launch
    times = {c: [] for c in chunks}
    for c in list(chunks) + list(chunks)[::-1]:
        times[c].append(cs.graph_ms(fns[c]))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True, help="kernel sources of commit c90bce5")
    ap.add_argument("--frames", type=int, nargs=3, default=[cs.ES_FRAMES, cs.BPF_FRAMES, cs.FRAMES],
                    metavar=("ES", "BPF", "RADIUS"))
    ap.add_argument("--chunks", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: needs a CUDA card")
    from pfilter_tpu_torch.config import apply_dotted_overrides, kitti_config
    from pfilter_tpu_torch.ops import knn_tiled as knn
    from pfilter_tpu_torch.ops import pca_radius as pr
    from pfilter_tpu_torch.pipeline import make_pipeline
    from pfilter_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    base = load_baseline(args.baseline)
    cfg = kitti_config()
    cfg_rad = apply_dotted_overrides(cfg.replace(mode="bpf"), cs.RADIUS_OVERRIDES)
    poses = synthetic.make_loop_trajectory(cs.FRAMES, speed=cs.SPEED)
    frames = cs.render_all(cfg, synthetic.make_city_world(seed=7), poses, synthetic, dev)
    floor = cs.graph_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor {floor:.4f} ms (empty kernel, CUDA graph)", flush=True)
    record = {"nvidia_smi": smi, "launch_floor_device_ms": floor, "frames": args.frames, "knn": {}}
    paths = (("es", cfg, cs.frame_queries), ("bpf_voxel", cfg.replace(mode="bpf"), cs.bpf_frame_queries),
             ("bpf_radius", cfg_rad, cs.bpf_frame_queries))
    for (label, c, queries_of), n in zip(paths, args.frames):
        pipe = make_pipeline(c, sync=False, fetch_lag=4)
        for i in range(n):
            pipe.process_frame(*frames[i])
        pipe.flush()
        for kind, (tmap, q, bounds, params) in queries_of(pipe.cfg, pipe.state, *frames[n - 1]).items():
            nt, tc, tcap = params
            tree = lambda: knn._query_tiled_sorted_cuda(tmap, q, bounds, nt, tc, tcap, 5)  # noqa: E731
            old = lambda: baseline_knn(base, tmap, q, bounds, params)  # noqa: E731
            ri, rd = old()
            new = tree()
            cs.check(torch.equal(ri, new.idx) and torch.equal(rd, new.sqdist), f"{label} {kind}: baseline kNN differs")
            row = in_turns(tree, old)
            row["pairs"] = cs.knn_bound(knn, tmap, q, bounds, params)[2]
            if args.chunks:
                row["kernel_alone_by_chunk_ms"] = chunk_times(knn, tmap, q, bounds, params, args.chunks)
            record["knn"][f"{label}_{kind}"] = row
            print(f"{label} {kind}: {int(bounds[nt * nt])} queries, {row['pairs']:.0f} pairs; device_ms tree "
                  f"{row['device_ms']:.4f}, baseline {row['baseline_device_ms']:.4f} (turns {row['turns_ms']})"
                  + (f"; kernel alone by item size {row['kernel_alone_by_chunk_ms']}" if args.chunks else ""), flush=True)

    nt, tc, tcap = cfg_rad.capacity.knn_tiles, cfg_rad.capacity.tile_cells, cfg_rad.capacity.frontend_tile_cap
    radius = cfg_rad.pca.neighbor_radius
    xyz, valid = frames[args.frames[2] - 1]
    ng = cs.nonground_cloud(cfg_rad, xyz, valid)
    tmap = cs.tiled_cloud(knn, xyz, ng, nt, tc, tcap)
    qs = knn.sort_queries(xyz, ng, tmap.origin, nt, tc)
    sq = xyz[qs.order].contiguous()
    tree = lambda: pr._radius_moments_sorted_cuda(tmap, sq, qs.bounds, nt, tc, tcap, radius)  # noqa: E731
    old = lambda: baseline_pca(base, tmap, sq, qs.bounds, (nt, tc, tcap), radius)  # noqa: E731
    cs.check(torch.equal(old()[:, 0], tree()[:, 0]), "baseline PCA counts differ")
    row = in_turns(tree, old)
    row["queries"] = int(qs.bounds[nt * nt])
    record["pca"] = row
    print(f"pca frame {args.frames[2] - 1}: {row['queries']} queries; device_ms tree {row['device_ms']:.4f}, baseline "
          f"{row['baseline_device_ms']:.4f} (turns {row['turns_ms']})", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    try:
        main()
    except cs.PhaseError as e:
        sys.exit(f"torch_kernel_ab: FAILED: {e}")
