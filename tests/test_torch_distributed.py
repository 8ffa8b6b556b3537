"""Two-process run of the port's distributed entry point, the twin of
``tests/test_distributed.py``: ``python -m pfilter_tpu_torch.run_distributed
--device cpu`` in two processes (gloo, a 1 seq x 2 map grid) renders its
scans, runs the map-sharded step across the process boundary and prints one
JSON line from rank 0."""

import json

import numpy as np

from torch_dist import Workers


def test_two_process_sharded_step(tmp_path):
    argv = ["--preset", "small", "--frames", "2", "--scan-points", "4096"]
    out = Workers(tmp_path, "pg", 2, None, argv=argv).wait()
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert lines, out[-3000:]
    res = json.loads(lines[-1])
    assert res["distributed"] == "ok"
    assert res["processes"] == 2 and res["backend"] == "gloo" and res["device"] == "cpu"
    assert (res["n_seq"], res["n_map"], res["mode"], res["frames"]) == (1, 2, "es", 2)
    assert np.isfinite(res["final_pose_t"][0]).all() and np.isfinite(res["ms_per_frame"])
    # The second frame ran the step's collectives: candidates and writebacks
    # gathered, map sizes, normal equations and diagnostics summed.
    assert res["collectives_rank0"]["all_gather"] > 0 and res["collectives_rank0"]["all_reduce"] > 2
