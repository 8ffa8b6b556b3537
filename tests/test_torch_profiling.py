"""The port's profiling helpers (``utils/profiling.py``): a twin of
``tests/test_config_profiling.py::test_stage_timer``, which results make a
stage wait for the device, and ``device_trace``'s Chrome trace."""

import json

import pytest
import torch

from pfilter_tpu_torch.utils import profiling
from pfilter_tpu_torch.utils.profiling import StageTimer, device_trace


def test_stage_timer(tmp_path):
    path = tmp_path / "stages.jsonl"
    st = StageTimer(jsonl_path=str(path))
    for _ in range(3):
        with st.stage("work") as out:
            out["result"] = torch.ones(16).sum()
    st.close()
    s = st.summary()
    assert s["work"]["n"] == 3 and s["work"]["mean_ms"] >= 0
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 3 and lines[0]["stage"] == "work"
    assert "work" in st.report()


def test_only_cuda_results_wait_for_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(1))
    st = StageTimer()
    with st.stage("cpu", result={"a": [torch.zeros(2)], "b": 3}):
        pass
    assert calls == [] and not profiling._holds_cuda((torch.zeros(1), {"x": [torch.ones(2)]}))
    monkeypatch.setattr(profiling, "_holds_cuda", lambda x: True)  # as for a result holding CUDA tensors
    with st.stage("cuda", result=torch.zeros(1)):
        pass
    assert calls == [1]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stage_on_cuda_tensors_includes_device_time(cuda_device):
    st = StageTimer()
    with st.stage("sleep") as out:
        torch.cuda._sleep(50_000_000)  # ~tens of ms of device time
        out["result"] = torch.zeros(1, device=cuda_device)
    assert st.summary()["sleep"]["mean_ms"] > 5.0
