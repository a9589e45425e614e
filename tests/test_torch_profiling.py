"""``utils/profiling.py::trace`` writes a Chrome trace on the CPU, with the
regions the port's spans name in it, and keeps those spans in memory."""

import json

import torch

from dags_vae_search_tpu_torch.utils.profiling import snapshot, span, trace


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with trace(str(tmp_path)):
        with span("pipeline_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pipeline_region" for e in events)
    assert [s["name"] for s in snapshot()["spans"]] == ["pipeline_region"]
