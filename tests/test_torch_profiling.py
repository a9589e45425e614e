"""``utils/profiling.py::trace`` writes a Chrome trace on the CPU, with the
regions ``annotate`` names in it."""

import json

import torch

from dags_vae_search_tpu_torch.utils.profiling import annotate, trace


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with trace(str(tmp_path)):
        with annotate("pipeline_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pipeline_region" for e in events)
