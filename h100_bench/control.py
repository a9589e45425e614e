"""The controls of the checks, on the chip at a cell's own size:

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, one process runs the cell's set-up and a window of
``--seconds``, then prints one JSON line: the numbers the run compares
(``program``) beside the control's (the reference in the program's place at
the next precision below the configuration's) and, where the cell has them,
its faults'.  The limits in ``workloads/<cell>.json`` lie between the two.
The benchmark's own runs do not run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def readings(name: str, seed: int, seconds: float, device_name: str = "cuda", files=None) -> dict:
    import torch

    bench = harness.read_json("..", "BENCHMARK.json")
    _, wl, cfg = files if files is not None else harness.cell_files(name, bench)
    device = torch.device(device_name)
    generator = harness.load_module(harness.HERE / "traffic" / f"{wl['generator']}.py")
    traffic = generator.Traffic(cfg, wl["params"], seed, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    harness.run_window(traffic, seconds, sync)
    traffic.release()
    out = {"seed": seed, "program": {c["name"]: c["value"] for c in traffic.check("fp32")}}
    for key, checks in traffic.control().items():
        out[key] = {c["name"]: c["value"] for c in checks}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = readings(args.workload, seed, args.seconds)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
