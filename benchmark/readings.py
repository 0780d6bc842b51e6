"""The readings a cell's limits are set from: for each seed, one call of
the cell's traffic at its own sizes, then the same comparison a run makes.
``--control`` puts the cell's lower-precision control in the program's
place (its traffic file's ``control``); ``--fault NAME`` breaks the timed
path underneath: a training cell's step (``unchanged``: the optimizer
leaves the state as it is; ``half_batch``: the step sees half its batch;
``token``: one patch of every strong view altered where the dual view makes
it) or an EMD cell's solver (``iters_<n>``: n iterations instead of the
configured number). ``--control-as JSON`` reads another control than the
traffic file's, such as ``'{"tf32_matmul": true}'``. All seeds run in one
process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 [--control | --fault NAME]

Prints one JSON line per seed: {"seed", "control", "checks": {name: value}}.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.core import load_spec, make_driver, require_card, sync_for  # noqa: E402


def readings(spec: dict, device, seeds, control: bool = False, fault=None):
    """Yield (seed, {check name: value}) for each seed."""
    sync = sync_for(device)
    kw = {"fault": fault} if fault else {}
    for seed in seeds:
        cell = make_driver(spec, device, seed, control=control, **kw)
        cell.prime()
        cell.call()
        sync()
        cell.free()
        yield seed, cell.readings()
        del cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--control-as", default=None, help="a control other than the traffic's")
    args = p.parse_args(argv)
    spec = load_spec(args.workload)
    if args.control_as:
        spec["traffic"]["control"] = json.loads(args.control_as)
        args.control = True
    require_card(int(spec["workload"]["chips"]))
    import torch

    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, checks in readings(spec, torch.device("cuda", 0), seeds, args.control,
                                 args.fault):
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
