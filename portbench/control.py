"""Run a cell with the control in the program's place, and with the program,
on several seeds: the readings that each check's limit is set from.

    python3 portbench/control.py --workload canterbury.roundtrip \\
        --seeds 11 12 13 --seconds 5 [--program]

The control is the reference with the guarantee that the cell's mix names
(``control``) broken (``codecs.ControlCodec``); it has to come out not
correct on every seed. With ``--program`` each seed also runs the program
itself, in the same process. Prints one JSON line a run: the workload,
the seed, which side ran, ``correct`` and every check's reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import codecs, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    mix = harness.resolve(harness.load_spec(), args.workload)["mix"]
    sides = [("control", codecs.ControlCodec(mix["control"]))]
    if args.program:
        sides.append(("program", None))
    for seed in args.seeds:
        for side, codec in sides:
            t0 = time.time()
            res, _checks = harness.run(args.workload, seed, args.seconds, False, t0,
                                       device=args.device, codec=codec, warm=codec is None)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "control": mix["control"], "correct": res["correct"],
                              "attempted": res["attempted"], "checks": res["checks"],
                              "checked": res["checked"], "seconds": time.time() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
