"""Smoke: run the port's `examples.fleet_sim` and fail if a
DeprecationWarning comes from a `repro_torch` frame (port of
`scripts/smoke_fleet_api.py`).

    python -m repro_torch.scripts.smoke_fleet_api --device cpu

The `serving.planner` shims still warn for outside callers, but every path
inside the package (the fleet engine, the executor, the runtime, the
examples) is on `repro_torch.api` directly; a warning raised from a file of
the package means one went back to a shim.
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings
from typing import Optional, Sequence

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .._device import resolve_device
    from ..examples import fleet_sim

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = ["--device", resolve_device(args.device).type]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        fleet_sim.main(["--devices", "16", "--periods", "4",
                        "--servers", "1", *dev])
        fleet_sim.main(["--devices", "8", "--periods", "2",
                        "--policy", "dual", *dev])
        fleet_sim.main(["--devices", "8", "--periods", "3", "--rollout",
                        *dev])
    internal = [w for w in caught
                if issubclass(w.category, DeprecationWarning)
                and os.path.abspath(str(w.filename)).startswith(
                    PACKAGE + os.sep)]
    if internal:
        print("\nFAIL: DeprecationWarning raised from repro_torch call "
              "sites:", file=sys.stderr)
        for w in internal:
            print(f"  {w.filename}:{w.lineno}: {w.message}",
                  file=sys.stderr)
        return 1
    print(f"\n[smoke] fleet_sim ran clean on repro_torch.api "
          f"({len(caught)} outside warnings ignored)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
