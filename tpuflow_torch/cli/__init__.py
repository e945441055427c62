"""Command-line entry points of the port:

    python -m tpuflow_torch.cli.train <case> [key=value ...] [--device cuda|cpu]

The positional argument selects a case preset (``configs/cases``);
trailing ``key=value`` pairs override any config field by dotted path
(``model.n_scales=2 train.epochs=5``). ``--device`` defaults to
``cuda`` and raises where there is no GPU; name ``cpu`` to run there.
"""

from __future__ import annotations

import argparse
import sys

from tpuflow_torch.configs.config import CaseConfig, case_names, load_case, parse_cli_overrides


def parse_args(argv: list[str] | None = None, prog: str = "tpuflow_torch") -> tuple[CaseConfig, str]:
    """(config, device) from ``<case> [key=value ...] [--device D]``."""
    ap = argparse.ArgumentParser(
        prog=prog, description=__doc__.split("\n\n")[0],
        epilog="known cases: " + ", ".join(case_names()),
    )
    ap.add_argument("case", help="case preset name or YAML path")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_intermixed_args(sys.argv[1:] if argv is None else argv)
    return load_case(args.case, parse_cli_overrides(args.overrides)), args.device
