"""Command-line entry points of the port:

    python -m tpuflow_torch.cli.train <case> [key=value ...] [--device cuda|cpu]
    python -m tpuflow_torch.cli.rollout <case> [key=value ...] [--device cuda|cpu]
    python -m tpuflow_torch.cli.evaluate <case> [key=value ...] [--device cuda|cpu]

The positional argument selects a case preset (``configs/cases``);
trailing ``key=value`` pairs override any config field by dotted path
(``model.n_scales=2 train.epochs=5``). ``--device`` defaults to
``cuda`` and raises where there is no GPU; name ``cpu`` to run there.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
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


def pop_tool_args(argv: list[str], defaults: dict[str, str]) -> dict[str, str]:
    """Remove a tool's own ``name=value`` arguments (the names of
    ``defaults``) from ``argv``, in place, before the rest go to
    :func:`parse_args` as config overrides; returns every name's value, the
    default where ``argv`` holds none."""
    out = dict(defaults)
    for a in list(argv):
        name, sep, value = a.partition("=")
        if sep and name in defaults:
            out[name] = value
            argv.remove(a)
    return out


def require_matplotlib(prog: str) -> None:
    """Stop with a message when matplotlib, which draws the figures of the
    rollout and evaluation CLIs, is not installed."""
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit(
            f"{prog}: matplotlib is not installed; it draws this command's figures. "
            "Install it, or call the compute half without figures "
            "(tpuflow_torch.cli.rollout.rollout / tpuflow_torch.cli.evaluate.evaluate / "
            "tpuflow_torch.tools.sweep_temperature.sweep)."
        )


def as_console_script(main_fn):
    """Wrap a ``main()`` that returns data (metrics, rows, a path) into a
    ``[project.scripts]`` target: a console script exits with its target's
    return value, so a returned dict would turn a successful run into exit
    code 1."""

    @functools.wraps(main_fn)
    def cli() -> int:
        main_fn()
        return 0

    cli.__tpuflow_console_script__ = True
    return cli
